"""Offline usage-ledger analyzer: ``python -m
chainermn_tpu_torch.observability.usage report <path> [--json]``.

Renders a ``cmn-usage-1`` ledger export (:meth:`~chainermn_tpu_torch.
observability.ledger.CostLedger.export` / ``CostLedger.dump``) as the
operator's cost view:

* the per-tenant cost table — requests, terminal mix, tokens generated,
  prefill tokens computed vs prefix tokens saved, decode iterations,
  KV block-seconds (with each tenant's share of the fleet total),
  migration bytes, queue wait;
* top consumers by block-seconds (the quota-relevant scarce resource);
* cost of retries — what the fleet spent on requests that killed a
  replica (or were harvested from one) before terminating;
* prefix-cache savings — tokens served from cache vs computed;
* the conservation verdict the ledger carried at export time.

Same contract as ``incident report``: stdin never read, ``--json``
emits the machine-readable report, exit 0 on a well-formed artifact,
2 on a malformed one.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

from chainermn_tpu_torch.observability.ledger import DIMENSIONS, USAGE_SCHEMA


def _aggregate_records(records) -> dict:
    tenants: dict = {}
    for rec in records:
        t = tenants.setdefault(rec.get("tenant", "default"), {
            **{dim: 0 for dim in DIMENSIONS},
            "requests": 0, "by_status": {},
        })
        t["requests"] += 1
        status = rec.get("status")
        if status is not None:
            t["by_status"][status] = t["by_status"].get(status, 0) + 1
        for dim in DIMENSIONS:
            t[dim] += int(rec.get(dim, 0))
    return tenants


def load_report(path: str) -> dict:
    """Parse + analyze one ledger export.  Raises ``ValueError`` on a
    malformed or wrong-schema artifact (the CLI maps it to exit 2)."""
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("schema") != USAGE_SCHEMA:
        raise ValueError(
            f"{path}: not a {USAGE_SCHEMA} ledger export "
            f"(schema={data.get('schema') if isinstance(data, dict) else type(data).__name__!r})"
        )
    records = data.get("records") or []
    # Aggregate from the records when present (the analyzer must agree
    # with the ledger's own books); a records-free export (pre-trimmed
    # artifact) falls back to its embedded per-tenant table.
    tenants = (
        _aggregate_records(records) if records
        else (data.get("tenants") or {})
    )
    totals = {dim: 0 for dim in DIMENSIONS}
    for t in tenants.values():
        for dim in DIMENSIONS:
            totals[dim] += int(t.get(dim, 0))
    fleet_block_us = totals["block_us"] or 1
    table = {}
    for name in sorted(tenants):
        t = tenants[name]
        table[name] = {
            "requests": t.get("requests", 0),
            "by_status": t.get("by_status", {}),
            "tokens": t["tokens"],
            "prefill_tokens": t["prefill_tokens"],
            "prefix_hit_tokens": t["prefix_hit_tokens"],
            "decode_iterations": t["decode_iterations"],
            "block_seconds": round(t["block_us"] / 1e6, 6),
            "block_second_share": round(
                t["block_us"] / fleet_block_us, 6
            ),
            "migration_bytes": t["migration_bytes"],
            "cow_copies": t["cow_copies"],
            "evictions": t["evictions"],
            "retries": t["retries"],
            "queue_wait_s": round(t["queue_wait_us"] / 1e6, 6),
        }
    top = sorted(
        table.items(),
        key=lambda kv: (-kv[1]["block_seconds"], kv[0]),
    )
    # Cost of retries: everything spent on requests that were harvested
    # from >= 1 dead replica — their WHOLE cost, not just the repeated
    # part (the operator's question is "what did the retry storm cost").
    retried = [r for r in records if int(r.get("retries", 0)) > 0]
    retry_cost = {
        "requests": len(retried),
        "retries": sum(int(r["retries"]) for r in retried),
        "tokens": sum(int(r.get("tokens", 0)) for r in retried),
        "prefill_tokens": sum(
            int(r.get("prefill_tokens", 0)) for r in retried
        ),
        "block_seconds": round(
            sum(int(r.get("block_us", 0)) for r in retried) / 1e6, 6
        ),
    } if records else {
        "requests": None,
        "retries": sum(t["retries"] for t in table.values()),
    }
    saved = totals["prefix_hit_tokens"]
    computed = totals["prefill_tokens"]
    report = {
        "schema": USAGE_SCHEMA,
        "path": path,
        "requests": (
            len(records) if records
            else sum(t["requests"] for t in table.values())
        ),
        "tenants": table,
        "top": [
            {"tenant": name, **{
                k: v for k, v in row.items()
                if k in ("block_seconds", "block_second_share",
                         "tokens", "requests")
            }}
            for name, row in top[:10]
        ],
        "totals": {
            **totals,
            "block_seconds": round(totals["block_us"] / 1e6, 6),
            "queue_wait_s": round(totals["queue_wait_us"] / 1e6, 6),
        },
        "retry_cost": retry_cost,
        "prefix_savings": {
            "hit_tokens": saved,
            "computed_tokens": computed,
            "saved_fraction": round(
                saved / max(saved + computed, 1), 6
            ),
        },
    }
    if data.get("conservation") is not None:
        report["conservation"] = data["conservation"]
    return report


def _render(report: dict) -> None:
    print(f"usage ledger  {report['path']}  "
          f"requests={report['requests']}  "
          f"tenants={len(report['tenants'])}")
    cons = report.get("conservation")
    if cons is not None:
        print(f"conservation: "
              f"{'holds' if cons.get('holds') else 'VIOLATED'} "
              f"(unfinalized={len(cons.get('unfinalized', []))}, "
              f"double={len(cons.get('double_finalized', []))})")
    print(f"{'tenant':<14} {'reqs':>5} {'tokens':>8} {'prefill':>8} "
          f"{'saved':>7} {'iters':>7} {'blk-sec':>10} {'share':>7} "
          f"{'retries':>7}")
    for name, t in sorted(report["tenants"].items()):
        print(f"{name:<14} {t['requests']:>5} {t['tokens']:>8} "
              f"{t['prefill_tokens']:>8} {t['prefix_hit_tokens']:>7} "
              f"{t['decode_iterations']:>7} {t['block_seconds']:>10.4f} "
              f"{t['block_second_share']:>6.1%} {t['retries']:>7}")
    print("top consumers (by KV block-seconds):")
    for row in report["top"]:
        print(f"  {row['tenant']:<14} {row['block_seconds']:>10.4f} "
              f"blk-sec  ({row['block_second_share']:.1%} of fleet, "
              f"{row['tokens']} tokens)")
    rc = report["retry_cost"]
    if rc.get("requests") is not None:
        print(f"cost of retries: {rc['requests']} request(s), "
              f"{rc['retries']} retries — {rc['tokens']} tokens, "
              f"{rc['prefill_tokens']} prefill tokens, "
              f"{rc['block_seconds']:.4f} blk-sec spent on them")
    ps = report["prefix_savings"]
    print(f"prefix-cache savings: {ps['hit_tokens']} tokens served "
          f"from cache vs {ps['computed_tokens']} computed "
          f"({ps['saved_fraction']:.1%} of prefill demand saved)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.observability.usage",
        description="Offline analyzer for usage-ledger exports "
                    "(per-tenant cost attribution).",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    rep = sub.add_parser(
        "report", help="render one ledger export (per-tenant cost "
                       "table, top consumers, cost of retries, "
                       "prefix-cache savings)",
    )
    rep.add_argument("path", help="a cmn-usage-1 ledger export "
                                  "(CostLedger.dump output)")
    rep.add_argument("--json", action="store_true",
                     help="emit the machine-readable report instead "
                          "of the rendering")
    args = ap.parse_args(argv)
    try:
        report = load_report(args.path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report))
        return 0
    _render(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
