"""Fleet plane, merge half: one Perfetto trace from several span dumps,
with the cross-rank skew of paired collectives and straggler
attribution.

The JAX package's fleet plane also estimates clock offsets between
processes (``FleetClock``) and gathers every rank's dump over the host
object plane; the port keeps only the merge, which the serving
:class:`~chainermn_tpu_torch.serving.router.Router` needs for
:meth:`~chainermn_tpu_torch.serving.router.Router.export_fleet_trace`:
its replicas share one process and one monotonic clock, so each
replica's span ring is one "rank" (pid) and every offset is zero.

* :func:`collective_occurrences` pairs collective spans across dumps by
  ``(op, seq)`` and measures each one's arrival spread;
  :func:`finalize_occurrences` is the one definition of that record.
* :func:`attribute_straggler` charges each spread past
  ``CMN_FLEET_MIN_SKEW_MS`` to its last arriver and names a rank only
  when it owns at least half the stall.
* :func:`chrome_fleet_events` / :func:`merge_fleet_trace` /
  :func:`write_fleet_trace` build and write the Chrome trace-event JSON
  (one process per rank), publishing ``fleet.collective_skew_ms`` and
  ``fleet.straggler_rank``.

``offsets`` maps a rank to any object with an ``offset_s`` attribute
(the peer's monotonic clock minus rank 0's, seconds) and a ``to_dict``
method; ``None`` means every dump shares one clock.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from chainermn_tpu_torch.observability import metrics as _metrics

#: Host-plane composites whose cross-rank skew is worth attributing.
COLLECTIVE_OPS = (
    "barrier", "bcast_obj", "gather_obj", "allgather_obj", "allreduce_obj",
)

#: Below this arrival spread a collective is considered aligned
#: (``CMN_FLEET_MIN_SKEW_MS``).
DEFAULT_MIN_SKEW_MS = 1.0
#: A rank is named straggler only when it owns at least this share of
#: the total attributed stall.
DEFAULT_MIN_SHARE = 0.5


def _corrected(span: dict, offset_s: float) -> float:
    """A span's start on the rank-0 monotonic base."""
    return float(span["t_mono"]) - offset_s


def collective_occurrences(
    dumps: Sequence[dict],
    offsets_s: Optional[Dict[int, float]] = None,
    ops: Sequence[str] = COLLECTIVE_OPS,
) -> List[dict]:
    """Pair collective spans across rank dumps by ``(op, seq)`` and
    measure per-occurrence arrival spread.

    Returns one record per collective seen on ≥ 2 ranks, sorted by
    median corrected arrival:  ``{"op", "seq", "arrival_s": {rank: t},
    "end_s": {rank: t}, "skew_ms", "last_rank", "first_rank"}`` —
    ``skew_ms`` is the arrival spread (max − min) and ``last_rank`` the
    rank everyone else waited for.  Times are on the rank-0 monotonic
    base (``offsets_s``: peer clock minus rank 0's; missing ranks default
    to 0 offset — fine when all dumps share a host clock, e.g. tests).
    """
    offsets_s = offsets_s or {}
    occ: Dict[tuple, dict] = {}
    for dump in dumps:
        rank = int(dump["rank"])
        off = float(offsets_s.get(rank, 0.0))
        for span in dump.get("spans", ()):
            if span.get("op") not in ops or span.get("seq") is None:
                continue
            key = (span["op"], int(span["seq"]))
            rec = occ.setdefault(
                key, {"op": span["op"], "seq": int(span["seq"]),
                      "arrival_s": {}, "end_s": {}}
            )
            t = _corrected(span, off)
            rec["arrival_s"][rank] = t
            rec["end_s"][rank] = t + float(span.get("ms", 0.0)) / 1e3
    return finalize_occurrences(occ.values())


def finalize_occurrences(records) -> List[dict]:
    """Finish raw occurrence records (``{"op", "seq", "arrival_s",
    "end_s"}``) into the shared occurrence contract: drop records seen
    on < 2 ranks, stamp ``skew_ms``/``last_rank``/``first_rank``, and
    order by median arrival.  THE one definition — the online merge and
    the offline analyzer's trace reconstruction both finish through
    here, so the skew/attribution semantics cannot drift between
    them."""
    out = []
    for rec in records:
        arr = rec["arrival_s"]
        if len(arr) < 2:
            continue
        last = max(arr, key=arr.get)
        first = min(arr, key=arr.get)
        rec["skew_ms"] = (arr[last] - arr[first]) * 1e3
        rec["last_rank"] = last
        rec["first_rank"] = first
        out.append(rec)
    out.sort(key=lambda r: sorted(r["arrival_s"].values())
             [len(r["arrival_s"]) // 2])
    return out


def attribute_straggler(
    occurrences: Sequence[dict],
    min_skew_ms: Optional[float] = None,
    min_share: float = DEFAULT_MIN_SHARE,
) -> dict:
    """Causal straggler attribution over a run's collective occurrences.

    Each occurrence's stall (its arrival spread) is charged to its
    last-arriving rank, but only when the spread clears ``min_skew_ms``
    (``CMN_FLEET_MIN_SKEW_MS``, default 1 ms) — sub-floor spreads are
    scheduling noise.  A rank is *named* (``straggler_rank``) only when
    its attributed stall owns ≥ ``min_share`` of the total; otherwise
    ``straggler_rank`` is None and the per-rank ledger still tells the
    contention story.  Gating both ways is what lets an unfaulted run
    assert "no straggler" instead of electing whoever lost the most
    coin flips.
    """
    if min_skew_ms is None:
        min_skew_ms = float(
            os.environ.get("CMN_FLEET_MIN_SKEW_MS", str(DEFAULT_MIN_SKEW_MS))
        )
    stall_ms: Dict[int, float] = {}
    charged = 0
    for rec in occurrences:
        if rec["skew_ms"] < min_skew_ms:
            continue
        charged += 1
        stall_ms[rec["last_rank"]] = (
            stall_ms.get(rec["last_rank"], 0.0) + rec["skew_ms"]
        )
    total = sum(stall_ms.values())
    straggler = None
    if total > 0:
        worst = max(stall_ms, key=stall_ms.get)
        if stall_ms[worst] / total >= min_share:
            straggler = worst
    return {
        "straggler_rank": straggler,
        "stall_ms_by_rank": {str(r): round(v, 3)
                             for r, v in sorted(stall_ms.items())},
        "charged_collectives": charged,
        "total_collectives": len(occurrences),
        "total_stall_ms": round(total, 3),
        "min_skew_ms": min_skew_ms,
        "min_share": min_share,
    }


def chrome_fleet_events(
    dumps: Sequence[dict],
    offsets_s: Optional[Dict[int, float]] = None,
    occurrences: Optional[Sequence[dict]] = None,
) -> List[dict]:
    """Chrome trace-event objects for a fleet of span dumps: one
    *process* per rank (``pid`` = rank, named and sorted), every span a
    complete ``X`` slice at its offset-corrected time (collectives under
    cat ``collective``, everything else ``host_op``), plus a
    ``straggler`` instant on the last-arriving rank's track for every
    occurrence whose skew cleared the attribution floor.  Timestamps are
    microseconds from the earliest corrected span, so the trace opens at
    ~0 regardless of how long the processes were up."""
    offsets_s = offsets_s or {}
    t0 = None
    for dump in dumps:
        off = float(offsets_s.get(int(dump["rank"]), 0.0))
        for span in dump.get("spans", ()):
            t = _corrected(span, off)
            t0 = t if t0 is None else min(t0, t)
    if t0 is None:
        t0 = 0.0
    out: List[dict] = []
    for dump in sorted(dumps, key=lambda d: int(d["rank"])):
        rank = int(dump["rank"])
        off = float(offsets_s.get(rank, 0.0))
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"cmn rank {rank}"}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                    "args": {"sort_index": rank}})
        for span in dump.get("spans", ()):
            args = {k: span[k] for k in
                    ("peer", "nbytes", "detail", "seq") if k in span}
            if not span.get("ok", True):
                args["error"] = span.get("error")
            cat = ("collective" if span.get("op") in COLLECTIVE_OPS
                   else "host_op")
            out.append({
                "name": span["op"], "cat": cat, "ph": "X",
                "pid": rank, "tid": 0,
                "ts": round((_corrected(span, off) - t0) * 1e6, 3),
                "dur": round(float(span.get("ms", 0.0)) * 1e3, 3),
                "args": args,
            })
    min_skew_ms = float(
        os.environ.get("CMN_FLEET_MIN_SKEW_MS", str(DEFAULT_MIN_SKEW_MS))
    )
    for rec in occurrences or ():
        if rec["skew_ms"] < min_skew_ms:
            continue
        out.append({
            "name": "straggler", "cat": "fleet", "ph": "i", "s": "p",
            "pid": rec["last_rank"], "tid": 0,
            "ts": round((rec["arrival_s"][rec["last_rank"]] - t0) * 1e6, 3),
            "args": {"op": rec["op"], "seq": rec["seq"],
                     "skew_ms": round(rec["skew_ms"], 3)},
        })
    return out


def merge_fleet_trace(
    dumps: Sequence[dict],
    offsets: Optional[Dict[int, object]] = None,
    registry=None,
) -> dict:
    """The rank-0 merge, comm-free (testable on synthetic dumps): skew
    analysis + straggler attribution + the Chrome trace payload, and the
    ``fleet.*`` metrics published (one ``fleet.collective_skew_ms``
    observation per paired collective; ``fleet.straggler_rank`` −1 when
    no rank clears the attribution gate).  Returns
    ``{"payload", "summary"}`` — write ``payload`` with
    :func:`write_fleet_trace`/``json.dump``."""
    import chainermn_tpu_torch.observability as _obs

    offsets_s = (
        {r: o.offset_s for r, o in offsets.items()} if offsets else {}
    )
    occurrences = collective_occurrences(dumps, offsets_s)
    verdict = attribute_straggler(occurrences)
    summary = {
        "nranks": len(dumps),
        "spans": sum(len(d.get("spans", ())) for d in dumps),
        "max_skew_ms": round(
            max((r["skew_ms"] for r in occurrences), default=0.0), 3
        ),
        "clock_offsets": (
            {str(r): o.to_dict() for r, o in offsets.items()}
            if offsets else None
        ),
        **verdict,
    }
    payload = {
        "traceEvents": chrome_fleet_events(dumps, offsets_s, occurrences),
        "displayTimeUnit": "ms",
        # Extra top-level keys are legal Chrome-trace metadata: the
        # offline analyzer reads this block, Perfetto ignores it.
        "cmn_fleet": {
            **summary,
            "collectives": [
                {"op": r["op"], "seq": r["seq"],
                 "skew_ms": round(r["skew_ms"], 3),
                 "last_rank": r["last_rank"],
                 "arrival_s": {str(k): round(v, 6)
                               for k, v in r["arrival_s"].items()},
                 "end_s": {str(k): round(v, 6)
                           for k, v in r["end_s"].items()}}
                for r in occurrences
            ],
        },
    }
    if registry is not None or _obs.enabled():
        reg = registry if registry is not None else _metrics.registry()
        hist = reg.histogram("fleet.collective_skew_ms",
                             _metrics.DEFAULT_MS_EDGES)
        for rec in occurrences:
            hist.observe(rec["skew_ms"])
        reg.gauge("fleet.straggler_rank").set(
            -1 if verdict["straggler_rank"] is None
            else verdict["straggler_rank"]
        )
        reg.gauge("fleet.straggler_stall_ms").set(
            verdict["total_stall_ms"]
        )
    return {"payload": payload, "summary": summary}


def write_fleet_trace(path: str, payload: dict) -> str:
    from chainermn_tpu_torch.observability import aggregate as _oagg

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_oagg.sanitize_json(payload), f)
    return path
