"""Offline critical-path analyzer for merged fleet traces, the port's
``chainermn_tpu/observability/analyze.py``.

    python -m chainermn_tpu_torch.observability.analyze trace.merged.json

Input: the Chrome trace :func:`~chainermn_tpu_torch.observability.fleet.
export_fleet_trace` writes (its ``cmn_fleet`` metadata block when
present, else reconstructed from the ``traceEvents`` themselves — any
conforming trace with ``cat: "collective"`` slices carrying per-rank
``pid`` and ``args.seq`` works).

A host-plane "step" is the interval between consecutive collectives: a
collective completes only when its LAST rank arrives, so each step is
*bounded* by exactly one rank — the one whose phase (work since its
previous collective) ended last.  That is causal attribution, not a
statistic: heartbeat statistics can say "rank 2's step times are slow";
this says "step 17 waited 25 ms *for rank 2's compute phase*".

Per step the report carries which collective, the bounding rank, that
rank's phase length, and the arrival spread everyone else absorbed as
wait; the summary folds the per-rank ledger (steps bounded, stall
attributed) and names a straggler under the same gated rule the online
exporter uses (:func:`~chainermn_tpu_torch.observability.fleet.
attribute_straggler` — no rank is named out of scheduling noise).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from chainermn_tpu_torch.observability import fleet as _fleet


def occurrences_from_trace(trace: dict) -> List[dict]:
    """Collective occurrence records (the :func:`~chainermn_tpu_torch.
    observability.fleet.collective_occurrences` shape) from a merged
    trace: the ``cmn_fleet.collectives`` metadata verbatim when present,
    else rebuilt from the ``traceEvents`` slices."""
    meta = trace.get("cmn_fleet") or {}
    if meta.get("collectives"):
        out = []
        for rec in meta["collectives"]:
            out.append({
                "op": rec["op"], "seq": rec["seq"],
                "skew_ms": float(rec["skew_ms"]),
                "last_rank": int(rec["last_rank"]),
                "arrival_s": {int(k): float(v)
                              for k, v in rec["arrival_s"].items()},
                "end_s": {int(k): float(v)
                          for k, v in rec.get("end_s", {}).items()},
            })
        return out
    occ: Dict[tuple, dict] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("cat") != "collective":
            continue
        seq = (ev.get("args") or {}).get("seq")
        if seq is None:
            continue
        key = (ev["name"], int(seq))
        rec = occ.setdefault(
            key, {"op": ev["name"], "seq": int(seq),
                  "arrival_s": {}, "end_s": {}}
        )
        rank = int(ev["pid"])
        t = float(ev["ts"]) / 1e6
        rec["arrival_s"][rank] = t
        rec["end_s"][rank] = t + float(ev.get("dur", 0.0)) / 1e6
    # Finish through the fleet module's ONE occurrence contract (skew,
    # last/first rank, median-arrival order) — reconstruction must not
    # fork the attribution semantics.
    return _fleet.finalize_occurrences(occ.values())


def critical_path(occurrences: Sequence[dict]) -> List[dict]:
    """Per-step critical path over ordered collective occurrences.

    Step ``k`` is bounded by occurrence ``k``'s last-arriving rank; its
    *phase* is the work that rank did since ITS end of occurrence
    ``k-1`` (for the first step, since the step's earliest arrival —
    there is no prior fence to measure from).  ``wait_ms`` is the
    arrival spread: what every other rank spent blocked.
    """
    steps = []
    prev_end: Dict[int, float] = {}
    for k, rec in enumerate(occurrences):
        arr = rec["arrival_s"]
        bound = rec["last_rank"]
        t0 = prev_end.get(bound)
        if t0 is None:
            t0 = min(arr.values())
        steps.append({
            "step": k,
            "op": rec["op"],
            "seq": rec["seq"],
            "bound_rank": bound,
            "bound_phase_ms": round(max(arr[bound] - t0, 0.0) * 1e3, 3),
            "wait_ms": round(rec["skew_ms"], 3),
        })
        for rank, t in rec.get("end_s", {}).items():
            prev_end[rank] = t
        # Ranks whose span end was evicted from their ring still advance
        # past their arrival — a stale fence would inflate later phases.
        for rank, t in arr.items():
            prev_end[rank] = max(prev_end.get(rank, t), t)
    return steps


def analyze(trace: dict,
            min_skew_ms: Optional[float] = None) -> dict:
    """The per-step critical path, the steps each rank bounded, and the
    gated straggler verdict of a merged trace."""
    occurrences = occurrences_from_trace(trace)
    steps = critical_path(occurrences)
    verdict = _fleet.attribute_straggler(
        occurrences, min_skew_ms=min_skew_ms
    )
    bounded: Dict[str, int] = {}
    for s in steps:
        bounded[str(s["bound_rank"])] = (
            bounded.get(str(s["bound_rank"]), 0) + 1
        )
    return {
        "steps": steps,
        "bounded_steps_by_rank": bounded,
        **verdict,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.observability.analyze",
        description="Critical-path / straggler report for a merged "
                    "fleet trace (fleet.export_fleet_trace output).",
    )
    ap.add_argument("trace", help="merged Chrome trace JSON path")
    ap.add_argument("--min-skew-ms", type=float, default=None,
                    help="attribution floor override "
                         "(default CMN_FLEET_MIN_SKEW_MS or 1.0)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report instead of "
                         "the table")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    report = analyze(trace, min_skew_ms=args.min_skew_ms)
    if args.json:
        print(json.dumps(report))
        return 0
    print(f"{'step':>4}  {'collective':<16} {'bound by':>8} "
          f"{'phase ms':>10} {'wait ms':>9}")
    for s in report["steps"]:
        print(f"{s['step']:>4}  {s['op']:<16} "
              f"rank {s['bound_rank']:>3} "
              f"{s['bound_phase_ms']:>10.3f} {s['wait_ms']:>9.3f}")
    print(f"\nsteps bounded by rank: {report['bounded_steps_by_rank']}")
    print(f"attributed stall ms by rank: {report['stall_ms_by_rank']} "
          f"({report['charged_collectives']}/"
          f"{report['total_collectives']} collectives above the "
          f"{report['min_skew_ms']} ms floor)")
    if report["straggler_rank"] is None:
        print("straggler: none (no rank clears the attribution gate)")
    else:
        print(f"straggler: rank {report['straggler_rank']} "
              f"(owns >= {report['min_share']:.0%} of "
              f"{report['total_stall_ms']} ms total stall)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
