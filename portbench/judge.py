"""The comparisons that decide ``correct``.

Training: each checked step's loss, the norm of the first gradient as
the optimizer got it, and the norm of the weights' change over the
checked steps, each leaf of the program against the same leaf of the
plain reference.  A norm's gap is ``| |prog| - |ref| |`` over the larger
of the reference leaf's norm and the median leaf's; the number compared
is the worst leaf's.  Leaves whose reference gradient is under a
thousandth of the median leaf's (a key's bias under softmax) move by
round-off alone and are left out of the change.

Serving: over a sample of the requests the window finished, the widest
gap by which a served token's reference logit lies below the reference's
best at that position.

The median leaf's gap of each norm is read beside the worst leaf's: it
is steady from seed to seed where a few small leaves are noise.

Each number is held to its limit in ``limits/<workload>.json``; a number
with no limit there is reported and not held.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

#: the numbers a training cell's comparison reads.
TRAIN_NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "delta_gap",
                 "grad_gap_median", "delta_gap_median")

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the change.
NOUGHT = 1e-3


def _norm_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> tuple:
    """The worst leaf's gap, that leaf, and the median leaf's gap."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}
    at = max(leaves, key=lambda k: gaps[k])
    return gaps[at], at, statistics.median(gaps.values())


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"losses": [...], "grad": {leaf: norm},
    "delta": {leaf: norm}}``.  The three numbers, and where each was
    worst."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    leaves = sorted(ref["grad"])
    grad, grad_at, grad_med = _norm_gap(prog["grad"], ref["grad"], leaves)
    med = statistics.median(ref["grad"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad"][k] >= NOUGHT * med]
    delta, delta_at, delta_med = _norm_gap(prog["delta"], ref["delta"],
                                           moved)
    return {
        "loss_gap": max(losses),
        "loss_gap_first": losses[0],
        "grad_gap": grad,
        "delta_gap": delta,
        "grad_gap_median": grad_med,
        "delta_gap_median": delta_med,
        "where": {"loss_gap": losses, "grad_gap": grad_at,
                  "delta_gap": delta_at,
                  "left_out": sorted(set(leaves) - set(moved))},
    }


def logit_gap(logits, tokens) -> float:
    """The widest gap by which ``tokens`` (one per row of ``logits``)
    lie below each row's best."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, tokens[:, None])[:, 0]
    return float((best - got).max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> tuple:
    """``(correct, checks)``: each number beside its limit, and whether
    every number is within.  A number the limits file names with the
    limit null is reported and not held; one it does not name fails, so
    a cell without limits is never correct."""
    checks, ok = {}, True
    for k, v in numbers.items():
        lim: Optional[float] = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if k not in limits or (lim is not None and not v <= lim):
            ok = False
    return ok, checks
