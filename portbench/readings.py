"""Arithmetic the per-layer metric readers share.  Each reader in
``metrics/`` picks the runs it reads by their kind and family, and
returns None for any other: a metric with nothing to read is left out
of the result line."""

from __future__ import annotations

from typing import Optional

from portbench.roofline import PEAK_OPS
from portbench.trace import kernel_seconds


def of(rec: dict, kind: str, family: Optional[str] = None) -> bool:
    return rec.get("kind") == kind and (family is None
                                        or rec.get("family") == family)


def mfu_pct(rec: dict) -> float:
    """Model FLOPs of the window over its seconds, the card's bfloat16
    peak and the chips, in percent."""
    return 100.0 * rec["model_flops"] / rec["window_s"] / (
        PEAK_OPS["bfloat16"] * rec["chips"])


def idle_pct(rec: dict) -> Optional[float]:
    """The share of the traced stretch in which no operation ran on the
    device, in percent: the stretch that a profiler of the device alone
    recorded, so that the host runs at its untraced pace."""
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(rec: dict, bound_key: str, symbols) -> Optional[float]:
    """The traced stretch's least seconds for a kernel's work
    (``rec[bound_key]``) over the device seconds of the kernels whose
    names hold any of ``symbols``, in percent."""
    tr = rec.get("trace")
    if tr is None or bound_key not in rec:
        return None
    secs = sum(kernel_seconds(tr, s)[0] for s in symbols)
    if secs <= 0:
        return None
    return 100.0 * rec[bound_key] / secs
