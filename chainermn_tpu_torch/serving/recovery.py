"""Serving recovery knobs.  So far only the fleet-wide default deadline,
which the scheduler reads; the fleet health state machine and the chaos
harness come with the router."""

from __future__ import annotations

from typing import Optional

from chainermn_tpu_torch.observability.metrics import _env_float


def deadline_ms_from_env() -> Optional[float]:
    """``CMN_SERVE_DEADLINE_MS`` — fleet-wide default per-request deadline
    for requests that carry none of their own (unset or ``0`` = none)."""
    v = _env_float("CMN_SERVE_DEADLINE_MS", 0.0)
    return v if v > 0 else None
