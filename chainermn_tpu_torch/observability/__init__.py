"""Observability of the port: so far the metrics registry the serving
scheduler publishes into.

``CMN_OBS=0`` is the master off-switch, as in the JAX package: publishers
that find it off at construction hold no-op instruments instead of the
process registry's.  The request timeline, SLO monitor, memory, incident,
ledger and device planes are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

from chainermn_tpu_torch.observability.metrics import (
    DEFAULT_MS_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NoopInstrument,
    registry,
)

_enabled_override: Optional[bool] = None


def enabled() -> bool:
    """Default-on master switch: ``CMN_OBS=0`` turns every publisher into
    a no-op.  Publishers latch it at construction."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("CMN_OBS", "1") != "0"


def set_enabled(value: Optional[bool]) -> None:
    """Force observability on/off in-process (``None`` = follow the
    env)."""
    global _enabled_override
    _enabled_override = value


__all__ = [
    "DEFAULT_MS_EDGES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NoopInstrument",
    "enabled",
    "registry",
    "set_enabled",
]
