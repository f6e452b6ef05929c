"""Observability of the port — the serving planes, as in the JAX package.

* :mod:`~chainermn_tpu_torch.observability.metrics` — per-rank registry of
  counters / gauges / histograms (fixed bucket edges, so a merge of two
  snapshots is exact) and a ring of stamped snapshots.
* :mod:`~chainermn_tpu_torch.observability.tracing` — spans of host-side
  ops in a bounded ring, the serving request timeline with its Chrome
  trace export, and ``torch.profiler.record_function`` annotations.
* :mod:`~chainermn_tpu_torch.observability.slo` — streaming SLO monitor:
  TTFT / queue-wait / per-token latency, rolling p50/p95, p95 drift.
* :mod:`~chainermn_tpu_torch.observability.flight` — flight recorder:
  per-rank JSONL black box on crash, incident and ``SIGUSR1``.
* :mod:`~chainermn_tpu_torch.observability.memory` — device watermarks
  (``torch.cuda.memory_stats``), the KV-pool timeline and the drain
  leak check (``mem.*``).
* :mod:`~chainermn_tpu_torch.observability.ledger` and
  :mod:`~chainermn_tpu_torch.observability.usage` — per-request cost
  attribution (schema ``cmn-usage-1``) and its offline report.
* :mod:`~chainermn_tpu_torch.observability.device` — the capture watch
  (captures and signatures of the engine's programs, blame diffs,
  budgets: ``compile.*``) and the decode step's MFU/roofline gauges
  (``device.*``).
* :mod:`~chainermn_tpu_torch.observability.incident` — watch rules over
  the registry and the debug bundles they capture.
* :mod:`~chainermn_tpu_torch.observability.aggregate` — the rank-0
  ``MetricsAggregator`` (the trainer's ``MetricsReport`` feeds it over
  the communicator's ``gather_obj``), strict-JSON sanitizing and
  Prometheus rendering.

* :mod:`~chainermn_tpu_torch.observability.fleet` — the fleet plane:
  NTP-style clock offsets between ranks over the object plane
  (``FleetClock``), the collective ``export_fleet_trace`` of every
  rank's span ring into one merged Perfetto trace, cross-rank collective
  skew and gated straggler attribution (``fleet.*``);
  :mod:`~chainermn_tpu_torch.observability.analyze` is its offline
  critical-path analyzer.
* :mod:`~chainermn_tpu_torch.observability.perf` — the offline
  perf-regression sentinel over ``result/*.json`` histories, series
  grouped by platform and device kind.

``CMN_OBS=0`` is the master off-switch: publishers that find it off at
construction hold no-op instruments and the serving scheduler builds no
plane.
"""

from __future__ import annotations

import os
from typing import Optional

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


from chainermn_tpu_torch.observability.metrics import (  # noqa: E402
    DEFAULT_MS_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NoopInstrument,
    histogram_quantile,
    merge_snapshots,
    registry,
)
from chainermn_tpu_torch.observability.tracing import (  # noqa: E402
    LifecycleEvent,
    RequestTimeline,
    Span,
    SpanRing,
    Tracer,
    chrome_trace_events,
    step_annotation,
    tracer,
    write_chrome_trace,
)
from chainermn_tpu_torch.observability.slo import (  # noqa: E402
    SLOMonitor,
    rolling_quantile,
)
from chainermn_tpu_torch.observability.flight import (  # noqa: E402
    FLIGHT_SCHEMA,
    FlightRecorder,
    recorder,
    register_provider,
    snapshot_on_crash,
)
from chainermn_tpu_torch.observability.aggregate import (  # noqa: E402
    MetricsAggregator,
    render_prometheus,
    sanitize_json,
)
from chainermn_tpu_torch.observability.memory import (  # noqa: E402
    MemoryMonitor,
    device_memory_stats,
    kv_pool_sample,
)
from chainermn_tpu_torch.observability.device import (  # noqa: E402
    PEAK_BF16_FLOPS,
    CompileWatch,
    WatchedProgram,
    attention_core_flops,
    mfu_pct,
    roofline,
    signature_diff,
    watch,
)
from chainermn_tpu_torch.observability.fleet import (  # noqa: E402
    ClockOffset,
    FleetClock,
    attribute_straggler,
    collective_occurrences,
    export_fleet_trace,
    merge_fleet_trace,
)
from chainermn_tpu_torch.observability.ledger import (  # noqa: E402
    USAGE_SCHEMA,
    CostLedger,
    UsageRecord,
    ledger_enabled,
)

__all__ = [
    "enabled",
    "set_enabled",
    "DEFAULT_MS_EDGES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NoopInstrument",
    "histogram_quantile",
    "merge_snapshots",
    "registry",
    "LifecycleEvent",
    "RequestTimeline",
    "Span",
    "SpanRing",
    "Tracer",
    "tracer",
    "chrome_trace_events",
    "step_annotation",
    "write_chrome_trace",
    "SLOMonitor",
    "rolling_quantile",
    "FLIGHT_SCHEMA",
    "FlightRecorder",
    "recorder",
    "register_provider",
    "snapshot_on_crash",
    "MetricsAggregator",
    "render_prometheus",
    "sanitize_json",
    "MemoryMonitor",
    "device_memory_stats",
    "kv_pool_sample",
    "PEAK_BF16_FLOPS",
    "CompileWatch",
    "WatchedProgram",
    "attention_core_flops",
    "mfu_pct",
    "roofline",
    "signature_diff",
    "watch",
    "ClockOffset",
    "FleetClock",
    "attribute_straggler",
    "collective_occurrences",
    "export_fleet_trace",
    "merge_fleet_trace",
    "USAGE_SCHEMA",
    "CostLedger",
    "UsageRecord",
    "ledger_enabled",
]
