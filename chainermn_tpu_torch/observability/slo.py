"""Streaming SLO monitor — the serving plane's latency health signal.

A trustworthy, *cheap* answer to "is p95 drifting?", which the policy
plane's prefill cap and the incident plane's drift rule consume.  This
module tracks the three request-visible latency streams —

* ``ttft`` — time to first token (arrival → first sampled token),
* ``queue_wait`` — arrival → first admission into a slot,
* ``token`` — per-token decode latency (one clean decode iteration; the
  scheduler excludes prefill-contaminated iterations, which book to
  ``serve.mixed_ms``),

each in TWO complementary forms:

1. **Fixed-edge histograms** (``serve.slo.<stream>_ms`` on the registry's
   ``DEFAULT_MS_EDGES``) — the durable, *exactly mergeable* record: two
   ranks' histograms of one stream merge by adding bucket counts.
2. **Rolling windows** of raw values (last ``window`` observations,
   host-side deques) — exact *recent* p50/p95, the drift detector's
   input.  Histograms answer "what happened this run"; windows answer
   "what is happening right now".

The **drift detector** compares the rolling p95 against a reference:
an absolute target when configured (``CMN_SLO_<STREAM>_P95_MS``), else a
baseline auto-calibrated from the first ``min_samples`` observations.
When p95 leaves the envelope ``ref * (1 + tolerance)`` the per-stream
``serve.slo.<stream>.breaches`` counter increments, and the
``serve.slo.p95_drift`` gauge always carries the worst relative drift
across streams — the chunked-prefill-budgeting signal the policy plane
consumes.

Cost discipline: ``observe`` is a histogram observe plus a deque append;
quantiles are computed only in :meth:`check` (the scheduler calls it
every ``check_every`` iterations, not per token).  Publishing honors the
``CMN_OBS`` master switch via the same latch-at-construction rule as
every other publisher: an explicitly passed registry always publishes;
the ambient global registry is used only while observability is enabled.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, Optional, Sequence

from chainermn_tpu_torch.observability import metrics as _metrics

#: The monitored latency streams (all in milliseconds).
STREAMS = ("ttft", "queue_wait", "token")


def rolling_quantile(values: Sequence[float], q: float) -> Optional[float]:
    """Exact nearest-rank quantile of ``values`` (the JAX package's
    definition, so its monitor and this one agree on one sequence):
    ``sorted(values)[min(n - 1, int(round(q * (n - 1))))]``."""
    xs = sorted(values)
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    return float(raw)


class SLOMonitor:
    """Rolling-window latency quantiles + drift detection over the
    serving streams.

    Args:
      registry: a :class:`~chainermn_tpu_torch.observability.MetricsRegistry`.
        ``None`` resolves like every other publisher: the global registry
        while observability is enabled, no-op instruments otherwise.
      window: rolling-window size per stream
        (``CMN_SLO_WINDOW``, default 256).
      min_samples: observations required before a stream is judged —
        and, absent an absolute target, the calibration size for the
        auto-baseline (``CMN_SLO_MIN_SAMPLES``, default 32).
      tolerance: relative envelope width: a stream breaches when its
        rolling p95 exceeds ``ref * (1 + tolerance)``
        (``CMN_SLO_TOLERANCE``, default 0.5).
      targets: absolute p95 references in ms by stream name, e.g.
        ``{"token": 5.0}``; unset streams fall back to the env
        (``CMN_SLO_TTFT_P95_MS`` / ``CMN_SLO_QUEUE_WAIT_P95_MS`` /
        ``CMN_SLO_TOKEN_P95_MS``), then to auto-calibration.
      check_every: the cadence *hint* the scheduler reads — it calls
        :meth:`check` every this many decode iterations
        (``CMN_SLO_CHECK_EVERY``, default 16).  :meth:`check` itself can
        be called at any time.
    """

    def __init__(self, registry=None, window: Optional[int] = None,
                 min_samples: Optional[int] = None,
                 tolerance: Optional[float] = None,
                 targets: Optional[Dict[str, float]] = None,
                 check_every: Optional[int] = None):
        import chainermn_tpu_torch.observability as _obs

        self.window = int(
            window if window is not None
            else os.environ.get("CMN_SLO_WINDOW", "256")
        )
        self.min_samples = int(
            min_samples if min_samples is not None
            else os.environ.get("CMN_SLO_MIN_SAMPLES", "32")
        )
        self.tolerance = float(
            tolerance if tolerance is not None
            else os.environ.get("CMN_SLO_TOLERANCE", "0.5")
        )
        self.check_every = int(
            check_every if check_every is not None
            else os.environ.get("CMN_SLO_CHECK_EVERY", "16")
        )
        if self.window < 1 or self.min_samples < 1 or self.check_every < 1:
            raise ValueError(
                f"window/min_samples/check_every must be >= 1, got "
                f"{self.window}/{self.min_samples}/{self.check_every}"
            )
        # A window smaller than min_samples could never be judged — the
        # detector would be silently dead.  Clamp rather than raise: the
        # two knobs are independently env-settable.
        self.min_samples = min(self.min_samples, self.window)
        self._lock = threading.Lock()
        self._win: Dict[str, deque] = {
            s: deque(maxlen=self.window) for s in STREAMS
        }
        #: per-stream p95 reference; None until configured or calibrated.
        self._ref: Dict[str, Optional[float]] = {}
        self._calibrated: Dict[str, bool] = {s: False for s in STREAMS}
        for s in STREAMS:
            explicit = (targets or {}).get(s)
            self._ref[s] = (
                float(explicit) if explicit is not None
                else _env_float(f"CMN_SLO_{s.upper()}_P95_MS", None)
            )
        #: newest :meth:`check` report (flight-record provider fodder).
        self.last_report: Dict[str, dict] = {}

        if registry is None and not _obs.enabled():
            noop = _metrics.NoopInstrument()
            self._h = {s: noop for s in STREAMS}
            self._g_p50 = {s: noop for s in STREAMS}
            self._g_p95 = {s: noop for s in STREAMS}
            self._c_breach = {s: noop for s in STREAMS}
            self._g_drift = noop
            return
        reg = registry if registry is not None else _metrics.registry()
        edges = _metrics.DEFAULT_MS_EDGES
        self._h = {
            s: reg.histogram(f"serve.slo.{s}_ms", edges=edges)
            for s in STREAMS
        }
        self._g_p50 = {
            s: reg.gauge(f"serve.slo.{s}.p50_ms") for s in STREAMS
        }
        self._g_p95 = {
            s: reg.gauge(f"serve.slo.{s}.p95_ms") for s in STREAMS
        }
        self._c_breach = {
            s: reg.counter(f"serve.slo.{s}.breaches") for s in STREAMS
        }
        self._g_drift = reg.gauge("serve.slo.p95_drift")

    # -------------------------------------------------------------- observe
    def observe(self, stream: str, ms: float) -> None:
        """Record one latency sample (milliseconds) — hot-path cheap."""
        if stream not in self._win:
            raise ValueError(
                f"unknown SLO stream {stream!r} (one of {STREAMS})"
            )
        ms = float(ms)
        self._h[stream].observe(ms)
        with self._lock:
            self._win[stream].append(ms)

    def quantile(self, stream: str, q: float) -> Optional[float]:
        """Exact rolling-window quantile (None while the window is empty)."""
        with self._lock:
            vals = list(self._win[stream])
        return rolling_quantile(vals, q)

    # ---------------------------------------------------------------- check
    def check(self) -> Dict[str, dict]:
        """Recompute rolling p50/p95 per stream, update the gauges, run the
        drift detector, and return (and store) the per-stream report:

        ``{stream: {"n", "p50_ms", "p95_ms", "ref_p95_ms", "drift",
        "breached", "calibrated"}}`` — ``drift`` is relative
        (``p95/ref - 1``; negative = better than reference), ``ref_p95_ms``
        is None until configured or calibrated."""
        report: Dict[str, dict] = {}
        worst: Optional[float] = None
        for s in STREAMS:
            with self._lock:
                vals = list(self._win[s])
            n = len(vals)
            if n == 0:
                continue
            p50 = rolling_quantile(vals, 0.5)
            p95 = rolling_quantile(vals, 0.95)
            self._g_p50[s].set(p50)
            self._g_p95[s].set(p95)
            ref = self._ref[s]
            if ref is None and n >= self.min_samples:
                # Auto-calibrate: the first full-enough window defines
                # "normal" for this deployment.  Latched once — a drifting
                # run must not quietly re-baseline itself.
                ref = self._ref[s] = max(p95, 1e-9)
                self._calibrated[s] = True
            drift = breached = None
            # Drift is gated on min_samples exactly like `breached`: with
            # an absolute target configured, the first few samples (a
            # graph capture, a cold queue) would otherwise publish a huge
            # serve.slo.p95_drift — the prefill-cap signal — for a stream
            # the detector itself considers not-yet-judged.
            if ref is not None and n >= self.min_samples:
                drift = p95 / max(ref, 1e-9) - 1.0
                breached = bool(p95 > ref * (1.0 + self.tolerance))
                if breached:
                    self._c_breach[s].inc()
                worst = drift if worst is None else max(worst, drift)
            report[s] = {
                "n": n,
                "p50_ms": p50,
                "p95_ms": p95,
                "ref_p95_ms": ref,
                "drift": drift,
                "breached": breached,
                "calibrated": self._calibrated[s],
            }
        if worst is not None:
            self._g_drift.set(worst)
        self.last_report = report
        return report
