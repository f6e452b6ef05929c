"""Per-rank metrics registry — counters, gauges, exact-merge histograms.

Every subsystem of the port (the serving scheduler and its planes)
publishes named instruments into one process-wide registry; snapshots are
plain dicts, and a bounded ring of stamped snapshots is what the flight
recorder dumps.

Design constraints, in order:

* **Hot-path cheap** — ``Counter.inc`` / ``Histogram.observe`` are a lock,
  an add, a ``bisect``.  No host↔device sync, no allocation, no string
  formatting.
* **Fixed histogram edges** — chosen at creation, so two histograms of
  one name (two ranks, two runs) merge exactly by adding bucket counts.
* **JSON all the way down** — ``snapshot()`` returns plain dicts of
  str/int/float.

Instruments are identified by name alone; re-requesting a name returns the
same instrument, and requesting it as a different type (or a histogram with
different edges) raises — a silent second instrument would fork the data.
"""

from __future__ import annotations

import bisect
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


def _env_float(name: str, default: float) -> float:
    """Tolerant env-number read for the serving knobs: unset or malformed
    values fall back to the default, so a typo'd knob degrades to the
    shipped behaviour instead of crashing a publisher at construction."""
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return float(default)


#: Default histogram edges, in milliseconds (sub-ms to 30 s); the
#: upper-open overflow bucket is implicit.
DEFAULT_MS_EDGES: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Counter:
    """Monotonic float counter (events, bytes)."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc by negative {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (queue depths, dead-rank counts, loss)."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-edge histogram: ``len(edges)+1`` integer buckets (the last is
    the overflow), plus exact ``sum``/``count``/``min``/``max``.

    Bucket ``i`` counts observations ``v <= edges[i]`` (cumulative counts
    are derived at render time); the overflow bucket counts
    ``v > edges[-1]``.  Because the edges are part of the instrument's
    identity, two ranks' histograms of the same name merge exactly.
    """

    kind = "histogram"

    def __init__(self, name: str, lock: threading.Lock,
                 edges: Sequence[float] = DEFAULT_MS_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name}: edges must be non-empty, strictly "
                f"increasing, got {edges}"
            )
        self.name = name
        self.edges = edges
        self._lock = lock
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "edges": list(self.edges),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min,
                "max": self._max,
            }


class NoopInstrument:
    """No-op stand-in for any registry instrument.  Publishers that latch
    the ``CMN_OBS`` master switch at construction (the serving scheduler)
    hold one of these instead of a real instrument when the switch is
    off."""

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


class MetricsRegistry:
    """Named-instrument registry with a bounded ring of stamped
    snapshots.  One instance per process (:func:`registry`); tests may
    build their own.  ``sample(step)`` appends ``{"step", "metrics":
    snapshot()}`` to the last-K ring the flight recorder dumps (K is
    ``CMN_OBS_SAMPLES``, default 64)."""

    def __init__(self, sample_capacity: int = 64):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._samples: deque = deque(maxlen=int(sample_capacity))

    # ------------------------------------------------------------ factories
    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                # Each instrument gets its own lock: hot-path updates must
                # not contend on the registry lock, which guards only the
                # name table.
                inst = self._instruments[name] = cls(
                    name, threading.Lock(), **kwargs
                )
                return inst
        if not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        if kwargs.get("edges") is not None and \
                tuple(float(e) for e in kwargs["edges"]) != inst.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{inst.edges}; a second edge set would break the exact "
                f"merge of snapshots"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_MS_EDGES) -> Histogram:
        return self._get(name, Histogram, edges=edges)

    def peek(self, name: str):
        """The instrument registered under ``name``, or ``None``; never
        creates one.  The incident plane's watch rules read through this,
        so a rule for a plane this process never built materializes no
        instrument."""
        with self._lock:
            return self._instruments.get(name)

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable state of every instrument, by name."""
        with self._lock:
            insts = list(self._instruments.items())
        return {name: inst.to_dict() for name, inst in insts}

    def sample(self, step: int) -> dict:
        """Record (and return) a stamped snapshot in the last-K ring."""
        s = {"step": int(step), "metrics": self.snapshot()}
        with self._lock:
            self._samples.append(s)
        return s

    def last_samples(self) -> List[dict]:
        with self._lock:
            return list(self._samples)


def merge_snapshots(snaps: Sequence[Dict[str, dict]]) -> Dict[str, dict]:
    """Exact fleet merge of per-rank :meth:`MetricsRegistry.snapshot` s.

    * counters — summed;
    * histograms — element-wise bucket sums (edges must match exactly:
      mismatched edges raise rather than approximate), sum/count summed,
      min/max folded;
    * gauges — ``{"min", "max", "mean", "per_rank"}`` (a fleet has no
      single last-written value; the per-rank list keeps it lossless).
    """
    out: Dict[str, dict] = {}
    for idx, snap in enumerate(snaps):
        for name, rec in snap.items():
            cur = out.get(name)
            if cur is None:
                if rec["type"] == "gauge":
                    out[name] = {"type": "gauge", "per_rank": [rec["value"]]}
                else:
                    out[name] = {k: (list(v) if isinstance(v, list) else v)
                                 for k, v in rec.items()}
                continue
            if cur["type"] != rec["type"]:
                raise ValueError(
                    f"metric {name!r}: type mismatch across ranks "
                    f"({cur['type']} vs {rec['type']})"
                )
            if rec["type"] == "counter":
                cur["value"] += rec["value"]
            elif rec["type"] == "gauge":
                cur["per_rank"].append(rec["value"])
            else:  # histogram
                if cur["edges"] != rec["edges"]:
                    raise ValueError(
                        f"histogram {name!r}: bucket edges differ across "
                        f"ranks — exact merge impossible ({cur['edges']} "
                        f"vs {rec['edges']})"
                    )
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], rec["counts"])]
                cur["sum"] += rec["sum"]
                cur["count"] += rec["count"]
                for k, fold in (("min", min), ("max", max)):
                    vals = [v for v in (cur[k], rec[k]) if v is not None]
                    cur[k] = fold(vals) if vals else None
    for rec in out.values():
        if rec["type"] == "gauge":
            vals = [v for v in rec["per_rank"] if v is not None]
            rec["min"] = min(vals) if vals else None
            rec["max"] = max(vals) if vals else None
            rec["mean"] = sum(vals) / len(vals) if vals else None
    return out


def histogram_quantile(rec: dict, q: float) -> Optional[float]:
    """Estimate quantile ``q`` from a histogram *snapshot* dict (per-rank
    or merged — both carry the same ``edges``/``counts`` layout).

    Prometheus-style linear interpolation inside the covering bucket,
    with two exactness improvements the snapshot affords: the estimate
    is clamped to the recorded ``[min, max]``, and the first/overflow
    buckets use ``min``/``max`` as their open bounds instead of 0/+Inf.
    Returns ``None`` for an empty histogram.

    This is the fleet-quantile path: per-rank histograms merge exactly
    (bucketwise sums), so a rank-0 p95 estimated from the merged counts
    is the same estimate a single observer's histogram would give —
    unlike merged quantile *sketches*, which approximate twice.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = rec.get("count", 0)
    if not total:
        return None
    edges = rec["edges"]
    counts = rec["counts"]
    lo_bound = rec.get("min")
    hi_bound = rec.get("max")
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if cum + c >= target and c > 0:
            lo = (lo_bound if lo_bound is not None else 0.0) \
                if i == 0 else edges[i - 1]
            hi = edges[i] if i < len(edges) else (
                hi_bound if hi_bound is not None else edges[-1]
            )
            est = lo + (hi - lo) * max(target - cum, 0.0) / c
            if lo_bound is not None:
                est = max(est, lo_bound)
            if hi_bound is not None:
                est = min(est, hi_bound)
            return est
        cum += c
    return hi_bound  # pragma: no cover - defensive (count drift)


#: Process-wide registry (lazy).
_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def registry() -> MetricsRegistry:
    """THE per-process registry every subsystem publishes into."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry(sample_capacity=int(
                os.environ.get("CMN_OBS_SAMPLES", "64")))
    return _registry
