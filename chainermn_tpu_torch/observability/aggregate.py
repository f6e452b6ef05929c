"""Strict-JSON sanitizing and Prometheus text rendering of registry
snapshots.

The tracing, flight and incident modules write JSON through
:func:`sanitize_json`, so a NaN or an infinity never reaches a file as the
literal ``NaN``/``Infinity`` tokens that strict parsers reject.
:func:`render_prometheus` renders a snapshot in the Prometheus text
exposition format for node-exporter ``textfile`` collectors.

The rank-0 aggregator that merges every rank's snapshot over the host
object plane (``MetricsAggregator`` in the JAX package) needs the
communicator's object plane and is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List


def _prom_name(name: str) -> str:
    """Registry names are dotted (``serve.decode_ms``); Prometheus wants
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return "cmn_" + out


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Render a registry snapshot (per-rank, or merged with gauges as
    ``{"per_rank", "min", "mean", "max"}``) in Prometheus text exposition
    format.  Histograms emit cumulative ``_bucket`` series with the
    standard ``le`` label (``+Inf`` last) plus ``_sum``/``_count``."""
    lines: List[str] = []
    for name in sorted(snapshot):
        rec = snapshot[name]
        pname = _prom_name(name)
        kind = rec["type"]
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(rec['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            if "per_rank" in rec:  # merged form
                for stat in ("min", "mean", "max"):
                    v = rec.get(stat)
                    if v is not None:
                        lines.append(
                            f"{pname}{{stat=\"{stat}\"}} {_fmt(v)}"
                        )
            elif rec.get("value") is not None:
                lines.append(f"{pname} {_fmt(rec['value'])}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, c in zip(rec["edges"], rec["counts"]):
                cum += c
                lines.append(
                    f"{pname}_bucket{{le=\"{_fmt(edge)}\"}} {cum}"
                )
            cum += rec["counts"][-1]
            lines.append(f"{pname}_bucket{{le=\"+Inf\"}} {cum}")
            lines.append(f"{pname}_sum {_fmt(rec['sum'])}")
            lines.append(f"{pname}_count {rec['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: Any) -> str:
    f = float(v)
    # Prometheus accepts literal NaN/+Inf/-Inf sample values; int(f) on a
    # non-finite float raises.
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def sanitize_json(obj: Any) -> Any:
    """Recursively replace non-finite floats with ``None`` so written
    JSON stays strict (``json.dumps`` otherwise emits ``NaN`` /
    ``Infinity`` tokens that jq and non-Python parsers reject)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj
