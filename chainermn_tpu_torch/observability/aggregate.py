"""Rank-0 aggregation of the per-rank metric feeds, strict-JSON
sanitizing and Prometheus text rendering of registry snapshots.

:class:`MetricsAggregator` ships each rank's stamped entry to rank 0 over
the communicator's object plane (``gather_obj``) and has rank 0 append one
merged JSONL line per cadence tick, ``{"step", "wall_time", "nranks",
"per_rank": {rank: entry}, "merged": {...}}``: ``per_rank`` carries every
rank's entry verbatim (byte-comparable with the per-rank feeds),
``merged`` the exact fold of the registry snapshots
(:func:`~chainermn_tpu_torch.observability.metrics.merge_snapshots`).
The gather is a collective: every rank calls :meth:`collect` at the same
cadence (the trainer's ``MetricsReport`` fires at the same iterations on
every rank).

The tracing, flight and incident modules write JSON through
:func:`sanitize_json`, so a NaN or an infinity never reaches a file as the
literal ``NaN``/``Infinity`` tokens that strict parsers reject.
:func:`render_prometheus` renders a snapshot in the Prometheus text
exposition format for node-exporter ``textfile`` collectors.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional

from chainermn_tpu_torch.observability import metrics as _metrics


#: Merged-feed filename (under ``out_dir``).
MERGED_FEED = "metrics.merged.jsonl"
#: Prometheus textfile name (under ``out_dir``).
PROM_FILE = "metrics.prom"


class MetricsAggregator:
    """Fan per-rank metric entries into rank-0 merged JSONL (+ textfile).

    Args:
      comm: anything with ``rank``/``size``/``gather_obj`` (a
        :class:`~chainermn_tpu_torch.comm.base.CommunicatorBase`); ``None`` degrades to
        single-rank aggregation (the merged feed is still written, so a
        1-process run and an N-process run produce the same artifacts).
      out_dir: where rank 0 writes the merged feed / textfile.
      prometheus: also maintain the Prometheus-style textfile.
      quantiles: quantiles (in ``(0, 1]``) to estimate for every *merged*
        histogram via :func:`~chainermn_tpu_torch.observability.metrics.
        histogram_quantile`; each feed line then carries a
        ``"quantiles": {name: {"p95": ...}}`` section — fleet p95 from
        exactly-merged buckets, the SLO/autoscaling consumer's number.
        Default off (the feed schema is a cross-checked contract).
    """

    def __init__(self, comm=None, out_dir: str = "obs",
                 prometheus: bool = False,
                 quantiles: tuple = ()):
        self.comm = comm
        self.out_dir = out_dir
        self.prometheus = bool(prometheus)
        self.quantiles = tuple(float(q) for q in quantiles)
        self.rank = getattr(comm, "rank", 0) if comm is not None else 0
        self.size = getattr(comm, "size", 1) if comm is not None else 1

    @property
    def merged_path(self) -> str:
        return os.path.join(self.out_dir, MERGED_FEED)

    def collect(self, step: int, entry: dict) -> Optional[dict]:
        """Collective: gather every rank's ``entry`` for ``step``; rank 0
        merges, appends one feed line, and returns it (non-root returns
        None).  ``entry`` must be JSON-serializable and SHOULD carry a
        ``"registry"`` snapshot for the exact merge (entries without one
        still aggregate; ``merged`` is then empty)."""
        if self.comm is not None and self.size > 1:
            gathered = self.comm.gather_obj(entry, root=0)
            if self.rank != 0:
                return None
        else:
            gathered = [entry]
        # Key by each entry's OWN rank: gather_obj returns one entry per
        # participating *process*, and a process that owns several mesh
        # ranks reports under its first one — indexing by gather position
        # would mislabel it (and break the per-rank-file cross-check).
        per_rank = {}
        for i, e in enumerate(gathered):
            key = e.get("rank", i) if isinstance(e, dict) else i
            per_rank[str(key)] = e
        snaps = [
            e["registry"] for e in gathered
            if isinstance(e, dict) and isinstance(e.get("registry"), dict)
        ]
        line = {
            "step": int(step),
            "wall_time": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "nranks": len(gathered),
            "per_rank": per_rank,
            "merged": _metrics.merge_snapshots(snaps) if snaps else {},
        }
        if self.quantiles and line["merged"]:
            qs = {}
            for name, rec in line["merged"].items():
                if rec.get("type") != "histogram":
                    continue
                # :g keeps sub-percent labels distinct (0.995 -> p99.5;
                # rounding would collide it with 0.999 as p100).
                ests = {
                    f"p{q * 100:g}":
                        _metrics.histogram_quantile(rec, q)
                    for q in self.quantiles
                }
                if any(v is not None for v in ests.values()):
                    qs[name] = ests
            line["quantiles"] = qs
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.merged_path, "a") as f:
            f.write(json.dumps(sanitize_json(line)) + "\n")
        if self.prometheus:
            self._write_textfile(line["merged"])
        return line

    def _write_textfile(self, merged: Dict[str, dict]) -> None:
        path = os.path.join(self.out_dir, PROM_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(render_prometheus(merged))
        os.replace(tmp, path)  # atomic: scrapers never see a torn file




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
