"""Fleet plane of the port (``chainermn_tpu/observability/fleet.py``):
clock alignment across processes, one merged trace of every rank's span
ring, and straggler attribution.

* :class:`FleetClock`: NTP-style offsets between every rank's monotonic
  clock and rank 0's, over the communicator's object plane
  (``send_obj``/``recv_obj``; a bare :class:`~chainermn_tpu_torch.
  hostcomm.HostComm` works too).  Rank 0 probes each peer ``probes``
  times and keeps the minimum-RTT sample (:func:`ntp_offset`; the error
  is bounded by half its RTT).  :meth:`FleetClock.sync` is a collective;
  ``MetricsReport(fleet_trace=...)`` runs it at the first tick and again
  on a slow cadence.
* :func:`export_fleet_trace`, a collective: rank 0 gathers every rank's
  :func:`span_dump` over ``gather_obj``, rebases each rank's timestamps
  onto its own clock and writes one Perfetto-loadable trace
  (:func:`write_fleet_trace`), one process per rank.
* :func:`collective_occurrences` pairs collective spans across dumps by
  ``(op, seq)`` and measures each one's arrival spread;
  :func:`finalize_occurrences` is the one definition of that record.
* :func:`attribute_straggler` charges each spread past
  ``CMN_FLEET_MIN_SKEW_MS`` to its last arriver and names a rank only
  when it owns at least half the stall.
* :func:`chrome_fleet_events` / :func:`merge_fleet_trace` build the
  Chrome trace-event JSON and publish ``fleet.collective_skew_ms``,
  ``fleet.straggler_rank`` and ``fleet.straggler_stall_ms``.

The serving :class:`~chainermn_tpu_torch.serving.router.Router` merges its
replicas' rings with the same functions: its replicas share one process
and one clock, so every offset is zero.  ``offsets`` maps a rank to any
object with an ``offset_s`` attribute (the peer's monotonic clock minus
rank 0's, seconds) and a ``to_dict`` method; ``None`` means every dump
shares one clock.  The offline half is
:mod:`~chainermn_tpu_torch.observability.analyze`.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from chainermn_tpu_torch.observability import metrics as _metrics
from chainermn_tpu_torch.observability import tracing as _tracing

#: Host-plane composites whose cross-rank skew is worth attributing.
COLLECTIVE_OPS = (
    "barrier", "bcast_obj", "gather_obj", "allgather_obj", "allreduce_obj",
)

#: Merged-trace filename convention (under an obs dir).
MERGED_TRACE = "trace.merged.json"

#: Below this arrival spread a collective is considered aligned
#: (``CMN_FLEET_MIN_SKEW_MS``).
DEFAULT_MIN_SKEW_MS = 1.0
#: A rank is named straggler only when it owns at least this share of
#: the total attributed stall.
DEFAULT_MIN_SHARE = 0.5


def ntp_offset(t0: float, t1: float, t2: float, t3: float):
    """The NTP estimate of one round trip ``t0 -> (t1, t2) -> t3`` (local
    send, peer receive, peer reply, local receive): ``(offset_s,
    rtt_s)``, the offset being the peer's clock minus the local one (its
    error is at most ``rtt / 2``)."""
    return ((t1 - t0) + (t2 - t3)) / 2.0, (t3 - t0) - (t2 - t1)


@dataclass
class ClockOffset:
    """One peer's estimated clock relation to rank 0."""

    rank: int
    #: peer monotonic clock minus rank 0's, seconds.
    offset_s: float
    #: round trip of the winning (minimum-RTT) probe; the alignment
    #: uncertainty is about half of it.
    rtt_s: float
    probes: int = 0

    def to_dict(self) -> dict:
        return {"rank": self.rank, "offset_s": self.offset_s,
                "rtt_s": self.rtt_s, "probes": self.probes}


class FleetClock:
    """Pairwise monotonic-clock offsets, rank 0 to every other rank.

    ``comm`` is anything with ``rank``/``size``/``send_obj``/
    ``recv_obj`` (a communicator or a bare ``HostComm``); ``None`` (or
    one rank) is the trivial clock.  :meth:`sync` is a collective: rank 0
    pings each peer ``probes`` times in turn (two objects a probe), and
    the minimum-RTT sample's offset wins (a congested probe's error grows
    with its delay); a ``None`` sentinel ends each peer's loop.
    """

    def __init__(self, comm=None, probes: int = 8):
        if probes < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        self.comm = comm
        self.probes = int(probes)
        self.rank = int(getattr(comm, "rank", 0)) if comm is not None else 0
        self.size = int(getattr(comm, "size", 1)) if comm is not None else 1
        #: one process per rank in the port, so every rank takes part.
        self.participants: List[int] = list(range(self.size)) \
            if comm is not None else [self.rank]
        #: rank -> :class:`ClockOffset` (rank 0 only; its own entry is the
        #: identity); None until the first :meth:`sync`.
        self.offsets: Optional[Dict[int, ClockOffset]] = None
        self.synced_at: Optional[float] = None

    def _send(self, obj, dest: int) -> None:
        self.comm.send_obj(obj, dest, op="clock_sync")

    def _recv(self, source: int):
        return self.comm.recv_obj(source, op="clock_sync")

    def sync(self) -> Optional[Dict[int, ClockOffset]]:
        """Collective offset (re-)estimation: rank 0 returns the offset
        map (kept on ``self.offsets``), the other ranks None."""
        now = time.perf_counter
        root = self.participants[0] if self.participants else 0
        if len(self.participants) <= 1 or self.comm is None:
            self.offsets = {self.rank: ClockOffset(self.rank, 0.0, 0.0, 0)}
            self.synced_at = now()
            return self.offsets
        if self.rank == root:
            offsets = {root: ClockOffset(root, 0.0, 0.0, 0)}
            for peer in self.participants[1:]:
                best: Optional[ClockOffset] = None
                for i in range(self.probes):
                    t0 = now()
                    self._send(i, peer)
                    t1, t2 = self._recv(peer)
                    t3 = now()
                    off, rtt = ntp_offset(t0, t1, t2, t3)
                    if best is None or rtt < best.rtt_s:
                        best = ClockOffset(peer, off, rtt, self.probes)
                self._send(None, peer)
                offsets[peer] = best
            self.offsets = offsets
            self.synced_at = now()
            self._publish(offsets)
            return offsets
        while True:
            msg = self._recv(root)
            if msg is None:
                # Took part (rank 0 holds the offsets): marked, so a later
                # export does not run the protocol again alone.
                self.synced_at = now()
                return None
            t1 = now()
            self._send((t1, now()), root)

    @staticmethod
    def _publish(offsets: Dict[int, ClockOffset]) -> None:
        import chainermn_tpu_torch.observability as _obs

        if not _obs.enabled():
            return
        worst = max((o.rtt_s for o in offsets.values()), default=0.0)
        _metrics.registry().gauge("fleet.clock_rtt_ms").set(worst * 1e3)

    def offsets_s(self) -> Dict[int, float]:
        """Plain ``{rank: offset_s}`` (the identity when never synced)."""
        if not self.offsets:
            return {self.rank: 0.0}
        return {r: o.offset_s for r, o in self.offsets.items()}


# --------------------------------------------------------------- merging
def span_dump(rank: int) -> dict:
    """This rank's part of a fleet gather: its span ring and the epoch
    anchor of its clock (host state only)."""
    tr = _tracing.tracer()
    return {"rank": int(rank), "spans": tr.ring.snapshot(),
            "spans_total": tr.ring.total,
            "epoch_wall": _tracing.EPOCH_WALL,
            "epoch_perf": _tracing.EPOCH_PERF}


def _corrected(span: dict, offset_s: float) -> float:
    """A span's start on the rank-0 monotonic base."""
    return float(span["t_mono"]) - offset_s


def collective_occurrences(
    dumps: Sequence[dict],
    offsets_s: Optional[Dict[int, float]] = None,
    ops: Sequence[str] = COLLECTIVE_OPS,
) -> List[dict]:
    """Pair collective spans across rank dumps by ``(op, seq)`` and
    measure per-occurrence arrival spread.

    Returns one record per collective seen on ≥ 2 ranks, sorted by
    median corrected arrival:  ``{"op", "seq", "arrival_s": {rank: t},
    "end_s": {rank: t}, "skew_ms", "last_rank", "first_rank"}`` —
    ``skew_ms`` is the arrival spread (max − min) and ``last_rank`` the
    rank everyone else waited for.  Times are on the rank-0 monotonic
    base (``offsets_s``: peer clock minus rank 0's; missing ranks default
    to 0 offset — fine when all dumps share a host clock, e.g. tests).
    """
    offsets_s = offsets_s or {}
    occ: Dict[tuple, dict] = {}
    for dump in dumps:
        rank = int(dump["rank"])
        off = float(offsets_s.get(rank, 0.0))
        for span in dump.get("spans", ()):
            if span.get("op") not in ops or span.get("seq") is None:
                continue
            key = (span["op"], int(span["seq"]))
            rec = occ.setdefault(
                key, {"op": span["op"], "seq": int(span["seq"]),
                      "arrival_s": {}, "end_s": {}}
            )
            t = _corrected(span, off)
            rec["arrival_s"][rank] = t
            rec["end_s"][rank] = t + float(span.get("ms", 0.0)) / 1e3
    return finalize_occurrences(occ.values())


def finalize_occurrences(records) -> List[dict]:
    """Finish raw occurrence records (``{"op", "seq", "arrival_s",
    "end_s"}``) into the shared occurrence contract: drop records seen
    on < 2 ranks, stamp ``skew_ms``/``last_rank``/``first_rank``, and
    order by median arrival.  THE one definition — the online merge and
    the offline analyzer's trace reconstruction both finish through
    here, so the skew/attribution semantics cannot drift between
    them."""
    out = []
    for rec in records:
        arr = rec["arrival_s"]
        if len(arr) < 2:
            continue
        last = max(arr, key=arr.get)
        first = min(arr, key=arr.get)
        rec["skew_ms"] = (arr[last] - arr[first]) * 1e3
        rec["last_rank"] = last
        rec["first_rank"] = first
        out.append(rec)
    out.sort(key=lambda r: sorted(r["arrival_s"].values())
             [len(r["arrival_s"]) // 2])
    return out


def attribute_straggler(
    occurrences: Sequence[dict],
    min_skew_ms: Optional[float] = None,
    min_share: float = DEFAULT_MIN_SHARE,
) -> dict:
    """Causal straggler attribution over a run's collective occurrences.

    Each occurrence's stall (its arrival spread) is charged to its
    last-arriving rank, but only when the spread clears ``min_skew_ms``
    (``CMN_FLEET_MIN_SKEW_MS``, default 1 ms) — sub-floor spreads are
    scheduling noise.  A rank is *named* (``straggler_rank``) only when
    its attributed stall owns ≥ ``min_share`` of the total; otherwise
    ``straggler_rank`` is None and the per-rank ledger still tells the
    contention story.  Gating both ways is what lets an unfaulted run
    assert "no straggler" instead of electing whoever lost the most
    coin flips.
    """
    if min_skew_ms is None:
        min_skew_ms = float(
            os.environ.get("CMN_FLEET_MIN_SKEW_MS", str(DEFAULT_MIN_SKEW_MS))
        )
    stall_ms: Dict[int, float] = {}
    charged = 0
    for rec in occurrences:
        if rec["skew_ms"] < min_skew_ms:
            continue
        charged += 1
        stall_ms[rec["last_rank"]] = (
            stall_ms.get(rec["last_rank"], 0.0) + rec["skew_ms"]
        )
    total = sum(stall_ms.values())
    straggler = None
    if total > 0:
        worst = max(stall_ms, key=stall_ms.get)
        if stall_ms[worst] / total >= min_share:
            straggler = worst
    return {
        "straggler_rank": straggler,
        "stall_ms_by_rank": {str(r): round(v, 3)
                             for r, v in sorted(stall_ms.items())},
        "charged_collectives": charged,
        "total_collectives": len(occurrences),
        "total_stall_ms": round(total, 3),
        "min_skew_ms": min_skew_ms,
        "min_share": min_share,
    }


def chrome_fleet_events(
    dumps: Sequence[dict],
    offsets_s: Optional[Dict[int, float]] = None,
    occurrences: Optional[Sequence[dict]] = None,
) -> List[dict]:
    """Chrome trace-event objects for a fleet of span dumps: one
    *process* per rank (``pid`` = rank, named and sorted), every span a
    complete ``X`` slice at its offset-corrected time (collectives under
    cat ``collective``, everything else ``host_op``), plus a
    ``straggler`` instant on the last-arriving rank's track for every
    occurrence whose skew cleared the attribution floor.  Timestamps are
    microseconds from the earliest corrected span, so the trace opens at
    ~0 regardless of how long the processes were up."""
    offsets_s = offsets_s or {}
    t0 = None
    for dump in dumps:
        off = float(offsets_s.get(int(dump["rank"]), 0.0))
        for span in dump.get("spans", ()):
            t = _corrected(span, off)
            t0 = t if t0 is None else min(t0, t)
    if t0 is None:
        t0 = 0.0
    out: List[dict] = []
    for dump in sorted(dumps, key=lambda d: int(d["rank"])):
        rank = int(dump["rank"])
        off = float(offsets_s.get(rank, 0.0))
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"cmn rank {rank}"}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": rank,
                    "args": {"sort_index": rank}})
        for span in dump.get("spans", ()):
            args = {k: span[k] for k in
                    ("peer", "nbytes", "detail", "seq") if k in span}
            if not span.get("ok", True):
                args["error"] = span.get("error")
            cat = ("collective" if span.get("op") in COLLECTIVE_OPS
                   else "host_op")
            out.append({
                "name": span["op"], "cat": cat, "ph": "X",
                "pid": rank, "tid": 0,
                "ts": round((_corrected(span, off) - t0) * 1e6, 3),
                "dur": round(float(span.get("ms", 0.0)) * 1e3, 3),
                "args": args,
            })
    min_skew_ms = float(
        os.environ.get("CMN_FLEET_MIN_SKEW_MS", str(DEFAULT_MIN_SKEW_MS))
    )
    for rec in occurrences or ():
        if rec["skew_ms"] < min_skew_ms:
            continue
        out.append({
            "name": "straggler", "cat": "fleet", "ph": "i", "s": "p",
            "pid": rec["last_rank"], "tid": 0,
            "ts": round((rec["arrival_s"][rec["last_rank"]] - t0) * 1e6, 3),
            "args": {"op": rec["op"], "seq": rec["seq"],
                     "skew_ms": round(rec["skew_ms"], 3)},
        })
    return out


def merge_fleet_trace(
    dumps: Sequence[dict],
    offsets: Optional[Dict[int, object]] = None,
    registry=None,
) -> dict:
    """The rank-0 merge, comm-free (testable on synthetic dumps): skew
    analysis + straggler attribution + the Chrome trace payload, and the
    ``fleet.*`` metrics published (one ``fleet.collective_skew_ms``
    observation per paired collective; ``fleet.straggler_rank`` −1 when
    no rank clears the attribution gate).  Returns
    ``{"payload", "summary"}`` — write ``payload`` with
    :func:`write_fleet_trace`/``json.dump``."""
    import chainermn_tpu_torch.observability as _obs

    offsets_s = (
        {r: o.offset_s for r, o in offsets.items()} if offsets else {}
    )
    occurrences = collective_occurrences(dumps, offsets_s)
    verdict = attribute_straggler(occurrences)
    summary = {
        "nranks": len(dumps),
        "spans": sum(len(d.get("spans", ())) for d in dumps),
        "max_skew_ms": round(
            max((r["skew_ms"] for r in occurrences), default=0.0), 3
        ),
        "clock_offsets": (
            {str(r): o.to_dict() for r, o in offsets.items()}
            if offsets else None
        ),
        **verdict,
    }
    payload = {
        "traceEvents": chrome_fleet_events(dumps, offsets_s, occurrences),
        "displayTimeUnit": "ms",
        # Extra top-level keys are legal Chrome-trace metadata: the
        # offline analyzer reads this block, Perfetto ignores it.
        "cmn_fleet": {
            **summary,
            "collectives": [
                {"op": r["op"], "seq": r["seq"],
                 "skew_ms": round(r["skew_ms"], 3),
                 "last_rank": r["last_rank"],
                 "arrival_s": {str(k): round(v, 6)
                               for k, v in r["arrival_s"].items()},
                 "end_s": {str(k): round(v, 6)
                           for k, v in r["end_s"].items()}}
                for r in occurrences
            ],
        },
    }
    if registry is not None or _obs.enabled():
        reg = registry if registry is not None else _metrics.registry()
        hist = reg.histogram("fleet.collective_skew_ms",
                             _metrics.DEFAULT_MS_EDGES)
        for rec in occurrences:
            hist.observe(rec["skew_ms"])
        reg.gauge("fleet.straggler_rank").set(
            -1 if verdict["straggler_rank"] is None
            else verdict["straggler_rank"]
        )
        reg.gauge("fleet.straggler_stall_ms").set(
            verdict["total_stall_ms"]
        )
    return {"payload": payload, "summary": summary}


def write_fleet_trace(path: str, payload: dict) -> str:
    from chainermn_tpu_torch.observability import aggregate as _oagg

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_oagg.sanitize_json(payload), f)
    return path


def export_fleet_trace(comm=None, path: str = MERGED_TRACE,
                       clock: Optional[FleetClock] = None, probes: int = 8,
                       registry=None) -> Optional[dict]:
    """A collective: gather every rank's :func:`span_dump` to rank 0
    (``gather_obj``) and write one offset-corrected merged trace at
    ``path``.  An already synced ``clock`` lends its offsets; otherwise a
    sync runs first (also collective).  Rank 0 returns the summary (with
    ``"path"``), the others None; ``comm=None`` exports this process
    alone, in the same shape.  An export on the process registry then
    evaluates the incident rules, so a named straggler files its bundle
    with the clock in its manifest."""
    if clock is None:
        clock = FleetClock(comm, probes=probes)
    if clock.synced_at is None:
        clock.sync()
    rank = int(getattr(comm, "rank", 0)) if comm is not None else 0
    size = int(getattr(comm, "size", 1)) if comm is not None else 1
    dump = span_dump(rank)
    if comm is not None and size > 1:
        gathered = comm.gather_obj(dump, root=0)
        if rank != 0:
            return None
    else:
        gathered = [dump]
    merged = merge_fleet_trace(gathered, clock.offsets, registry=registry)
    merged["summary"]["path"] = write_fleet_trace(path, merged["payload"])
    if registry is None:
        import chainermn_tpu_torch.observability as _obs

        if _obs.enabled():
            from chainermn_tpu_torch.observability import incident as _oinc

            try:
                mgr = _oinc.manager()
                mgr.note_fleet_clock(clock)
                mgr.evaluate()
            except Exception:
                pass
    return merged["summary"]
