"""Heartbeat failure detection of the port
(``chainermn_tpu/resilience/detector.py``): attributed failures instead of
timeouts.

Rank ``r`` beats to its ring successor ``(r + 1) % size`` every
``interval_s`` and watches its predecessor ``(r - 1) % size``; a
predecessor silent for ``suspect_after`` intervals is SUSPECT, for
``dead_after`` intervals DEAD, and every beat gossips the ranks its sender
holds dead, so a death reaches the whole ring.  A
:class:`~chainermn_tpu_torch.hostcomm.HostComm` with a detector attached
slices its blocking waits by the heartbeat interval and checks the
detector between slices: a wait on a dead peer raises
:class:`PeerFailedError` naming the peer and the op within about one
interval, not a generic timeout at the transport's deadline.

:class:`DetectorCore` is the pure state machine (explicit clocks and
beats, no threads), :class:`FailureDetector` runs it in a sender and a
monitor thread over a dedicated transport, :func:`heartbeat_comm` builds
that transport from ``CMN_TPU_HB_HOSTS`` (the second port set
:mod:`chainermn_tpu_torch.launch` exports) and :func:`from_env` does both.
Death is sticky: a rank once DEAD stays DEAD for the detector's life
(recovery is restart-based).  The beats also carry each rank's step-time
statistics, freshest per origin, for the training-health guard's
straggler check.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class PeerFailedError(TimeoutError):
    """A peer rank failed, or a bounded op against it expired.

    Subclasses :class:`TimeoutError`, so call sites that catch a generic
    timeout keep working; carries ``peer`` (the rank that failed), ``op``
    (what the caller was doing), ``rank`` (who observed it) and ``kind``:
    ``"timeout"`` (a bounded wait expired; waiting again is meaningful),
    ``"dead"`` (a detector's verdict) or ``"transport"`` (a socket or
    framing failure)."""

    def __init__(self, peer: int, op: str = "?", rank: Optional[int] = None,
                 reason: str = "", kind: str = "timeout"):
        self.peer = int(peer)
        self.op = op
        self.rank = rank
        self.reason = reason
        self.kind = kind
        who = f"rank {rank}: " if rank is not None else ""
        super().__init__(f"{who}peer rank {self.peer} failed during {op}"
                         + (f" ({reason})" if reason else ""))


class DetectorCore:
    """The per-process heartbeat state machine (no threads, no sockets).

    Watches the ring predecessor directly; gossip can mark any rank dead.
    Thresholds are in units of ``interval_s``."""

    def __init__(self, rank: int, size: int, interval_s: float = 0.5,
                 suspect_after: float = 2.0, dead_after: float = 4.0):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"bad rank {rank} / size {size}")
        if not 0 < suspect_after <= dead_after:
            raise ValueError("need 0 < suspect_after <= dead_after")
        self.rank = int(rank)
        self.size = int(size)
        self.interval_s = float(interval_s)
        self.suspect_after = float(suspect_after)
        self.dead_after = float(dead_after)
        self.pred = (rank - 1) % size
        self.succ = (rank + 1) % size
        self._last_seen: Optional[float] = None
        self._dead: Set[int] = set()
        self._dead_reason: Dict[int, str] = {}

    def start(self, now: float) -> None:
        """Arm the monitor: the predecessor's silence is counted from
        ``now``."""
        self._last_seen = now

    def note_heartbeat(self, peer: int, now: float,
                       dead_ranks: Iterable[int] = ()) -> None:
        if peer == self.pred:
            self._last_seen = now
        for r in dead_ranks:
            r = int(r)
            if r != self.rank and r not in self._dead:
                self._dead.add(r)
                self._dead_reason[r] = "reported dead by ring gossip"

    def evaluate(self, now: float) -> str:
        """The predecessor's state at ``now`` (latching DEAD)."""
        if self.size == 1:
            return ALIVE
        if self.pred in self._dead:
            return DEAD
        if self._last_seen is None:
            return ALIVE  # not armed yet
        age = now - self._last_seen
        if age > self.dead_after * self.interval_s:
            self._dead.add(self.pred)
            self._dead_reason[self.pred] = (
                f"no heartbeat for {age:.2f}s "
                f"(> {self.dead_after:g} x {self.interval_s:g}s)")
            return DEAD
        if age > self.suspect_after * self.interval_s:
            return SUSPECT
        return ALIVE

    def mark_dead(self, peer: int, reason: str) -> None:
        if peer != self.rank:
            self._dead.add(int(peer))
            self._dead_reason[int(peer)] = reason

    def dead(self) -> Set[int]:
        return set(self._dead)

    def reason(self, peer: int) -> str:
        return self._dead_reason.get(int(peer), "")


class FailureDetector:
    """Ring heartbeats over a point-to-point transport, in two daemon
    threads (sender and monitor), around a :class:`DetectorCore`.

    ``transport`` has ``rank``, ``size``, ``send_obj(obj, dest)`` and
    ``recv_obj(source, timeout_ms=...)`` raising :class:`TimeoutError`
    when nothing arrives (a :class:`~chainermn_tpu_torch.hostcomm.
    HostComm`, or a stand-in in tests).  It must be the detector's own:
    beats would share the per-source FIFO with data frames otherwise."""

    def __init__(self, transport, interval_s: float = 0.5,
                 suspect_after: float = 2.0, dead_after: float = 4.0,
                 clock: Callable[[], float] = time.monotonic,
                 own_transport: bool = False):
        self.core = DetectorCore(transport.rank, transport.size,
                                 interval_s=interval_s,
                                 suspect_after=suspect_after,
                                 dead_after=dead_after)
        self._tp = transport
        self._own_tp = own_transport
        self._clock = clock
        # Liveness in the shared registry and this rank's view of the dead
        # in every flight record (imported here: the package's facade
        # imports this module).
        from chainermn_tpu_torch import observability as _obs
        from chainermn_tpu_torch.observability import flight as _oflight
        from chainermn_tpu_torch.observability import metrics as _omet

        self._obs_on = _obs.enabled()
        if self._obs_on:
            reg = _omet.registry()
            self._m_beats_sent = reg.counter("hb.beats_sent")
            self._m_beats_recv = reg.counter("hb.beats_received")
            self._m_dead = reg.gauge("hb.dead_ranks")
            _oflight.register_provider("detector", self.liveness_report)
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._seq = 0
        self._started = False
        # Step-time statistics riding the beats: rank -> (the origin's
        # beat number, stats); gossip keeps the freshest per origin.
        self._local_stats: Optional[dict] = None
        self._peer_stats: Dict[int, Tuple[int, dict]] = {}

    # ---------------------------------------------------------------- state
    @property
    def rank(self) -> int:
        return self.core.rank

    @property
    def interval_s(self) -> float:
        return self.core.interval_s

    def dead_ranks(self) -> Set[int]:
        with self._mu:
            return self.core.dead()

    def liveness_report(self) -> dict:
        """This rank's liveness view for the flight recorder: the dead
        ranks with the reasons, and the freshest gossiped statistics."""
        with self._mu:
            dead = sorted(self.core.dead())
            reasons = {str(r): self.core.reason(r) for r in dead}
        return {"rank": self.core.rank, "interval_s": self.core.interval_s,
                "dead": dead, "dead_reasons": reasons,
                "peer_stats": self.peer_stats()}

    # ------------------------------------------------------ stats piggyback
    def set_local_stats(self, stats: dict) -> None:
        """Publish this rank's step-time statistics: every later beat
        carries them around the ring."""
        with self._mu:
            self._local_stats = dict(stats)

    def peer_stats(self) -> Dict[int, dict]:
        """The freshest known statistics per rank (this one's included),
        lagging by up to the ring's length in beats."""
        with self._mu:
            out = {r: dict(s) for r, (_, s) in self._peer_stats.items()}
            if self._local_stats is not None:
                out[self.core.rank] = dict(self._local_stats)
        return out

    def check(self, op: str = "collective") -> None:
        """Raise :class:`PeerFailedError` (``kind="dead"``) naming the
        lowest dead rank and ``op`` if any peer is known dead: the hook
        :class:`~chainermn_tpu_torch.hostcomm.HostComm` calls between the
        slices of a wait."""
        with self._mu:
            self.core.evaluate(self._clock())
            dead = self.core.dead()
            if dead:
                peer = min(dead)
                reason = self.core.reason(peer)
        if dead:
            raise PeerFailedError(peer, op=op, rank=self.core.rank,
                                  reason=reason, kind="dead")

    # -------------------------------------------------------------- threads
    def start(self) -> "FailureDetector":
        if self._started or self.core.size == 1:
            self._started = True
            return self
        with self._mu:
            self.core.start(self._clock())
        for fn, name in ((self._send_loop, "hb-send"),
                         (self._monitor_loop, "hb-monitor")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"cmn-{name}-r{self.core.rank}")
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def stop(self) -> None:
        """Stop both threads (a normal end of the job) and close the
        transport if the detector owns it."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2 * self.core.interval_s + 1.0)
        self._threads = []
        if self._own_tp:
            try:
                self._tp.close()
            except Exception:
                pass

    def freeze(self) -> None:
        """Stop beating without closing the transport: the fault
        injector's ``hang`` hook, so that a frozen process looks dead to
        its peers while its sockets stay open, as a frozen host's do."""
        self._stop.set()

    def _send_loop(self) -> None:
        while not self._stop.wait(self.core.interval_s):
            with self._mu:
                self._seq += 1
                gossip = dict(self._peer_stats)
                if self._local_stats is not None:
                    gossip[self.core.rank] = (self._seq,
                                              dict(self._local_stats))
                payload = ("hb", self._seq, sorted(self.core.dead()), gossip)
            try:
                self._tp.send_obj(payload, self.core.succ)
                if self._obs_on:
                    self._m_beats_sent.inc()
            except Exception:
                # A dead successor is its own successor's to detect; this
                # rank keeps beating.
                pass

    def _monitor_loop(self) -> None:
        wait_ms = max(int(self.core.interval_s * 1000), 1)
        while not self._stop.is_set():
            try:
                msg = self._tp.recv_obj(self.core.pred, timeout_ms=wait_ms)
                # A 3-tuple is a beat without statistics; a 4-tuple carries
                # the gossip map.
                if isinstance(msg, tuple) and len(msg) in (3, 4) \
                        and msg[0] == "hb":
                    if self._obs_on:
                        self._m_beats_recv.inc()
                    with self._mu:
                        self.core.note_heartbeat(self.core.pred,
                                                 self._clock(),
                                                 dead_ranks=msg[2])
                        if len(msg) == 4 and isinstance(msg[3], dict):
                            self._merge_stats(msg[3])
            except TimeoutError:
                pass
            except Exception:
                # The transport failed under us (a reset peer, close()):
                # the silence keeps counting and evaluate() does the rest.
                if self._stop.wait(self.core.interval_s):
                    return
            with self._mu:
                self.core.evaluate(self._clock())
                n_dead = len(self.core.dead())
            if self._obs_on:
                self._m_dead.set(n_dead)

    def _merge_stats(self, gossip: dict) -> None:
        for r, ts in gossip.items():
            r = int(r)
            if r == self.core.rank or not (isinstance(ts, tuple)
                                           and len(ts) == 2):
                continue
            prev = self._peer_stats.get(r)
            if prev is None or prev[0] < ts[0]:
                self._peer_stats[r] = (int(ts[0]), dict(ts[1]))

    # ------------------------------------------------------------ wiring
    def attach(self, hostcomm) -> "FailureDetector":
        """Attach to a data-plane :class:`~chainermn_tpu_torch.hostcomm.
        HostComm`: its waits fail fast with attribution, and an injected
        ``hang`` freezes this detector's beats."""
        hostcomm.attach_detector(self)
        return self


def heartbeat_comm(timeout_ms: int = 10000):
    """The detector's own mesh, from ``CMN_TPU_HB_HOSTS`` (the port set
    the launcher allocates beside ``CMN_TPU_HOSTS``) and ``CMN_TPU_RANK``.
    Its fault hooks are off: ``CMN_FAULT`` specs count the data plane's
    ops, and a ``hang`` reaches the beats through the freeze callback."""
    from chainermn_tpu_torch.hostcomm import HostComm, parse_hosts

    spec = os.environ.get("CMN_TPU_HB_HOSTS", "")
    if not spec:
        raise ValueError("CMN_TPU_HB_HOSTS is not set: start the job with "
                         "chainermn_tpu_torch.launch")
    return HostComm(rank=int(os.environ["CMN_TPU_RANK"]),
                    hosts=parse_hosts(spec), timeout_ms=timeout_ms,
                    enable_faults=False)


def from_env(interval_s: float = 0.5, suspect_after: float = 2.0,
             dead_after: float = 4.0) -> Optional[FailureDetector]:
    """The launcher-wired detector (not started), or ``None`` where no
    heartbeat mesh exists (one process, or a job the launcher did not
    start)."""
    if not os.environ.get("CMN_TPU_HB_HOSTS"):
        return None
    return FailureDetector(heartbeat_comm(), interval_s=interval_s,
                           suspect_after=suspect_after,
                           dead_after=dead_after, own_transport=True)
