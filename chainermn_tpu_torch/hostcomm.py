"""Host object plane of the port over its native TCP transport
(``chainermn_tpu/hostcomm.py``).

The reference moved control objects (file names, metric dicts, dataset
orders, migration frames) with mpi4py's pickled operations (SURVEY.md
§2.2).  :class:`HostComm` carries them between processes over
``native/hostcomm.cpp`` (the port's copy of the JAX package's transport),
built with ``g++`` into ``_build/`` at first use: framed point-to-point
with a deadline on every send and receive, and barrier, bcast, gather,
allgather and allreduce composed from it in Python.  Tensors never go
through here: they ride the process group.

Topology comes from the arguments, from ``CMN_TPU_HOSTS`` (comma-separated
``ip:port``, rank order) and ``CMN_TPU_RANK`` (what
:mod:`chainermn_tpu_torch.launch` exports), or, under a bare
``torch.distributed`` job, from the default group's store
(:meth:`HostComm.from_env_or_store`).

A failed or expired op raises
:class:`~chainermn_tpu_torch.resilience.detector.PeerFailedError` naming
the peer and the op; with a heartbeat
:class:`~chainermn_tpu_torch.resilience.detector.FailureDetector`
attached (:meth:`HostComm.attach_detector`), a wait on a dead peer raises
the detector's verdict within about one heartbeat interval.  ``CMN_FAULT`` hooks fire at the ``barrier``,
``send`` and ``recv`` sites, and each op records a span in the process
tracer (``send_obj``/``recv_obj`` with peer and bytes; the composite's
name in ``detail``, and a span around each composite).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pickle
import random
import socket
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from chainermn_tpu_torch import native
from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability import tracing as _tracing
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.resilience.detector import PeerFailedError
from chainermn_tpu_torch.resilience.policy import RetryPolicy

#: Mesh bootstrap retry: 3 attempts, 0.5 s / 1 s backoff.
DEFAULT_BOOTSTRAP_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.5, multiplier=2.0, max_delay_s=5.0,
    retry_on=(RuntimeError,),
)

_STORE_PREFIX = "cmn_torch/hostcomm"


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A TCP port free on this host right now, drawn below the kernel's
    ephemeral range: the process group's own sockets take ephemeral
    ports, and one of them could otherwise land on a port handed out
    here before its owner binds it."""
    rng = random.Random()
    low = _ephemeral_low()
    for _ in range(256):
        port = rng.randrange(max(low // 2, 1024), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free TCP port below the ephemeral range")


def parse_hosts(spec: str) -> List[Tuple[str, int]]:
    """``"ip:port,ip:port"`` as ``[(ip, port), ...]``."""
    hosts = []
    for part in spec.split(","):
        ip, port = part.rsplit(":", 1)
        hosts.append((ip, int(port)))
    return hosts


class HostComm:
    """Point-to-point and composed collectives between host processes."""

    def __init__(self, rank: Optional[int] = None,
                 hosts: Optional[Sequence[Tuple[str, int]]] = None,
                 timeout_ms: int = 30000,
                 bootstrap_retry: Optional[RetryPolicy] = None,
                 enable_faults: bool = True,
                 enable_trace: Optional[bool] = None):
        if hosts is None:
            spec = os.environ.get("CMN_TPU_HOSTS", "")
            if not spec:
                raise ValueError(
                    "HostComm needs hosts=[(ip, port), ...] or CMN_TPU_HOSTS")
            hosts = parse_hosts(spec)
        if rank is None:
            rank = int(os.environ.get("CMN_TPU_RANK", "-1"))
        if not 0 <= rank < len(hosts):
            raise ValueError(f"bad rank {rank} for {len(hosts)} hosts")
        self.rank = int(rank)
        self.size = len(hosts)
        self.timeout_ms = int(timeout_ms)
        self._detector = None
        self._faults = _faults.process_injector() if enable_faults else None
        if enable_trace is None:
            enable_trace = enable_faults
        self._trace = (_tracing.tracer()
                       if enable_trace and _obs.enabled() else None)
        self._lib = native.load_hostcomm()
        c_hosts = (ctypes.c_char_p * self.size)(
            *[h.encode() for h, _ in hosts])
        c_ports = (ctypes.c_int * self.size)(*[p for _, p in hosts])

        def bootstrap():
            h = self._lib.hostcomm_init(self.rank, self.size, c_hosts,
                                        c_ports, self.timeout_ms)
            if not h:
                raise RuntimeError(f"hostcomm rank {self.rank}: failed to "
                                   "establish the peer mesh")
            return h

        self._h = (bootstrap_retry or DEFAULT_BOOTSTRAP_RETRY).call(
            bootstrap)

    @classmethod
    def from_env_or_store(cls, timeout_ms: int = 30000) -> "HostComm":
        """The world's object plane: from ``CMN_TPU_HOSTS``/``CMN_TPU_RANK``
        when the launcher exported them, else each rank publishes a free
        port of its host in the default process group's store and reads
        the others'."""
        if os.environ.get("CMN_TPU_HOSTS"):
            return cls(timeout_ms=timeout_ms)
        import torch.distributed as dist

        from chainermn_tpu_torch.distributed import default_store

        rank, size = dist.get_rank(), dist.get_world_size()
        store = default_store()
        local = os.environ.get("MASTER_ADDR", "127.0.0.1") in (
            "", "localhost", "127.0.0.1")
        ip = "127.0.0.1" if local else \
            socket.gethostbyname(socket.gethostname())
        store.set(f"{_STORE_PREFIX}/{rank}", f"{ip}:{free_port()}")
        hosts = [parse_hosts(store.get(f"{_STORE_PREFIX}/{r}").decode())[0]
                 for r in range(size)]
        return cls(rank=rank, hosts=hosts, timeout_ms=timeout_ms)

    # ------------------------------------------------------------ resilience
    def attach_detector(self, detector) -> None:
        """Wire a :class:`~chainermn_tpu_torch.resilience.detector.
        FailureDetector` in: blocking waits are sliced by its heartbeat
        interval and check it between slices (a wait on a dead peer raises
        its attributed verdict), and an injected ``hang`` freezes its
        beats too (a hung process must look dead to its peers)."""
        self._detector = detector
        if self._faults is not None:
            self._faults.add_freeze_callback(detector.freeze)

    def _peer_error(self, peer: int, op: str, reason: str,
                    kind: str = "timeout") -> PeerFailedError:
        return PeerFailedError(peer, op=op, rank=self.rank, reason=reason,
                               kind=kind)

    def _wait_frame(self, source: int, timeout_ms: int, op: str) -> int:
        """Wait for the next frame from ``source`` (left queued) and return
        its length; ``timeout_ms < 0`` waits forever.  With a detector
        attached the wait runs in slices of its heartbeat interval, and
        the detector's verdict is checked before each."""
        deadline = None if timeout_ms < 0 else \
            time.monotonic() + timeout_ms / 1000.0
        while True:
            if self._detector is not None:
                self._detector.check(op=op)
                slice_ms = max(int(self._detector.interval_s * 1000), 20)
            else:
                slice_ms = -1
            if deadline is None:
                wait_ms = slice_ms
            else:
                remain_ms = int((deadline - time.monotonic()) * 1000)
                if remain_ms <= 0:
                    raise self._peer_error(
                        source, op, f"recv timed out after {timeout_ms}ms")
                wait_ms = remain_ms if slice_ms < 0 else \
                    min(remain_ms, slice_ms)
            n = self._lib.hostcomm_recv(self._h, source, None, 0, wait_ms)
            if n >= 0:
                return int(n)
            if n != -1:
                raise self._peer_error(source, op, f"recv failed (rc={n})",
                                       kind="transport")
            # The slice ran out: check the detector and the deadline again.

    # -------------------------------------------------------- point-to-point
    def _span(self, op: str, peer: Optional[int] = None,
              parent_op: Optional[str] = None):
        if self._trace is None:
            return contextlib.nullcontext()
        return self._trace.span(op, peer=peer,
                                detail=parent_op if parent_op != op
                                else None)

    def send_obj(self, obj: Any, dest: int, timeout_ms: Optional[int] = None,
                 op: str = "send_obj") -> None:
        with self._span("send_obj", peer=dest, parent_op=op) as sp:
            if self._faults is not None and \
                    self._faults.hook("send") == "drop":
                return  # lost on the wire: the receiver never sees it
            timeout_ms = self.timeout_ms if timeout_ms is None \
                else timeout_ms
            payload = pickle.dumps(obj)
            if sp is not None:
                sp.nbytes = len(payload)
            # The pickle's own bytes, not a copy of them.
            buf = ctypes.cast(ctypes.c_char_p(payload),
                              ctypes.POINTER(ctypes.c_uint8))
            rc = self._lib.hostcomm_send(self._h, dest, buf, len(payload),
                                         timeout_ms)
            if rc == -3:
                raise self._peer_error(
                    dest, op, f"send timed out after {timeout_ms}ms (peer "
                    "not draining)")
            if rc != 0:
                raise self._peer_error(dest, op, f"send failed (rc={rc})",
                                       kind="transport")

    def recv_obj(self, source: int, timeout_ms: Optional[int] = None,
                 op: str = "recv_obj") -> Any:
        with self._span("recv_obj", peer=source, parent_op=op) as sp:
            if self._faults is not None and \
                    self._faults.hook("recv") == "drop":
                self._pop_frame(source, timeout_ms, op)
            frame = self._pop_frame(source, timeout_ms, op)
            if sp is not None:
                sp.nbytes = len(frame)
            return pickle.loads(frame)

    def _pop_frame(self, source: int, timeout_ms: Optional[int],
                   op: str) -> memoryview:
        timeout_ms = self.timeout_ms if timeout_ms is None else timeout_ms
        n = self._wait_frame(source, timeout_ms, op)
        buf = (ctypes.c_uint8 * max(n, 1))()
        got = self._lib.hostcomm_recv(self._h, source, buf, n, 0)
        if got != n:
            raise self._peer_error(source, op,
                                   f"frame length changed {n}->{got}",
                                   kind="transport")
        # A view of the received buffer (slicing a c_uint8 array would
        # build a list of ints; unpickling copies what it keeps).
        return memoryview(buf)[:n]

    # ----------------------------------------------------------- composites
    def _composite_span(self, op: str, peer: Optional[int] = None):
        if self._trace is None:
            return contextlib.nullcontext()
        return self._trace.span(op, peer=peer)

    def barrier(self) -> None:
        """Dissemination barrier: log2(size) rounds of paired send/recv."""
        with self._composite_span("barrier"):
            if self._faults is not None:
                self._faults.hook("barrier")
            k = 1
            while k < self.size:
                self.send_obj((), (self.rank + k) % self.size, op="barrier")
                self.recv_obj((self.rank - k) % self.size, op="barrier")
                k *= 2

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        """Binomial-tree broadcast rooted at ``root`` (log2(size) depth)."""
        with self._composite_span("bcast_obj", peer=root):
            rel = (self.rank - root) % self.size
            mask = 1
            while mask < self.size:
                if rel & mask:
                    obj = self.recv_obj((self.rank - mask) % self.size,
                                        op="bcast_obj")
                    break
                mask <<= 1
            mask >>= 1
            while mask >= 1:
                if rel + mask < self.size:
                    self.send_obj(obj, (self.rank + mask) % self.size,
                                  op="bcast_obj")
                mask >>= 1
            return obj

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        with self._composite_span("gather_obj", peer=root):
            if self.rank != root:
                self.send_obj(obj, root, op="gather_obj")
                return None
            out: List[Any] = [None] * self.size
            out[self.rank] = obj
            for r in range(self.size):
                if r != root:
                    out[r] = self.recv_obj(r, op="gather_obj")
            return out

    def allgather_obj(self, obj: Any) -> List[Any]:
        with self._composite_span("allgather_obj"):
            return self.bcast_obj(self.gather_obj(obj, root=0), root=0)

    def allreduce_obj(self, obj: Any, op: Callable[[Any, Any], Any]) -> Any:
        with self._composite_span("allreduce_obj"):
            vals = self.allgather_obj(obj)
            acc = vals[0]
            for v in vals[1:]:
                acc = op(acc, v)
            return acc

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.hostcomm_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass

