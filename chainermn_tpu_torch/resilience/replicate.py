"""Peer-replicated checkpoint shards of the port
(``chainermn_tpu/resilience/replicate.py``): survivor-assisted fast
restore.

The :class:`~chainermn_tpu_torch.extensions.MultiNodeCheckpointer` is the
durable tier: full snapshots on shared storage, but a restore pays its
I/O and everything since the last save is lost.  Here each rank copies
what it owns of the training state to host memory at a cadence, spills
it to a local directory and ships it to its ring neighbour(s) over the
communicator's object plane, so a relaunch whose host (and disk) died
restores from a peer, and a failure loses at most one cadence.

* :class:`ShardReplicator`, a trainer :class:`~chainermn_tpu_torch.
  training.Extension` firing every ``CMN_REP_EVERY`` iterations (0 = off;
  :meth:`ShardReplicator.maybe_from_env`).  What a rank owns is what its
  checkpoint file holds (:func:`~chainermn_tpu_torch.extensions.checkpoint.
  state_payload`): the model's parameters and buffers, the torch
  optimizer's state (a ZeRO rank's own shards and shard-sized state), the
  options' state, and the loop state (:func:`~chainermn_tpu_torch.
  extensions.checkpoint.capture_loop_state`: iteration, iterator cursor
  and RNG).  The extension runs between steps, after the card finished
  the last one: the card's tensors are copied into pinned host buffers
  kept across cadences, on a side stream, and serialized as the
  checkpointer's files are (``torch.save``); a snapshot is built whole,
  then published by one reference swap (the double buffer) and one
  atomic ``os.replace``, written on a thread while the frames travel.
  Frames carry the ``cmn-ckptrep-1`` schema, a per-destination sequence
  number and a crc32 of the shard's bytes; a torn or out-of-order frame
  is counted and dropped, never installed.  The content digest
  (:func:`shard_digest`) is taken from the spill when a restore needs
  it, not at every cadence.
* :func:`negotiate_restore`, run on a supervised relaunch
  (:func:`should_negotiate`) before any other restore: the ranks
  allgather their inventories (own snapshots and held replicas, with
  content digests), :func:`pick_quorum` names the newest step whose every
  shard is reachable with one digest, holders serve missing shards
  point to point (digest checked on arrival), a second allgather
  confirms, and only then does each rank install, **into the tensors
  its state already holds** (a captured train step replays on their
  addresses).  No quorum, a different world size, a failed transfer or a
  structure mismatch fall back to ``checkpointer.maybe_load`` or to
  ``elastic()`` (``maybe_load_elastic``), counted on
  ``train.rep.fallback``.  The snapshot carries the loop state, so a
  crash and a fast restore end on the unfaulted run's parameters bit for
  bit.
* :class:`TrainingChaosHarness` and :func:`chaos_schedule`: a seeded
  schedule of failures (``crash@iter``, a SIGTERM preemption, the torn
  frame ``flip@replicate``), one per supervised attempt, with goodput
  accounting and the invariant: the run reaches its target, its final
  digest is the oracle's, and no failure loses more than one cadence.

Metrics: ``train.rep.bytes``, ``.ms``, ``.snapshots``, ``.replicas_held``,
``.torn``, ``.dropped``, ``.fallback``, ``.restore.<source>``,
``.lost_steps_excess``, ``train.recovery_ms`` and ``train.lost_steps``;
flight provider ``"replication"``; default incident rules
``replication_fallback``, ``replication_lost_steps`` and
``replication_torn``.  Knobs: ``CMN_REP_EVERY``, ``CMN_REP_FACTOR``,
``CMN_REP_DIR``.
"""

from __future__ import annotations

import io
import os
import pickle
import random
import sys
import threading
import time
import zlib
from hashlib import blake2b
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability import metrics as _omet
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.training import Extension

#: Wire and spill schema tag; a frame with any other tag is rejected.
REPLICATE_SCHEMA = "cmn-ckptrep-1"


class ReplicationError(RuntimeError):
    """A replication frame or spill file failed validation, or a restore
    negotiation could not complete.  Callers fall back to the checkpoint
    tier: this never means lost training state."""


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def shard_digest(payload: bytes) -> str:
    """Content digest of a shard's serialized bytes: what the quorum
    negotiation compares across copies."""
    return blake2b(payload, digest_size=16).hexdigest()


# ------------------------------------------------------------ host form
def _structure(obj) -> Any:
    """Keys, shapes and dtypes of a nested state (tensors or numpy
    leaves): what a shard must match before it is installed."""
    if isinstance(obj, torch.Tensor):
        return ("t", tuple(obj.shape), str(obj.dtype).rsplit(".", 1)[-1])
    if isinstance(obj, np.ndarray):
        return ("a", tuple(obj.shape), str(obj.dtype))
    if isinstance(obj, dict):
        return {str(k): _structure(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_structure(v) for v in obj]
    return type(obj).__name__


def _state_structure(state) -> Any:
    """:func:`_structure` of what a snapshot of a TrainState holds, read
    off the live tensors (no copies).  Of the torch optimizer only its
    groups' sizes count: its per-parameter state is lazy (empty in a
    relaunched process until the first step), and an in-place restore
    loads it whole (``_load_optimizer_in_place``)."""
    from chainermn_tpu_torch.extensions.checkpoint import state_payload

    live = state_payload(state, host=lambda x: x)
    live["optimizer"] = [len(g["params"])
                         for g in live["optimizer"]["param_groups"]]
    return _structure(live)


def _in_thread(fn, *args) -> Callable[[], float]:
    """Start ``fn(*args)`` on a thread; the returned join waits for it,
    re-raises its error and returns its seconds."""
    box: Dict[str, Any] = {}

    def run():
        t0 = time.perf_counter()
        try:
            fn(*args)
        except BaseException as e:  # re-raised by the join
            box["error"] = e
        box["s"] = time.perf_counter() - t0

    th = threading.Thread(target=run, name="cmn-rep-spill", daemon=True)
    th.start()

    def join() -> float:
        th.join()
        if "error" in box:
            raise box["error"]
        return box["s"]

    return join


def _recv_frame(comm, source: int):
    """One frame from ``source``; None when nothing is queued (the
    in-process :class:`~chainermn_tpu_torch.serving.disagg.LocalComm`
    raises ``TimeoutError`` at once on an empty queue: a frame a rank
    driven later sends arrives at the next cadence)."""
    try:
        return comm.recv_obj(source)
    except TimeoutError:
        return None


class ShardReplicator(Extension):
    """Trainer extension: cadenced host snapshots of what this rank owns
    of the training state, spilled locally and shipped to ``factor``
    ring neighbours as ``cmn-ckptrep-1`` frames.

    Args:
      comm: the training communicator (``send_obj``/``recv_obj``/
        ``allgather_obj``); ``None`` for one process (local spill only).
      every: cadence in iterations (default ``CMN_REP_EVERY``; >= 1, see
        :meth:`maybe_from_env`).
      factor: ring neighbours each snapshot goes to (default
        ``CMN_REP_FACTOR``, at most ``size - 1``).
      spill_dir: local spill root (default ``CMN_REP_DIR``); this rank
        writes under ``<spill_dir>/rank<r>/``.
      keep: newest snapshots kept per source (own and each peer).
      injector: fault injector of the ``replicate`` site (default the
        process's): ``drop@replicate:N`` loses the N-th cadence's frame
        (a sequence gap at the receiver), ``flip@replicate:N`` ships torn
        bytes (crc mismatch, discarded).
    """

    def __init__(self, comm=None, *, every: Optional[int] = None,
                 factor: Optional[int] = None,
                 spill_dir: Optional[str] = None, keep: int = 2,
                 name: str = "default", injector=None,
                 _use_process_injector: bool = True):
        if every is None:
            every = int(os.environ.get("CMN_REP_EVERY", "0"))
        if every < 1:
            raise ValueError(
                f"replication cadence must be >= 1 iteration, got {every} "
                "(CMN_REP_EVERY unset/0 means replication is off: use "
                "ShardReplicator.maybe_from_env for env-gated construction)")
        super().__init__(self._fire, trigger=(every, "iteration"),
                         name=f"replicator/{name}")
        self.comm = comm
        self.rank = int(getattr(comm, "rank", 0)) if comm is not None else 0
        self.size = int(getattr(comm, "size", 1)) if comm is not None else 1
        if factor is None:
            factor = int(os.environ.get("CMN_REP_FACTOR", "1"))
        self.every = int(every)
        self.factor = max(0, min(int(factor), self.size - 1))
        self.keep = max(1, int(keep))
        root = spill_dir or os.environ.get("CMN_REP_DIR", "ckptrep")
        self.spill_dir = os.path.join(os.path.abspath(root),
                                      f"rank{self.rank}")
        os.makedirs(self.spill_dir, exist_ok=True)
        if injector is None and _use_process_injector:
            injector = _faults.process_injector()
        self._injector = injector
        self._seq_out: Dict[int, int] = {}
        self._seq_in: Dict[int, int] = {}
        #: newest fully built snapshot (the double buffer): assigned by
        #: one reference swap after it is complete.
        self._buffer: Optional[dict] = None
        #: pinned host buffers the card's tensors are copied into, kept
        #: across cadences (the i-th card tensor of a snapshot uses the
        #: i-th buffer), and the side stream that fills them.
        self._pinned: List[torch.Tensor] = []
        self._stream = None
        self._last_restore: Optional[dict] = None
        #: seconds of the newest cadence: the host copy, serialization and
        #: crc32; the local spill (on a thread, beside the exchange); the
        #: exchange; and all of it.
        self.last_cadence: Dict[str, float] = {}
        self._obs_on = _obs.enabled()
        if self._obs_on:
            reg = _omet.registry()
            self._m_bytes = reg.counter("train.rep.bytes")
            self._m_ms = reg.histogram("train.rep.ms")
            self._m_snapshots = reg.counter("train.rep.snapshots")
            self._m_held = reg.gauge("train.rep.replicas_held")
            self._m_torn = reg.counter("train.rep.torn")
            self._m_dropped = reg.counter("train.rep.dropped")
        from chainermn_tpu_torch.observability import flight as _oflight

        _oflight.register_provider("replication", self.report)

    @classmethod
    def maybe_from_env(cls, comm=None, **kw) -> Optional["ShardReplicator"]:
        """``None`` unless ``CMN_REP_EVERY`` >= 1."""
        if int(os.environ.get("CMN_REP_EVERY", "0")) < 1:
            return None
        return cls(comm, **kw)

    # ------------------------------------------------------------- snapshot
    def _host_copies(self, state) -> dict:
        """:func:`~chainermn_tpu_torch.extensions.checkpoint.state_payload`
        of ``state`` in host memory: each card tensor copied into its
        pinned buffer on the side stream (one wait for all of them), a
        host tensor cloned."""
        from chainermn_tpu_torch.extensions.checkpoint import state_payload

        used = [0]
        devices = []

        def host(obj):
            if isinstance(obj, torch.Tensor):
                t = obj.detach()
                if not t.is_cuda:
                    return t.clone()
                i = used[0]
                used[0] += 1
                if i == len(self._pinned):
                    self._pinned.append(None)
                buf = self._pinned[i]
                if buf is None or buf.shape != t.shape \
                        or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                    self._pinned[i] = buf
                if not devices:
                    devices.append(t.device)
                    if self._stream is None \
                            or self._stream.device != t.device:
                        self._stream = torch.cuda.Stream(t.device)
                    self._stream.wait_stream(
                        torch.cuda.current_stream(t.device))
                with torch.cuda.stream(self._stream):
                    buf.copy_(t, non_blocking=True)
                return buf
            if isinstance(obj, dict):
                return {k: host(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(host(v) for v in obj)
            return obj

        out = state_payload(state, host=host)
        if devices:
            self._stream.synchronize()
        return out

    def _snapshot(self, trainer) -> dict:
        """A whole host snapshot of this rank's state and loop state,
        serialized as the checkpointer's files are (``torch.save``)."""
        from chainermn_tpu_torch.extensions.checkpoint import (
            capture_loop_state,
            sync_state,
        )

        state = trainer.state
        sync_state(state)
        snap = {
            "schema": REPLICATE_SCHEMA,
            "step": int(trainer.iteration),
            "rank": self.rank,
            "size": self.size,
            "structure": _state_structure(state),
            "state": self._host_copies(state),
            "loop": capture_loop_state(trainer),
        }
        buf = io.BytesIO()
        torch.save(snap, buf)
        payload = buf.getvalue()
        return {"step": snap["step"], "rank": self.rank, "size": self.size,
                "payload": payload, "crc": _crc(payload)}

    def _spill_path(self, src: int, step: int) -> str:
        tag = "own" if src == self.rank else f"peer{src}"
        return os.path.join(self.spill_dir, f"{tag}_{step:010d}.rep")

    def _persist(self, rec: dict, src: int) -> None:
        """Atomic spill write: the bytes to a tmp name, fsync, one
        ``os.replace``; a crash mid-write leaves an ignored tmp file."""
        path = self._spill_path(src, rec["step"])
        head = pickle.dumps(
            {"schema": REPLICATE_SCHEMA, "step": rec["step"], "src": src,
             "size": rec["size"], "crc": rec["crc"],
             "nbytes": len(rec["payload"])},
            protocol=pickle.HIGHEST_PROTOCOL)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            f.write(rec["payload"])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _load_spill(self, src: int, step: int) -> Optional[dict]:
        """Read and validate one spill file; a torn or corrupt file is
        removed and counted, never returned."""
        path = self._spill_path(src, step)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            n = int.from_bytes(blob[:8], "little")
            rec = pickle.loads(blob[8:8 + n])
            rec["payload"] = blob[8 + n:]
            if (rec.get("schema") != REPLICATE_SCHEMA
                    or len(rec["payload"]) != rec["nbytes"]
                    or _crc(rec["payload"]) != rec["crc"]):
                raise ReplicationError("schema/length/crc mismatch")
            return rec
        except FileNotFoundError:
            return None
        except Exception:
            if self._obs_on:
                self._m_torn.inc()
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def _scan_spill(self, digests: bool = False
                    ) -> Dict[int, Dict[int, Tuple[Optional[str], int]]]:
        """``{src: {step: (digest, recorded world size)}}`` over every
        valid spill file (torn ones discarded on sight); the content
        digest (:func:`shard_digest`) is taken only when ``digests``: a
        restore needs it, a cadence does not."""
        out: Dict[int, Dict[int, Tuple[str, int]]] = {}
        try:
            names = sorted(os.listdir(self.spill_dir))
        except OSError:
            return out
        for f in names:
            if not f.endswith(".rep"):
                continue
            tag, _, step_s = f[:-4].rpartition("_")
            src = self.rank if tag == "own" else int(tag[4:])
            rec = self._load_spill(src, int(step_s))
            if rec is not None:
                digest = shard_digest(rec["payload"]) if digests else None
                out.setdefault(src, {})[rec["step"]] = (digest,
                                                        int(rec["size"]))
        return out

    def _gc(self) -> None:
        by_src: Dict[str, List[str]] = {}
        try:
            names = sorted(os.listdir(self.spill_dir))
        except OSError:
            return
        for f in names:
            if f.endswith(".rep"):
                by_src.setdefault(f.rsplit("_", 1)[0], []).append(f)
        for files in by_src.values():
            for stale in files[: -self.keep]:
                try:
                    os.unlink(os.path.join(self.spill_dir, stale))
                except OSError:
                    pass

    # ------------------------------------------------------------ cadence
    def _fire(self, trainer) -> None:
        t0 = time.perf_counter()
        snap = self._snapshot(trainer)
        self._buffer = snap  # publish: one reference swap, fully built
        t1 = time.perf_counter()
        # The local spill writes on a thread while the frames travel; the
        # cadence ends when both are on disk.
        join_spill = _in_thread(self._persist, snap, self.rank)
        try:
            self._exchange(snap)
        finally:
            spill_s = join_spill()
        t2 = time.perf_counter()
        self._gc()
        t3 = time.perf_counter()
        self.last_cadence = {"snapshot_s": t1 - t0, "spill_s": spill_s,
                             "exchange_s": t2 - t1, "total_s": t3 - t0,
                             "bytes": len(snap["payload"])}
        if self._obs_on:
            self._m_snapshots.inc()
            self._m_bytes.inc(len(snap["payload"]))
            self._m_ms.observe((t3 - t0) * 1000.0)
            held = sum(1 for f in os.listdir(self.spill_dir)
                       if f.startswith("peer") and f.endswith(".rep"))
            self._m_held.set(held)

    def _exchange(self, snap: dict) -> None:
        """Ship this cadence's snapshot to the ring successors, then take
        the predecessors' frames: the same program order on every rank,
        so the per-source FIFO of the object plane stays unambiguous."""
        if self.factor < 1 or self.comm is None:
            return
        action = (self._injector.hook("replicate")
                  if self._injector is not None else None)
        for k in range(1, self.factor + 1):
            dest = (self.rank + k) % self.size
            seq = self._seq_out.get(dest, 0)
            self._seq_out[dest] = seq + 1
            if action == "drop" and k == 1:
                # Lost on the wire: the seq slot is consumed, so the
                # receiver sees the gap at the next frame.
                continue
            payload = snap["payload"]
            if action == "flip" and k == 1:
                # A torn replica: bytes corrupted after the crc was taken.
                torn = bytearray(payload)
                torn[len(torn) // 2] ^= 0xFF
                payload = bytes(torn)
            self.comm.send_obj(
                {"schema": REPLICATE_SCHEMA, "seq": seq, "kind": "shard",
                 "step": snap["step"], "src": self.rank,
                 "size": snap["size"], "crc": snap["crc"],
                 "payload": payload}, dest)
        for k in range(1, self.factor + 1):
            src = (self.rank - k) % self.size
            frame = _recv_frame(self.comm, src)
            if frame is not None:
                self._accept(frame, src)

    def _accept(self, frame: dict, src: int) -> None:
        """Validate one incoming frame (schema, seq, crc) and persist the
        replica; a bad frame is counted and dropped, never installed."""
        if not isinstance(frame, dict) \
                or frame.get("schema") != REPLICATE_SCHEMA:
            if self._obs_on:
                self._m_torn.inc()
            return
        expect = self._seq_in.get(src, 0)
        seq = int(frame.get("seq", -1))
        if seq != expect:
            # A gap (a dropped frame) or a replay: count it and resume
            # after the newest seq seen.
            if self._obs_on:
                self._m_dropped.inc()
            if seq < expect:
                return
        self._seq_in[src] = seq + 1
        if _crc(frame["payload"]) != frame["crc"]:
            if self._obs_on:
                self._m_torn.inc()
            return
        self._persist({"step": int(frame["step"]), "size": int(frame["size"]),
                       "crc": frame["crc"], "payload": frame["payload"]},
                      int(frame["src"]))

    # ----------------------------------------------------------- preemption
    def flush_local(self, trainer) -> int:
        """The preemption path: persist a snapshot of this iteration
        locally (no collectives, nothing shipped: the peers are leaving
        too), so a SIGTERM between cadences still leaves a restorable
        shard.  Returns the flushed step."""
        snap = self._snapshot(trainer)
        self._buffer = snap
        self._persist(snap, self.rank)
        if self._obs_on:
            self._m_snapshots.inc()
            self._m_bytes.inc(len(snap["payload"]))
        return snap["step"]

    # ------------------------------------------------------------ inventory
    def inventory(self) -> dict:
        """This rank's restore offer: every valid local step (own and held
        replicas) with its digest.  Spill recorded under another world size
        is left out and reported as ``stale_world``."""
        own: Dict[int, str] = {}
        held: Dict[int, Dict[int, str]] = {}
        stale = False
        for src, steps in self._scan_spill(digests=True).items():
            for step, (digest, rec_size) in steps.items():
                if rec_size != self.size:
                    stale = True
                    continue
                if src == self.rank:
                    own[step] = digest
                else:
                    held.setdefault(src, {})[step] = digest
        return {"rank": self.rank, "size": self.size, "own": own,
                "held": held, "stale_world": stale}

    def report(self) -> dict:
        """Flight-recorder provider (key ``"replication"``)."""
        scan = self._scan_spill()
        return {
            "rank": self.rank, "size": self.size, "every": self.every,
            "factor": self.factor, "spill_dir": self.spill_dir,
            "seq_out": dict(self._seq_out), "seq_in": dict(self._seq_in),
            "own_steps": sorted(scan.get(self.rank, {})),
            "held": {src: sorted(steps) for src, steps in scan.items()
                     if src != self.rank},
            "last_restore": self._last_restore,
            "last_cadence": dict(self.last_cadence),
        }


# ---------------------------------------------------------------- negotiation
def pick_quorum(inventories: List[dict], size: int) -> Optional[dict]:
    """The newest step whose every rank's shard is reachable somewhere
    with one agreed digest (a step with conflicting copies is skipped;
    steps recorded under another world size never qualify).  Returns
    ``{"step", "sources": {rank: "local" | holder}, "digests": {rank:
    digest}}`` or ``None``."""
    steps = set()
    for inv in inventories:
        if int(inv.get("size", -1)) == size:
            steps.update(inv.get("own", {}))
        for held in inv.get("held", {}).values():
            steps.update(held)
    for step in sorted(steps, reverse=True):
        sources: Dict[int, Any] = {}
        digests: Dict[int, str] = {}
        ok = True
        for r in range(size):
            copies: List[Tuple[Any, str]] = []
            own = inventories[r].get("own", {})
            if step in own:
                copies.append(("local", own[step]))
            for h in range(size):
                if h == r:
                    continue
                d = inventories[h].get("held", {}).get(r, {}).get(step)
                if d is not None:
                    copies.append((h, d))
            if not copies or len({d for _, d in copies}) != 1:
                ok = False
                break
            sources[r] = copies[0][0]  # local first, else the lowest holder
            digests[r] = copies[0][1]
        if ok:
            return {"step": step, "sources": sources, "digests": digests}
    return None


def _allgather(comm, obj):
    if comm is None or getattr(comm, "size", 1) <= 1:
        return [obj]
    if hasattr(comm, "allgather_obj"):
        return comm.allgather_obj(obj)
    # The in-process LocalComm rig has no collectives: send to all, then
    # drain with retries (the queues buffer; a silent rank times out).
    out: List[Any] = [None] * comm.size
    out[comm.rank] = obj
    for d in range(comm.size):
        if d != comm.rank:
            comm.send_obj(obj, d)
    deadline = time.monotonic() + 30.0
    for s in range(comm.size):
        if s == comm.rank:
            continue
        while True:
            try:
                out[s] = comm.recv_obj(s)
                break
            except TimeoutError:
                if time.monotonic() > deadline:
                    raise ReplicationError(
                        f"allgather: rank {s} never answered")
                time.sleep(0.001)
    return out


def _recv_payload(comm, src: int) -> Optional[dict]:
    deadline = time.monotonic() + 60.0
    while True:
        try:
            return comm.recv_obj(src)
        except TimeoutError:
            if time.monotonic() > deadline:
                return None
            time.sleep(0.001)


def negotiate_restore(replicator: ShardReplicator, state, trainer=None,
                      checkpointer=None, elastic=None
                      ) -> Tuple[Any, int, dict]:
    """Survivor-assisted fast restore, collective over the replicator's
    comm; run it on a supervised relaunch before any other restore.

    Inventories are allgathered, :func:`pick_quorum` names the step (the
    same on every rank), holders serve missing shards point to point
    (digest checked on arrival), each rank decodes its shard and checks
    it against its live state's structure, and a confirmation allgather
    gates the install: a failed transfer can never leave a partial
    install.  The install copies into ``state``'s own tensors, then
    applies the loop state.  A decline falls back to
    ``checkpointer.maybe_load``, or to ``elastic()`` (a zero-argument
    callable around ``maybe_load_elastic``) when the world size changed,
    each counted on ``train.rep.fallback``.

    Returns ``(state, iteration, report)``; ``report["source"]`` is this
    rank's restore source: ``"peer"``, ``"local"``, ``"orbax"`` (the
    checkpoint tier, named as in the JAX package) or ``"none"``."""
    t0 = time.perf_counter()
    comm = replicator.comm
    size = replicator.size
    rank = replicator.rank
    obs_on = _obs.enabled()
    reg = _omet.registry() if obs_on else None

    def _finish(report: dict) -> None:
        if obs_on:
            reg.counter(f"train.rep.restore.{report['source']}").inc()
            reg.gauge("train.recovery_ms").set(report["recovery_ms"])
            if report.get("lost_steps") is not None:
                reg.gauge("train.lost_steps").set(report["lost_steps"])
                reg.gauge("train.rep.lost_steps_excess").set(
                    max(0, report["lost_steps"] - replicator.every))
        replicator._last_restore = report
        sys.stderr.write(
            "[chainermn_tpu_torch.resilience] restore: "
            f"restore_source={report['source']} step={report['step']} "
            f"recovery_ms={report['recovery_ms']:.1f} "
            f"lost_steps={report['lost_steps']}"
            + (f" reason={report['reason']}" if report.get("reason") else "")
            + "\n")
        sys.stderr.flush()

    def _fallback(reason: str) -> Tuple[Any, int, dict]:
        if obs_on:
            reg.counter("train.rep.fallback").inc()
        new_state, it, source = state, 0, "none"
        if reason == "world-size-changed" and elastic is not None:
            new_state, it = elastic()
            source = "orbax"
        elif checkpointer is not None:
            new_state, it = checkpointer.maybe_load(new_state, trainer)
            source = "orbax"
        report = {"source": source, "step": int(it), "reason": reason,
                  "recovery_ms": (time.perf_counter() - t0) * 1000.0,
                  "lost_steps": None}
        _finish(report)
        return new_state, int(it), report

    invs = _allgather(comm, replicator.inventory())
    if len(invs) != size:
        return _fallback("inventory-incomplete")
    newest_anywhere = max(
        [s for i in invs for s in i.get("own", {})]
        + [s for i in invs for h in i.get("held", {}).values() for s in h],
        default=None)
    plan = pick_quorum(invs, size)
    if plan is None:
        if any(i.get("stale_world") for i in invs):
            return _fallback("world-size-changed")
        return _fallback("no-quorum")

    step = plan["step"]
    if any(src != "local" for src in plan["sources"].values()) \
            and hasattr(comm, "connect_object_plane"):
        # Only holders and needers exchange shards below; every rank
        # joins the object plane's mesh first.
        comm.connect_object_plane()
    my_rec, my_source, ok = None, None, True
    if plan["sources"][rank] == "local":
        my_rec = replicator._load_spill(rank, step)
        ok = my_rec is not None
        my_source = "local"
    # Missing shards served point to point, in the needing rank's order.
    for r in range(size):
        holder = plan["sources"][r]
        if holder == "local":
            continue
        if rank == holder:
            rec = replicator._load_spill(r, step)
            comm.send_obj(
                None if rec is None else
                {"schema": REPLICATE_SCHEMA, "kind": "serve", "step": step,
                 "src": r, "crc": rec["crc"], "payload": rec["payload"]}, r)
        elif rank == r:
            frame = _recv_payload(comm, holder)
            if (frame is None or frame.get("schema") != REPLICATE_SCHEMA
                    or _crc(frame["payload"]) != frame["crc"]
                    or shard_digest(frame["payload"])
                    != plan["digests"][r]):
                if obs_on and frame is not None:
                    reg.counter("train.rep.torn").inc()
                ok = False
            else:
                my_rec = {"payload": frame["payload"]}
                my_source = "peer"
    # Decode and check the structure before the confirmation, so a
    # mismatch on any rank aborts every rank's install.
    snap = None
    if ok and my_rec is not None:
        try:
            snap = torch.load(io.BytesIO(my_rec["payload"]),
                              map_location="cpu", weights_only=False)
            if (snap.get("schema") != REPLICATE_SCHEMA
                    or snap.get("structure") != _state_structure(state)):
                ok = False
        except Exception:
            ok = False
    else:
        ok = False
    if not all(_allgather(comm, bool(ok))):
        return _fallback("transfer-or-structure-mismatch")

    from chainermn_tpu_torch.extensions.checkpoint import (
        apply_loop_state,
        restore_payload,
    )

    restore_payload(state, snap["state"])
    apply_loop_state(trainer, snap["loop"])
    it = int(np.asarray(snap["loop"]["iteration"]))
    lost = int(newest_anywhere - step) if newest_anywhere is not None else 0
    report = {"source": my_source, "step": step, "reason": None,
              "recovery_ms": (time.perf_counter() - t0) * 1000.0,
              "lost_steps": lost}
    _finish(report)
    return state, it, report


def should_negotiate() -> bool:
    """True on a supervised relaunch (``CMN_LAUNCH_ATTEMPT`` > 0), the
    only time :func:`negotiate_restore` has something to negotiate."""
    return int(os.environ.get("CMN_LAUNCH_ATTEMPT", "0")) > 0


# ------------------------------------------------------------- chaos harness
def chaos_schedule(seed: int, failures: int = 2, target_step: int = 24,
                   cadence: int = 4,
                   kinds: Tuple[str, ...] = ("crash", "preempt")) -> dict:
    """A seeded schedule of training-plane failures, one per attempt,
    drawn from ``kinds`` (``crash``: ``crash@iter``; ``preempt``: a
    SIGTERM; ``torn``: ``flip@replicate``), with at least one crash.
    Event iterations fall after the first cadence and before the target,
    so every failure has a snapshot behind it and work ahead of it."""
    if failures < 1:
        raise ValueError("a chaos schedule needs at least one failure")
    if target_step <= cadence + 1:
        raise ValueError(
            f"target_step={target_step} leaves no room after the first "
            f"replication cadence ({cadence})")
    rng = random.Random(seed)
    events = [{"kind": rng.choice(kinds),
               "iter": rng.randint(cadence + 1, target_step - 1)}
              for _ in range(failures)]
    if not any(e["kind"] == "crash" for e in events):
        events[rng.randrange(len(events))]["kind"] = "crash"
    return {"seed": seed, "events": events, "target_step": target_step,
            "cadence": cadence}


class TrainingChaosHarness:
    """Drives a training job to its target step through a seeded failure
    schedule, one supervised attempt at a time, with goodput accounting.

    ``run_attempt(attempt, event)`` runs one attempt (in process, or a
    ``launch.supervise``-shaped adapter) under ``event`` (``None``: no
    fault; else ``{"kind", "iter"}``) and returns at least ``rc`` (0: the
    target was reached), ``final_step`` and, on a relaunch,
    ``restored_step`` / ``restore_source`` / ``recovery_ms``.
    :meth:`verify` checks the invariant: the run reached the target, its
    final digest is the oracle's, and each failure lost at most one
    cadence (its final step minus the next attempt's restored step).
    """

    def __init__(self, run_attempt: Callable[[int, Optional[dict]], dict],
                 schedule: dict, max_attempts: Optional[int] = None):
        self.run_attempt = run_attempt
        self.schedule = schedule
        self.max_attempts = (max_attempts if max_attempts is not None
                             else len(schedule["events"]) + 2)

    def run(self) -> dict:
        events = list(self.schedule["events"])
        target = int(self.schedule["target_step"])
        t0 = time.perf_counter()
        attempts: List[dict] = []
        lost_per_failure: List[int] = []
        recovery_ms: List[float] = []
        total_steps = 0
        completed = False
        prev_final = None
        for attempt in range(self.max_attempts):
            event = events[attempt] if attempt < len(events) else None
            res = dict(self.run_attempt(attempt, event) or {})
            res["attempt"] = attempt
            res["event"] = event
            attempts.append(res)
            final = int(res.get("final_step", 0))
            restored = int(res.get("restored_step", 0))
            total_steps += max(0, final - restored)
            if attempt > 0 and prev_final is not None:
                lost_per_failure.append(max(0, prev_final - restored))
            if res.get("recovery_ms") is not None:
                recovery_ms.append(float(res["recovery_ms"]))
            prev_final = final
            if int(res.get("rc", 1)) == 0:
                completed = True
                break
        wall_s = time.perf_counter() - t0
        return {
            "seed": self.schedule["seed"],
            "cadence": int(self.schedule["cadence"]),
            "target_step": target,
            "completed": completed,
            "attempts": attempts,
            "final_digest": attempts[-1].get("digest") if attempts else None,
            "useful_steps": target if completed else 0,
            "total_steps_executed": total_steps,
            "lost_steps_per_failure": lost_per_failure,
            "recovery_ms": recovery_ms,
            "wall_s": wall_s,
            "goodput_steps_per_s": ((target / wall_s)
                                    if completed and wall_s > 0 else 0.0),
        }

    @staticmethod
    def verify(result: dict, oracle_digest: Optional[str] = None) -> dict:
        """The per-run invariant, itemized."""
        failures = []
        if not result["completed"]:
            failures.append("run never reached the target step")
        if oracle_digest is not None \
                and result.get("final_digest") != oracle_digest:
            failures.append(
                f"final digest {result.get('final_digest')} != oracle "
                f"{oracle_digest} (resume was not bit-exact)")
        cadence = int(result["cadence"])
        for i, lost in enumerate(result["lost_steps_per_failure"]):
            if lost > cadence:
                failures.append(
                    f"failure {i} lost {lost} steps > one replication "
                    f"cadence ({cadence})")
        return {"holds": not failures, "failures": failures}


__all__ = [
    "REPLICATE_SCHEMA",
    "ReplicationError",
    "ShardReplicator",
    "TrainingChaosHarness",
    "chaos_schedule",
    "negotiate_restore",
    "pick_quorum",
    "shard_digest",
    "should_negotiate",
]
