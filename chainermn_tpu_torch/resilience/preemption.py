"""Preemption-aware shutdown of the port
(``chainermn_tpu/resilience/preemption.py``): SIGTERM becomes a
checkpoint, not a crash.

A scheduler reclaims a host by sending SIGTERM with seconds of warning.
The :class:`PreemptionGuard` makes that cooperative:

1. the signal only sets a flag: the handler does no I/O, no collectives,
   and touches no tensor (a captured CUDA graph may be replaying);
2. the trainer polls the guard once per iteration, between steps, last
   (after the extensions and the health guard); the poll is a vote across
   the ranks (``allreduce_obj`` max), so every rank learns at the same
   iteration that some rank was signalled;
3. every rank then waits for its card, flushes the peer replicator's
   local snapshot (:mod:`~chainermn_tpu_torch.resilience.replicate`),
   takes one synchronous emergency checkpoint and exits with
   :data:`PREEMPTION_EXIT_CODE`, which ``launch.supervise`` relaunches
   on its own allowance.

The exit travels as :class:`PreemptionInterrupt`, a ``SystemExit``: it
leaves the process with code 75 past the except hook's crash path, and
the exit hook of :mod:`chainermn_tpu_torch.distributed` still ends the
process group (NCCL or gloo), waiting at most its timeout for a peer
that already left.

**Serving ranks** drain instead of checkpointing:
:meth:`PreemptionGuard.attach_drain` registers a handler (a role of
:mod:`chainermn_tpu_torch.serving.disagg`:
``guard.attach_drain(lambda: role.drain(peer))``) and the serving loop
polls :meth:`PreemptionGuard.poll_serving` once per tick: every live
slot and queued entry migrates to the peer, then the rank exits 75.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from typing import Optional

#: BSD ``EX_TEMPFAIL``: "transient failure, retry".  Clear of Python's
#: codes (0/1/2) and of the 128+signum kill encodings.
PREEMPTION_EXIT_CODE = 75


class PreemptionInterrupt(SystemExit):
    """Raised (exiting with :data:`PREEMPTION_EXIT_CODE`) after the
    emergency checkpoint (or the serving drain) landed; ``iteration`` is
    the agreed step (tick) a relaunch resumes at."""

    def __init__(self, iteration: int):
        super().__init__(PREEMPTION_EXIT_CODE)
        self.iteration = int(iteration)


class PreemptionGuard:
    """Cooperative SIGTERM-to-checkpoint conversion for the trainer loop.

    Args:
      comm: communicator of the vote (``allreduce_obj``): a
        :class:`~chainermn_tpu_torch.comm.base.CommunicatorBase` (string
        reduce ops) or a bare :class:`~chainermn_tpu_torch.hostcomm.
        HostComm` (callable ops); ``None`` for one process.
      checkpointer: the :class:`~chainermn_tpu_torch.extensions.
        MultiNodeCheckpointer` of the emergency save; ``None``: the
        trainer's extensions are searched at preemption time.
      signals: the signals that arm the guard (default SIGTERM, what a
        scheduler and ``launch``'s teardown send).
      check_every: vote cadence in iterations, the same on every rank.
    """

    def __init__(self, comm=None, checkpointer=None,
                 signals=(signal.SIGTERM,), check_every: int = 1):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.comm = comm
        self.checkpointer = checkpointer
        self.signals = tuple(signals)
        self.check_every = int(check_every)
        self._flag = threading.Event()
        self._signal_time: Optional[float] = None
        self._prev_handlers = {}
        self._installed = False
        self._drain = None
        self._replicator = None

    # ------------------------------------------------------------- handlers
    def install(self) -> "PreemptionGuard":
        """Install the signal handlers (main thread only)."""
        if self._installed:
            return self
        for sig in self.signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        # A flag and a clock reading, nothing else.  A repeat signal (the
        # launcher's teardown racing the save) is a no-op, which lets the
        # emergency save finish.
        self._signal_time = time.monotonic()
        self._flag.set()

    @property
    def preempted(self) -> bool:
        """This rank's own flag (the vote is what its peers see)."""
        return self._flag.is_set()

    def request(self) -> None:
        """Preempt without a signal (tests; schedulers with an API)."""
        self._signal_time = time.monotonic()
        self._flag.set()

    # ----------------------------------------------------------------- poll
    def _vote(self) -> int:
        local = int(self._flag.is_set())
        comm = self.comm
        if comm is None or getattr(comm, "size", 1) <= 1:
            return local
        from chainermn_tpu_torch.comm.base import CommunicatorBase

        if isinstance(comm, CommunicatorBase):
            return int(comm.allreduce_obj(local, "max"))
        return int(comm.allreduce_obj(local, lambda a, b: max(a, b)))

    def poll(self, trainer) -> None:
        """The trainer's per-iteration call: a vote every ``check_every``
        iterations; when any rank was signalled, the replicator's local
        flush, the emergency checkpoint and :class:`PreemptionInterrupt`.
        """
        if trainer.iteration % self.check_every != 0:
            return
        if not self._vote():
            return
        it = int(trainer.iteration)
        # The emergency copies start after the last replay wrote the state.
        from chainermn_tpu_torch.extensions.checkpoint import sync_state

        sync_state(getattr(trainer, "state", None))
        # The replication flush first: a local write, no collectives, so
        # a SIGKILL during the slower checkpoint below still leaves a
        # restorable local shard at this iteration.
        rep = self._replicator or self._find_replicator(trainer)
        if rep is not None:
            try:
                rep.flush_local(trainer)
            except Exception as e:  # the checkpoint must still run
                sys.stderr.write(
                    "[chainermn_tpu_torch.resilience] preemption: "
                    f"replication flush failed ({type(e).__name__}: {e}); "
                    "continuing to the emergency checkpoint\n")
        ckpt = self.checkpointer or self._find_checkpointer(trainer)
        if ckpt is not None:
            ckpt.emergency_save(trainer)
        self._exit_preempted(it, f"emergency checkpoint at iteration {it}")

    def _exit_preempted(self, n: int, action: str) -> None:
        """The exit-75 tail of :meth:`poll` and :meth:`poll_serving`: the
        notice on stderr, the ``preemption_exit`` flight record, then
        :class:`PreemptionInterrupt`."""
        waited = (f" {time.monotonic() - self._signal_time:.2f}s after "
                  "signal" if self._signal_time is not None
                  else " (peer-initiated)")
        sys.stderr.write(
            f"[chainermn_tpu_torch.resilience] preemption: {action}"
            f"{waited}; exiting {PREEMPTION_EXIT_CODE}\n")
        sys.stderr.flush()
        err = PreemptionInterrupt(n)
        # A SystemExit bypasses the except hook's crash snapshot.
        from chainermn_tpu_torch.observability import flight as _oflight

        _oflight.snapshot_on_crash(err)
        raise err

    # -------------------------------------------------------------- serving
    def attach_drain(self, handler) -> None:
        """Register the serving drain: a zero-argument callable returning
        a summary dict, run once by :meth:`poll_serving` before exit 75
        (its summary lands on stderr and in the flight record)."""
        self._drain = handler

    def poll_serving(self, tick: int) -> None:
        """The serving loop's :meth:`poll`, once per scheduler tick: on
        preemption the attached drain moves every live slot and queued
        entry to the peer, then :class:`PreemptionInterrupt`.  Serving
        guards take ``comm=None``: a drain is per rank (only the
        signalled host hands its work off), and a vote on the migration
        plane's comm would interleave with its frames."""
        if tick % self.check_every != 0:
            return
        if not self._vote():
            return
        action = f"serving drain at tick {tick}"
        if self._drain is not None:
            # Best effort: a peer taken down too loses the migration, but
            # the exit-code contract with the launcher still holds.
            try:
                action += f" - migrated {self._drain()}"
            except Exception as e:
                action += (f" FAILED ({type(e).__name__}: {e}) - exiting "
                           "without migrating")
        self._exit_preempted(tick, action)

    def attach_replicator(self, replicator) -> None:
        """Pin the :class:`~chainermn_tpu_torch.resilience.replicate.
        ShardReplicator` whose snapshot :meth:`poll` flushes before the
        emergency save (default: the trainer's, found at preemption
        time)."""
        self._replicator = replicator

    @staticmethod
    def _find_checkpointer(trainer):
        from chainermn_tpu_torch.extensions.checkpoint import (
            MultiNodeCheckpointer,
        )

        for ext in getattr(trainer, "extensions", []):
            if isinstance(ext, MultiNodeCheckpointer):
                return ext
        return None

    @staticmethod
    def _find_replicator(trainer):
        from chainermn_tpu_torch.resilience.replicate import ShardReplicator

        for ext in getattr(trainer, "extensions", []):
            if isinstance(ext, ShardReplicator):
                return ext
        return None


__all__ = ["PREEMPTION_EXIT_CODE", "PreemptionGuard", "PreemptionInterrupt"]
