"""The training-health guard of the port (``chainermn_tpu/resilience/
guard.py``): detect fail-silent and fail-slow faults.

The fail-stop machinery (the failure detector, the launcher's restarts)
knows whether a job is alive.  :class:`TrainingHealthGuard` checks that it
is healthy, with three mechanisms:

1. **Step anomaly detection**, inside the train step
   (``make_train_step(health_check=True)``): the verdict over the ranks'
   mean loss and the reduced gradients' norm, values every rank holds
   alike, makes a poisoned step a no-op on the card with no host read (a
   captured step keeps its graph).  The guard reads the verdict every
   ``check_every`` iterations, counts skips and escalates past a budget
   of consecutive ones.
2. **Consistency voting** (:mod:`~chainermn_tpu_torch.resilience.
   consistency`): every ``vote_every`` iterations the ranks' parameter
   digests cross the object plane and a majority vote names a diverged
   rank (:class:`~chainermn_tpu_torch.resilience.consistency.
   RankDivergedError`).
3. **Rollback**: a clean vote blesses the checkpointer's snapshots up to
   that iteration as known-good; an escalation (skip budget spent,
   divergence, no majority) rolls every rank back to the newest
   known-good snapshot in-process and the run resumes.  When no snapshot
   is known-good or the rollback budget is spent, the guard exits with
   :data:`HEALTH_EXIT_CODE` (76), which
   :func:`~chainermn_tpu_torch.launch.supervise` counts against its own
   ``health_restarts`` allowance.

And **straggler surfacing**: each rank's step-time statistics ride the
failure detector's beats, and a rank whose mean step exceeds
``straggler_factor`` times the fleet median is named.

Every verdict the guard acts on is the same on every rank (the in-step
verdict comes from reduced values, the vote from gathered digests), so
escalations and rollbacks happen together without an agreement protocol.
``CMN_FAULT``'s fail-silent kinds (``nan@grad:N``, ``spike@loss:N``,
``flip@param:N``, ``skew@step:N:ms``) inject at the trainer's hook points.
"""

from __future__ import annotations

import contextlib
import sys
from collections import deque
from typing import Dict, List, Optional

from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability import flight as _oflight
from chainermn_tpu_torch.observability import metrics as _omet
from chainermn_tpu_torch.observability import tracing as _otrace
from chainermn_tpu_torch.resilience import consistency as _consistency
from chainermn_tpu_torch.resilience.consistency import RankDivergedError

#: BSD ``EX_PROTOCOL``: the run broke the training-health protocol and
#: could not heal by rollback.  Apart from 75 (preemption) and crash
#: codes: ``launch.supervise`` gives it its own allowance.
HEALTH_EXIT_CODE = 76


class HealthEscalationInterrupt(SystemExit):
    """Raised when the guard cannot recover in-process (no known-good
    snapshot, or the rollback budget is spent): a ``SystemExit`` with
    :data:`HEALTH_EXIT_CODE`, which bypasses the crash hook and reaches
    ``launch.supervise`` as a health exit."""

    def __init__(self, reason: str, iteration: int):
        super().__init__(HEALTH_EXIT_CODE)
        self.reason = reason
        self.iteration = int(iteration)


class TrainingHealthGuard:
    """The per-step training-health monitor, wired through the Trainer
    (``Trainer(health_guard=...)``).

    Args:
      comm: the communicator of the digest vote (anything with ``rank``,
        ``size`` and ``allgather_obj``); None: no vote (one process).
      checkpointer: the :class:`~chainermn_tpu_torch.extensions.
        MultiNodeCheckpointer` holding the known-good ring; None: the
        trainer's extensions are searched when one is needed.
      detector: a :class:`~chainermn_tpu_torch.resilience.detector.
        FailureDetector` (or anything with ``set_local_stats`` and
        ``peer_stats``): step-time statistics ride its beats and feed the
        straggler check.
      skip_budget: consecutive skipped steps tolerated before escalating.
      check_every: read the in-step verdict every N iterations (a read
        waits for the step).
      vote_every: vote cadence in iterations (0: off); the vote is a
        collective, so the cadence is the same on every rank.
      rollback_budget: in-process rollbacks before exiting 76.
      straggler_factor, stats_every, stats_window: the straggler check.
      spike_factor, spike_warmup, spike_ema_beta: the in-step spike test
        (see ``make_train_step``).
      health_check: False keeps the votes and statistics without the
        in-step check.
    """

    def __init__(self, comm=None, checkpointer=None, detector=None,
                 skip_budget: int = 3, check_every: int = 1,
                 vote_every: int = 0, rollback_budget: int = 2,
                 straggler_factor: float = 3.0, stats_every: int = 20,
                 spike_factor: float = 10.0, spike_warmup: int = 20,
                 spike_ema_beta: float = 0.1, stats_window: int = 100,
                 health_check: bool = True, history_limit: int = 200):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if vote_every < 0:
            raise ValueError(f"vote_every must be >= 0, got {vote_every}")
        if stats_every < 1:
            raise ValueError(f"stats_every must be >= 1, got {stats_every}")
        self.comm = comm
        self.checkpointer = checkpointer
        self.detector = detector
        self.skip_budget = int(skip_budget)
        self.check_every = int(check_every)
        self.vote_every = int(vote_every)
        self.rollback_budget = int(rollback_budget)
        self.straggler_factor = float(straggler_factor)
        self.stats_every = int(stats_every)
        self.spike_factor = float(spike_factor)
        self.spike_warmup = int(spike_warmup)
        self.spike_ema_beta = float(spike_ema_beta)
        self.health_check = bool(health_check)
        self._history_limit = int(history_limit)
        self._consecutive_skips = 0
        self._total_skips = 0
        self._skip_steps: List[int] = []
        self._votes: List[dict] = []
        self._rollbacks: List[dict] = []
        self._stragglers: Dict[int, dict] = {}
        self._step_times = deque(maxlen=int(stats_window))
        self._steps_timed = 0
        self.last_divergence: Optional[RankDivergedError] = None
        # The counters also live in the shared registry, and the report
        # joins every flight record.
        self._obs_on = _obs.enabled()
        if self._obs_on:
            reg = _omet.registry()
            self._m_skips = reg.counter("guard.skips")
            self._m_votes = reg.counter("guard.votes")
            self._m_votes_dirty = reg.counter("guard.votes_dirty")
            self._m_rollbacks = reg.counter("guard.rollbacks")
            self._m_consecutive = reg.gauge("guard.consecutive_skips")
            _oflight.register_provider("guard_report", self.guard_report)

    # ------------------------------------------------------------------ wire
    @property
    def rank(self) -> int:
        return getattr(self.comm, "rank", 0) if self.comm is not None else 0

    def step_kwargs(self) -> dict:
        """The ``make_train_step``/``update`` options the Trainer merges
        in at :meth:`bind`."""
        if not self.health_check:
            return {}
        return {"health_check": True, "spike_factor": self.spike_factor,
                "spike_warmup": self.spike_warmup,
                "spike_ema_beta": self.spike_ema_beta}

    def bind(self, trainer) -> "TrainingHealthGuard":
        """Wire into a Trainer: merge the in-step check's options into its
        step options and seed the state's health carry.  The check needs
        the replicated-state tier; the ZeRO tier (a subclass here, a class
        of its own in the JAX package) is refused, as there."""
        if self.health_check:
            from chainermn_tpu_torch.optimizers import (
                MultiNodeOptimizer,
                ZeroMultiNodeOptimizer,
                seed_health,
            )

            opt = trainer.optimizer
            if not isinstance(opt, MultiNodeOptimizer) or \
                    isinstance(opt, ZeroMultiNodeOptimizer):
                raise TypeError(
                    "health_check=True requires the replicated-state "
                    f"MultiNodeOptimizer tier, got {type(opt).__name__}; "
                    "construct the guard with health_check=False to keep "
                    "voting/stats")
            trainer.step_kwargs.update(self.step_kwargs())
            seed_health(trainer.state)
        return self

    # ------------------------------------------------------------- per step
    def post_step(self, trainer, metrics: dict, step_time_s: float) -> None:
        """Called by the trainer after every iteration, after the
        extensions (a snapshot taken this iteration exists before the
        vote that may bless it)."""
        it = int(trainer.iteration)
        self._note_step_time(it, step_time_s)
        if self.health_check and it % self.check_every == 0 \
                and "step_ok" in metrics:
            self._check_verdict(trainer, metrics, it)
        if self.vote_every and it % self.vote_every == 0:
            self._vote(trainer, it)
        if self.detector is not None and it % self.stats_every == 0:
            self._check_stragglers(it)

    # ------------------------------------------------- step anomaly verdict
    def _check_verdict(self, trainer, metrics: dict, it: int) -> None:
        ok = float(metrics["step_ok"]) >= 0.5
        if ok:
            self._consecutive_skips = 0
            if self._obs_on:
                self._m_consecutive.set(0)
            return
        self._consecutive_skips += 1
        self._total_skips += 1
        self._skip_steps.append(it)
        if self._obs_on:
            self._m_skips.inc()
            self._m_consecutive.set(self._consecutive_skips)
        del self._skip_steps[:-self._history_limit]
        gnorm = float(metrics.get("grad_norm", float("nan")))
        self._health_line(
            f"step {it} SKIPPED (anomalous loss/grads, grad_norm="
            f"{gnorm:.3g}, consecutive={self._consecutive_skips}/"
            f"{self.skip_budget})")
        if self._consecutive_skips > self.skip_budget:
            self._escalate(
                trainer, f"skip budget exhausted: {self._consecutive_skips} "
                f"consecutive anomalous steps (> {self.skip_budget}) at "
                f"iteration {it}")

    # -------------------------------------------------------------- voting
    def _vote(self, trainer, it: int) -> None:
        with (_otrace.tracer().span("guard_vote", detail=f"step={it}")
              if self._obs_on else contextlib.nullcontext()):
            vote = _consistency.exchange_and_vote(
                self.comm, trainer.state.params, it)
        if self._obs_on:
            self._m_votes.inc()
            if not vote.clean:
                self._m_votes_dirty.inc()
        self._votes.append({"step": it, "clean": vote.clean,
                            "divergent": list(vote.divergent),
                            "no_majority": vote.no_majority})
        del self._votes[:-self._history_limit]
        if vote.clean:
            ckpt = self._find_checkpointer(trainer)
            if ckpt is not None:
                ckpt.mark_known_good_upto(it)
            return
        err = RankDivergedError(vote.divergent, it, rank=self.rank,
                                no_majority=vote.no_majority)
        self.last_divergence = err
        self._health_line(f"{vote.describe()} — {err}")
        self._escalate(trainer, str(err))

    # ---------------------------------------------------------- escalation
    def _escalate(self, trainer, reason: str) -> None:
        """Every rank reaches the same decision from the same verdicts:
        roll back if a known-good snapshot and budget remain, else exit
        :data:`HEALTH_EXIT_CODE`."""
        # A critical incident before any recovery: the rollback restores
        # the state and drains the observations, so the view that
        # explains the escalation exists only now.
        if self._obs_on:
            from chainermn_tpu_torch.observability import incident as _oinc

            try:
                _oinc.manager().file_incident(
                    name="health_escalation", severity="critical",
                    plane="resilience",
                    detail=f"iteration {trainer.iteration}: {reason}")
            except Exception:
                pass
        ckpt = self._find_checkpointer(trainer)
        good = ckpt.latest_known_good() if ckpt is not None else None
        if good is not None and len(self._rollbacks) < self.rollback_budget:
            self._rollback(trainer, ckpt, int(good), reason)
            return
        why = ("no known-good snapshot to roll back to" if good is None
               else f"rollback budget ({self.rollback_budget}) exhausted")
        self._health_line(
            f"ESCALATING at iteration {trainer.iteration}: {reason}; {why}; "
            f"exiting {HEALTH_EXIT_CODE}")
        if ckpt is not None and good is not None:
            # Snapshots newer than the last known-good one are suspect:
            # the supervised relaunch must not resume from them.
            try:
                ckpt.discard_after(int(good))
            except Exception:
                pass
        err = HealthEscalationInterrupt(reason, trainer.iteration)
        # The interrupt is a SystemExit, which bypasses the crash hook's
        # snapshot: take the flight record here.
        _oflight.snapshot_on_crash(err)
        raise err

    def _rollback(self, trainer, ckpt, good: int, reason: str) -> None:
        n = len(self._rollbacks) + 1
        at_it = int(trainer.iteration)
        self._health_line(
            f"rollback #{n}/{self.rollback_budget} to known-good step "
            f"{good} (from iteration {at_it}): {reason}")
        # Snapshots newer than the target were taken on possibly poisoned
        # state; the re-run saves those steps again.
        ckpt.discard_after(good)
        # In place: a captured step replays on the state's own tensors.
        ckpt.restore_step(good, trainer.state, trainer)
        trainer.drain_observations()
        self._consecutive_skips = 0
        if self._obs_on:
            self._m_rollbacks.inc()
            self._m_consecutive.set(0)
        self._rollbacks.append({"step": int(good), "at_iteration": at_it,
                                "reason": reason})
        self._health_line(f"resumed at iteration {trainer.iteration} from "
                          f"known-good step {good}")

    # ---------------------------------------------------------- stragglers
    def _note_step_time(self, it: int, dt_s: float) -> None:
        self._step_times.append(float(dt_s))
        self._steps_timed += 1
        if self.detector is not None and \
                hasattr(self.detector, "set_local_stats"):
            self.detector.set_local_stats(self.step_time_stats(it))

    def step_time_stats(self, it: Optional[int] = None) -> dict:
        w = list(self._step_times)
        ms = 1000.0
        return {
            "iteration": int(it if it is not None else self._steps_timed),
            "n": self._steps_timed,
            "last_ms": round(w[-1] * ms, 3) if w else None,
            "mean_ms": round(sum(w) / len(w) * ms, 3) if w else None,
            "max_ms": round(max(w) * ms, 3) if w else None,
        }

    def _check_stragglers(self, it: int) -> None:
        if not hasattr(self.detector, "peer_stats"):
            return
        means = {int(r): s.get("mean_ms")
                 for r, s in self.detector.peer_stats().items()
                 if s.get("mean_ms") is not None}
        if len(means) < 2:
            return
        ordered = sorted(means.values())
        median = ordered[len(ordered) // 2]
        if median <= 0:
            return
        for r, m in sorted(means.items()):
            if m > self.straggler_factor * median:
                self._stragglers[r] = {"step": it, "mean_ms": m,
                                       "median_ms": median}
                self._health_line(
                    f"straggler: rank {r} mean step {m:.1f}ms vs fleet "
                    f"median {median:.1f}ms (> {self.straggler_factor:g}x)")

    # ------------------------------------------------------------- reporting
    def guard_report(self) -> dict:
        """Everything the guard knows, JSON-serializable: skips, votes,
        rollbacks, step-time statistics, stragglers."""
        last = self.last_divergence
        return {
            "rank": self.rank,
            "skips": {"total": self._total_skips,
                      "consecutive": self._consecutive_skips,
                      "budget": self.skip_budget,
                      "steps": list(self._skip_steps)},
            "votes": list(self._votes),
            "rollbacks": {"count": len(self._rollbacks),
                          "budget": self.rollback_budget,
                          "events": list(self._rollbacks)},
            "step_time": self.step_time_stats(),
            "peer_step_time": (self.detector.peer_stats()
                               if hasattr(self.detector, "peer_stats")
                               else {}),
            "stragglers": dict(self._stragglers),
            "last_divergence": (
                {"divergent": last.divergent, "step": last.step,
                 "no_majority": last.no_majority}
                if last is not None else None),
        }

    def finalize(self, trainer) -> None:
        """The run's closing health line, on every rank."""
        r = self.guard_report()
        self._health_line(
            f"report: skips={r['skips']['total']} votes={len(r['votes'])} "
            f"rollbacks={r['rollbacks']['count']} "
            f"mean_step_ms={r['step_time']['mean_ms']} "
            f"stragglers={sorted(r['stragglers'])}")

    def _health_line(self, msg: str) -> None:
        sys.stderr.write(f"[chainermn_tpu_torch.guard] rank {self.rank}: "
                         f"{msg}\n")
        sys.stderr.flush()

    def _find_checkpointer(self, trainer):
        if self.checkpointer is not None:
            return self.checkpointer
        from chainermn_tpu_torch.extensions.checkpoint import (
            MultiNodeCheckpointer,
        )

        for ext in getattr(trainer, "extensions", []):
            if isinstance(ext, MultiNodeCheckpointer):
                return ext
        return None
