"""The trainer loop of the port: ``chainermn_tpu/training/__init__.py``.

The reference delegates its loop to Chainer's ``Trainer``/
``StandardUpdater`` (SURVEY.md §3.2); its examples attach ``LogReport``/
``PrintReport``/``ProgressBar`` on rank 0 only.  Here, as in the JAX
package: a :class:`Trainer` driving ``optimizer.update`` over an
epoch-aware iterator, interval-triggered extensions (``(n, "epoch")`` or
``(n, "iteration")``, firing at the same ticks as the JAX loop) and
rank-0 reporting.

The hot loop never waits on the card: a step's metrics stay device
tensors in the trainer's observation window (each step's its own copy,
also when the step replays a captured graph whose metric buffers the next
replay rewrites), and :class:`LogReport` and :class:`MetricsReport`
convert them only when they fire.  Under the captured step the fault
hooks keep their meaning: ``poison_batch`` acts on the batch before it is
copied into the graph's static buffers, and ``corrupt_params`` writes the
parameters, which are the graph's own, in place.  The
``train.step_ms`` histogram times the host's dispatch of the step, as in
the JAX package.  Each step runs inside
:func:`~chainermn_tpu_torch.observability.step_annotation`, a
``torch.profiler`` range named for the step.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability import aggregate as _oagg
from chainermn_tpu_torch.observability import flight as _oflight
from chainermn_tpu_torch.observability import metrics as _omet
from chainermn_tpu_torch.observability import tracing as _otrace
from chainermn_tpu_torch.resilience import faults as _faults

__all__ = ["Extension", "LogReport", "MetricsReport", "PrintReport",
           "ProgressBar", "Trainer", "make_extension"]

#: True while a ProgressBar \r-line is open on stderr; printers of full
#: lines (LogReport) break the line first so output never interleaves.
_progress_line_open = False


def _close_progress_line():
    global _progress_line_open
    if _progress_line_open:
        print(file=sys.stderr, flush=True)
        _progress_line_open = False


def _rank(trainer) -> int:
    comm = getattr(trainer.optimizer, "comm", None)
    return int(getattr(comm, "rank", 0)) if comm is not None else 0


def _to_float(v) -> float:
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().mean().item())
    return float(np.mean(np.asarray(v, dtype=np.float64)))


class Extension:
    """An interval-triggered trainer hook (Chainer extension analog)."""

    def __init__(self, fn: Callable, trigger: Tuple[int, str] = (1, "epoch"),
                 name: Optional[str] = None):
        self.fn = fn
        self.interval, self.unit = trigger
        assert self.unit in ("epoch", "iteration")
        self.name = name or getattr(fn, "__name__", "extension")
        self._last_fired = 0

    def should_fire(self, trainer: "Trainer") -> bool:
        tick = trainer.epoch if self.unit == "epoch" else trainer.iteration
        if tick // self.interval > self._last_fired // self.interval:
            self._last_fired = tick
            return True
        return False

    def __call__(self, trainer: "Trainer"):
        return self.fn(trainer)

    def finalize(self, trainer: "Trainer"):
        """Called once when training ends; default no-op (LogReport flushes
        its pending window here so a mid-epoch stop still reports)."""


def make_extension(trigger=(1, "epoch"), name=None):
    def deco(fn):
        return Extension(fn, trigger=trigger, name=name)
    return deco


class LogReport(Extension):
    """Collects metric means per interval; prints and records on rank 0
    only.  The window's device tensors are converted here, at the trigger:
    one stack and one copy to the host per metric."""

    def __init__(self, trigger=(1, "epoch"), out: Optional[str] = None,
                 print_report: bool = True):
        super().__init__(self._fire, trigger=trigger, name="LogReport")
        self.log: List[dict] = []
        self._out = out
        self._print = print_report
        self._t0 = time.time()

    @staticmethod
    def _mean(values) -> float:
        if values and all(isinstance(v, torch.Tensor) for v in values):
            vals = torch.stack([v.detach().float().reshape(()) for v in
                                values]).cpu().numpy()
            return float(np.mean(vals))
        return float(np.mean([_to_float(v) for v in values]))

    def _fire(self, trainer: "Trainer"):
        window = trainer.drain_observations()
        if not window:
            return
        means = {k: self._mean([o[k] for o in window if k in o])
                 for k in window[-1]}
        entry = {
            "epoch": trainer.epoch,
            "iteration": trainer.iteration,
            "elapsed_time": time.time() - self._t0,
            **means,
        }
        self.log.append(entry)
        self._report(means, entry, _rank(trainer))

    def finalize(self, trainer: "Trainer"):
        self._fire(trainer)

    def _report(self, means, entry, rank):
        if rank == 0:
            if self._print:
                _close_progress_line()
                parts = [f"epoch {entry['epoch']}",
                         f"iter {entry['iteration']}"]
                parts += [f"{k} {v:.4f}" for k, v in means.items()]
                print("  ".join(parts), flush=True)
            if self._out:
                os.makedirs(os.path.dirname(self._out) or ".", exist_ok=True)
                with open(self._out, "w") as f:
                    json.dump(self.log, f, indent=1)


class MetricsReport(Extension):
    """Observability counterpart of :class:`LogReport`: each tick it
    converts the trainer's newest metrics to floats and sets them as
    ``train.<name>`` gauges, samples the device memory watermarks
    (``mem.*``, with ``memory=True``), takes a stamped registry sample,
    appends ``{"step", "rank", "metrics", "registry"}`` to
    ``<out_dir>/metrics.rank<R>.jsonl`` and, with a communicator,
    gathers every rank's entry to rank 0's merged feed
    (:class:`~chainermn_tpu_torch.observability.aggregate.
    MetricsAggregator`); then it evaluates the incident manager's watch
    rules.  The gather is a collective: attach it with the same trigger on
    every rank.  ``CMN_OBS=0`` makes it a no-op (set it for the job,
    never for a subset of ranks).

    ``device=True`` publishes the train step's ``device.train_step.*``
    gauges each tick (achieved TFLOP/s, arithmetic intensity, and MFU and
    the roofline gap where the card has a peak in
    :data:`~chainermn_tpu_torch.observability.device.PEAK_BF16_FLOPS`;
    none on the CPU) from the watch's cost model of the step (one eager
    forward and backward under ``FlopCounterMode`` the first time, plus
    the analytic work of the hand-written attention kernels) and the
    step's wall time.  The cost model counts what the step executes, a
    rematerialized block's recomputed forward included, as the JAX
    package's compiled cost analysis does: with remat on, ``mfu_pct`` is
    a hardware-FLOPs utilization, above the model-FLOPs one (6·N·T plus
    the attention core).  The wall time: the card synchronized at each
    tick, the time since
    the previous tick over the iterations between them (the first tick
    sets the mark; ``train.step_ms`` times only the host's dispatch of a
    captured replay).  ``fleet_trace=<path>`` syncs a
    :class:`~chainermn_tpu_torch.observability.fleet.FleetClock` on the
    first tick and every ``fleet_resync`` ticks (``fleet_probes`` probes
    a peer), notes it on the incident manager (the bundles' ``clock``),
    and at :meth:`finalize` gathers every rank's span ring into one
    offset-corrected merged trace at that path.  Both are collectives on
    the extension's own cadence."""

    def __init__(self, comm=None, trigger=(10, "iteration"),
                 out_dir: str = "obs", prometheus: bool = False,
                 aggregate: bool = True, memory: bool = True,
                 device: bool = False, fleet_trace: Optional[str] = None,
                 fleet_probes: int = 8, fleet_resync: int = 64):
        super().__init__(self._fire, trigger=trigger, name="MetricsReport")
        self.comm = comm
        self.out_dir = out_dir
        self._rank = int(getattr(comm, "rank", 0)) if comm is not None \
            else 0
        self._agg = (_oagg.MetricsAggregator(comm, out_dir=out_dir,
                                             prometheus=prometheus)
                     if aggregate else None)
        self._last_step: Optional[int] = None
        self._memory = bool(memory)
        self._mem_monitor = None
        self._device = bool(device)
        #: (wall clock, iteration) at the previous tick, card synchronized.
        self._dev_mark: Optional[Tuple[float, int]] = None
        #: the newest roofline published (``device=True``).
        self.last_roofline: Optional[dict] = None
        self.fleet_trace = fleet_trace
        self._fleet_probes = int(fleet_probes)
        self._fleet_resync = max(int(fleet_resync), 1)
        self._fleet_clock = None
        self._fires = 0
        #: the merged trace's summary (rank 0, after finalize).
        self.fleet_summary: Optional[dict] = None

    @property
    def rank_path(self) -> str:
        return os.path.join(self.out_dir, f"metrics.rank{self._rank}.jsonl")

    def _fire(self, trainer: "Trainer"):
        if not _obs.enabled():
            return
        it = int(trainer.iteration)
        if it == self._last_step:  # finalize after an on-trigger last step
            return
        self._last_step = it
        self._fires += 1
        if self.fleet_trace is not None and (
                self._fleet_clock is None
                or self._fires % self._fleet_resync == 0):
            from chainermn_tpu_torch.observability import fleet as _ofleet

            if self._fleet_clock is None:
                self._fleet_clock = _ofleet.FleetClock(
                    self.comm, probes=self._fleet_probes)
            self._fleet_clock.sync()
        if self._memory:
            if self._mem_monitor is None:
                from chainermn_tpu_torch.observability import memory as _omem

                self._mem_monitor = _omem.MemoryMonitor()
            self._mem_monitor.sample()
        if self._device:
            self._publish_device_gauges(trainer)
        means = {}
        if trainer.last_metrics is not None:
            for k, v in trainer.last_metrics.items():
                try:
                    means[k] = _to_float(v)
                except (TypeError, ValueError):
                    continue
        reg = _omet.registry()
        for k, v in means.items():
            reg.gauge(f"train.{k}").set(v)
        sample = reg.sample(it)
        entry = {"step": it, "rank": self._rank, "metrics": means,
                 "registry": sample["metrics"]}
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.rank_path, "a") as f:
            f.write(json.dumps(_oagg.sanitize_json(entry)) + "\n")
        if self._agg is not None:
            self._agg.collect(it, entry)
        from chainermn_tpu_torch.observability import incident as _oincident

        mgr = _oincident.manager()
        if self._fleet_clock is not None:
            mgr.note_fleet_clock(self._fleet_clock)
        mgr.evaluate()

    def _publish_device_gauges(self, trainer: "Trainer") -> None:
        """``device.train_step.*`` from the newest captured (or eager)
        ``train_step`` program's cost model and the synchronized wall
        time per iteration since the previous tick."""
        from chainermn_tpu_torch.extensions.checkpoint import sync_state
        from chainermn_tpu_torch.observability import device as _odevice

        def now():
            sync_state(trainer.state)
            return time.perf_counter()

        t, it = now(), int(trainer.iteration)
        progs = [wp for wp in _odevice.watch().functions()
                 if wp.program == "train_step" and wp.compiles]
        if self._dev_mark is not None and it > self._dev_mark[1] and progs:
            self.last_roofline = _odevice.watch().publish_roofline(
                progs[-1], (t - self._dev_mark[0]) * 1e3
                / (it - self._dev_mark[1]))
        # Marked after the publish: the cost model's one-time build is in
        # no step's time.
        self._dev_mark = (now(), it)

    def finalize(self, trainer: "Trainer"):
        """Flush a final tick so a stop between triggers still lands the
        closing window (skipped when the last iteration already fired);
        then, with ``fleet_trace``, export the merged fleet trace (a
        collective: every rank reaches finalize at the same loop exit)."""
        self._fire(trainer)
        if self.fleet_trace is not None and _obs.enabled():
            from chainermn_tpu_torch.observability import fleet as _ofleet

            summary = _ofleet.export_fleet_trace(
                self.comm, path=self.fleet_trace, clock=self._fleet_clock,
                probes=self._fleet_probes)
            if summary is not None:
                self.fleet_summary = summary
                _close_progress_line()
                who = summary.get("straggler_rank")
                print(f"[chainermn_tpu_torch.fleet] merged trace -> "
                      f"{summary['path']} ({summary['nranks']} ranks, max "
                      f"skew {summary['max_skew_ms']} ms, straggler "
                      f"{'none' if who is None else f'rank {who}'})",
                      flush=True)


class PrintReport(Extension):
    """Prints a fixed-column table of selected LogReport entries on rank 0
    (reference: Chainer's ``PrintReport``).  Fires whenever the
    trainer's :class:`LogReport` (found automatically, or
    ``log_report=``) holds rows it has not shown, so registration order
    does not matter."""

    def __init__(self, entries: Sequence[str], log_report: "LogReport" = None,
                 trigger=(1, "epoch")):
        super().__init__(self._fire, trigger=trigger, name="PrintReport")
        self._keys = list(entries)
        if not self._keys:
            raise ValueError("PrintReport needs at least one entry key")
        self._log = log_report
        self._shown = 0
        self._header_done = False

    def _find_log(self, trainer: "Trainer") -> Optional["LogReport"]:
        if self._log is not None:
            return self._log
        for ext in trainer.extensions:
            if isinstance(ext, LogReport):
                return ext
        return None

    def should_fire(self, trainer: "Trainer") -> bool:
        log = self._find_log(trainer)
        return log is not None and len(log.log) > self._shown

    def _fire(self, trainer: "Trainer"):
        if _rank(trainer) != 0:
            return
        log = self._find_log(trainer)
        if log is None:
            return
        _close_progress_line()
        width = max(12, max(len(k) for k in self._keys) + 2)
        if not self._header_done:
            print("".join(k.ljust(width) for k in self._keys), flush=True)
            self._header_done = True
        for entry in log.log[self._shown:]:
            cells = []
            for k in self._keys:
                v = entry.get(k, "")
                cells.append((f"{v:.6g}" if isinstance(v, float)
                              else str(v)).ljust(width))
            print("".join(cells), flush=True)
        self._shown = len(log.log)

    def finalize(self, trainer: "Trainer"):
        self._fire(trainer)


class ProgressBar(Extension):
    """Rank-0 progress line with rate and ETA on stderr every
    ``update_interval`` iterations (reference: Chainer's ``ProgressBar``)."""

    def __init__(self, update_interval: int = 10):
        super().__init__(self._fire, trigger=(update_interval, "iteration"),
                         name="ProgressBar")
        self._t0 = time.time()
        self._width = 0

    def _fire(self, trainer: "Trainer"):
        if _rank(trainer) != 0:
            return
        elapsed = time.time() - self._t0
        rate = trainer.iteration / elapsed if elapsed > 0 else 0.0
        total = self._total_iters(trainer)
        if total:
            frac = min(trainer.iteration / total, 1.0)
            bar = "#" * int(frac * 20)
            eta = (total - trainer.iteration) / rate if rate > 0 else 0.0
            msg = (f"[{bar:<20}] {frac:6.1%}  iter {trainer.iteration}"
                   f"  {rate:.2f} it/s  eta {eta:.0f}s")
        else:
            msg = (f"iter {trainer.iteration}  epoch {trainer.epoch}"
                   f"  {rate:.2f} it/s")
        self._width = max(self._width, len(msg))
        print("\r" + msg.ljust(self._width), end="", file=sys.stderr,
              flush=True)
        global _progress_line_open
        _progress_line_open = True

    @staticmethod
    def _total_iters(trainer: "Trainer") -> Optional[int]:
        if trainer.stop_unit == "iteration":
            return trainer.stop_n
        it = trainer.train_iter
        n, bs = getattr(it, "_n", None), getattr(it, "batch_size", None)
        if n and bs:
            return trainer.stop_n * math.ceil(n / bs)
        return None

    def finalize(self, trainer: "Trainer"):
        if _rank(trainer) == 0:
            _close_progress_line()


class Trainer:
    """Drives ``optimizer.update`` over a train iterator.

    Args:
      optimizer: a :class:`~chainermn_tpu_torch.optimizers.
        MultiNodeOptimizer`.
      state: the initial TrainState (from ``optimizer.init``).
      loss_fn: ``loss_fn(model, batch) -> scalar`` (or ``(scalar, aux)``
        with ``has_aux``, or ``(scalar, (aux, model_state))`` with
        ``stateful``).
      train_iter: yields batches, with ``epoch`` bookkeeping.
      stop: ``(n, 'epoch'|'iteration')``.
      step_kwargs: further ``update`` options (``accum_steps``,
        ``augment``, ``augment_seed``, ``capture``: on a CUDA device the
        step is captured as a CUDA graph per batch signature unless
        ``capture=False``).
      health_guard: a :class:`~chainermn_tpu_torch.resilience.guard.
        TrainingHealthGuard`: its in-step check's options merge into
        ``step_kwargs`` and its health carry is seeded on the state at
        construction; after each iteration's extensions it reads the
        verdict, votes, rolls back or exits 76 on its cadences.
      preemption_guard: a :class:`~chainermn_tpu_torch.resilience.
        PreemptionGuard`, polled once per iteration, last (after the
        extensions and the health guard, so a checkpoint this iteration
        makes the emergency save a no-op): SIGTERM becomes a vote, an
        emergency checkpoint and exit 75.

    The loop is a ``CMN_FAULT`` hook point, at the JAX loop's places:
    ``nan@grad:N``/``spike@loss:N`` poison iteration N's batch,
    ``flip@param:N`` corrupts this rank's parameters after update N,
    ``skew@step:N:ms`` stretches every step from N on, ``crash@iter:N``
    raises after iteration N.
    """

    def __init__(self, optimizer, state, loss_fn, train_iter,
                 stop: Tuple[int, str] = (1, "epoch"),
                 extensions: Optional[List[Extension]] = None,
                 has_aux: bool = False, stateful: bool = False,
                 step_kwargs: Optional[dict] = None,
                 preemption_guard=None, health_guard=None):
        self.optimizer = optimizer
        self.state = state
        self.loss_fn = loss_fn
        self.train_iter = train_iter
        self.stop_n, self.stop_unit = stop
        assert self.stop_unit in ("epoch", "iteration")
        self.extensions = list(extensions or [])
        self.has_aux = has_aux
        self.stateful = stateful
        self.step_kwargs = dict(step_kwargs or {})
        self.preemption_guard = preemption_guard
        self._fault_injector = _faults.process_injector()
        self.iteration = 0
        self._observations: List[dict] = []
        #: the newest step's metrics (device tensors, no host sync): what
        #: MetricsReport converts at its own cadence.
        self.last_metrics: Optional[dict] = None
        self._obs_on = _obs.enabled()
        if self._obs_on:
            reg = _omet.registry()
            self._obs_iterations = reg.counter("train.iterations")
            self._obs_step_ms = reg.histogram("train.step_ms")
        # Arm the flight recorder (the SIGUSR1 snapshot handler), governed
        # by its own knobs as in the JAX package.
        _oflight.recorder()
        # Bound last: the guard merges its step options and seeds the
        # health carry of the state set above.
        self.health_guard = health_guard
        if health_guard is not None:
            health_guard.bind(self)

    @property
    def epoch(self) -> int:
        return getattr(self.train_iter, "epoch", 0)

    def extend(self, ext: Extension):
        self.extensions.append(ext)

    def drain_observations(self) -> List[dict]:
        obs, self._observations = self._observations, []
        return obs

    def _done(self) -> bool:
        tick = self.epoch if self.stop_unit == "epoch" else self.iteration
        return tick >= self.stop_n

    def run(self):
        inj = self._fault_injector
        while not self._done():
            t0 = time.perf_counter()
            batch = next(self.train_iter)
            if inj is not None:
                batch = _faults.poison_batch(inj, batch, self.iteration + 1)
            with (_otrace.step_annotation(self.iteration + 1)
                  if self._obs_on else contextlib.nullcontext()):
                self.state, metrics = self.optimizer.update(
                    self.state, batch, self.loss_fn, has_aux=self.has_aux,
                    stateful=self.stateful, **self.step_kwargs)
            self.iteration += 1
            if inj is not None:
                self.state = _faults.corrupt_params(inj, self.state,
                                                    self.iteration)
                inj.hook("step", count=self.iteration)
            self._observations.append(dict(metrics))
            self.last_metrics = dict(metrics)
            if self._obs_on:
                self._obs_iterations.inc()
                self._obs_step_ms.observe(
                    (time.perf_counter() - t0) * 1000.0)
            for ext in self.extensions:
                if ext.should_fire(self):
                    ext(self)
            if inj is not None:
                inj.hook("iter", count=self.iteration)
            # After the extensions: a snapshot saved this iteration exists
            # before the vote that may bless it (or roll back over it).
            if self.health_guard is not None:
                self.health_guard.post_step(self, metrics,
                                            time.perf_counter() - t0)
            # Last: a checkpoint saved this iteration makes the emergency
            # save a no-op.
            if self.preemption_guard is not None:
                self.preemption_guard.poll(self)
        for ext in self.extensions:
            ext.finalize(self)
        if self.health_guard is not None:
            self.health_guard.finalize(self)
        return self.state
