"""Distributed checkpointing, restart-based: the port of
``chainermn_tpu/extensions/checkpoint.py``.

Reference anchor: ``chainermn/extensions/checkpoint.py`` —
``create_multi_node_checkpointer(name, comm)``: each rank snapshots its
local state under rank-tagged filenames, the ranks ``allgather_obj`` the
iterations they hold and resume from the newest iteration COMMON to all
of them, and old snapshots are garbage-collected.  The world size is
fixed, but for the ZeRO tier: :meth:`MultiNodeCheckpointer.
maybe_load_elastic` re-lays its shards under another rank count.

Format: one file per rank and step, ``<path>/<name>/<step>/rank<R>.pt``
(``torch.save`` of host copies): the model's ``state_dict`` (parameters
and buffers, so sync-BN running statistics too), the torch optimizer's
``state_dict``, the optimizer options' state (pending gradients, this
rank's int8 residuals, the EMA, the health check's carry) and the
loop state (the trainer's iteration, every extension's last firing
tick, the iterator's epoch, cursor, order and RNG), so a resumed run
draws the same batches as an uninterrupted one.  A ZeRO rank's file holds its shards (``"zero"``),
its shard-sized optimizer state and residuals and the model's buffers,
not the model's gathered parameters.  A rank's file is written under a
temporary name and renamed when complete: the rename is that rank's
commit of the step, so a step is never half-visible.  ``async_save`` takes the host copies at the
trigger and writes them on a background thread; :meth:`finalize` (and
the next save or restore) waits for it.  Save and restore I/O retry on a
deterministic backoff (:class:`~chainermn_tpu_torch.resilience.
RetryPolicy`).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from chainermn_tpu_torch import observability as _obs
from chainermn_tpu_torch.observability import metrics as _omet
from chainermn_tpu_torch.observability import tracing as _otrace
from chainermn_tpu_torch.resilience.policy import RetryPolicy
from chainermn_tpu_torch.training import Extension

__all__ = ["MultiNodeCheckpointer", "apply_loop_state", "capture_loop_state",
           "create_multi_node_checkpointer"]

FORMAT = "cmn-torch-ckpt-1"


def capture_loop_state(trainer) -> dict:
    """The loop-resume state (trainer iteration, iterator epoch, cursor,
    order and RNG) as a flat dict of numpy leaves."""
    out = {
        "iteration": np.zeros((), np.int64),
        "epoch": np.zeros((), np.int64),
        "it_pos": np.zeros((), np.int64),
    }
    if trainer is None:
        return out
    it = trainer.train_iter
    out["iteration"] = np.asarray(trainer.iteration, np.int64)
    out["epoch"] = np.asarray(getattr(it, "epoch", 0), np.int64)
    # Iterators with lookahead (the native ring, the device queue) expose
    # a consumption-granular cursor; their raw attributes run ahead.
    st = (it.checkpoint_loop_state()
          if hasattr(it, "checkpoint_loop_state") else None)
    if st is None and hasattr(it, "_order") and hasattr(it, "_rng"):
        mt, keys, pos, has_gauss, cached = it._rng.get_state()
        st = {"pos": it._pos, "order": it._order, "rng_keys": keys,
              "rng_pos": pos, "rng_has_gauss": has_gauss,
              "rng_cached": cached}
    if st is not None:
        out["it_pos"] = np.asarray(st["pos"], np.int64)
        out["it_order"] = np.asarray(st["order"], np.int64)
        out["rng_keys"] = np.asarray(st["rng_keys"], np.uint32)
        out["rng_pos"] = np.asarray(st["rng_pos"], np.int64)
        out["rng_has_gauss"] = np.asarray(st["rng_has_gauss"], np.int64)
        out["rng_cached"] = np.asarray(st["rng_cached"], np.float64)
    else:
        out["it_pos"] = np.asarray(getattr(it, "_pos", 0), np.int64)
    return out


def apply_loop_state(trainer, loop) -> None:
    """Push restored trainer, iterator and extension state."""
    if trainer is None:
        return
    trainer.iteration = int(loop["iteration"])
    it = trainer.train_iter
    if "it_order" in loop:
        st = {"pos": int(loop["it_pos"]), "order": loop["it_order"],
              "rng_keys": loop["rng_keys"], "rng_pos": int(loop["rng_pos"]),
              "rng_has_gauss": int(loop["rng_has_gauss"]),
              "rng_cached": float(loop["rng_cached"])}
        if hasattr(it, "restore_loop_state"):
            it.restore_loop_state(int(loop["epoch"]), st)
        else:
            it.epoch = int(loop["epoch"])
            it.is_new_epoch = False
            it._pos = st["pos"]
            it._order = np.asarray(st["order"]).astype(np.int64)
            it._rng.set_state(("MT19937",
                               np.asarray(st["rng_keys"]).astype(np.uint32),
                               st["rng_pos"], st["rng_has_gauss"],
                               st["rng_cached"]))
    else:
        if hasattr(it, "epoch"):
            it.epoch = int(loop["epoch"])
        if hasattr(it, "_pos"):
            it._pos = int(loop["it_pos"])
    # Every extension's last firing tick, as the JAX package sets it: the
    # snapshot's tick counts as fired for every trigger (the save runs
    # inside the extension loop of that tick), so no interval extension
    # re-fires on the first resumed iteration.
    for ext in trainer.extensions:
        ext._last_fired = (int(loop["epoch"]) if ext.unit == "epoch"
                           else int(loop["iteration"]))


def _load_optimizer_in_place(opt: torch.optim.Optimizer,
                             saved: dict) -> None:
    """``opt.load_state_dict(saved)``, but into the tensors ``opt``
    already holds where it holds the same entries of the same shapes (a
    captured train step replays on their addresses; ``load_state_dict``
    would put new tensors in their place); a tensor hyperparameter (a
    scheduled learning rate) is copied into too.  Otherwise, as on a
    fresh optimizer, ``load_state_dict``."""
    params = [p for g in opt.param_groups for p in g["params"]]
    state = saved["state"]

    def fits(i, p):
        mine = opt.state.get(p, {})
        theirs = state.get(i, {})
        if set(mine) != set(theirs):
            return False
        return all(not isinstance(v, torch.Tensor)
                   or (isinstance(theirs[k], torch.Tensor)
                       and theirs[k].shape == v.shape)
                   for k, v in mine.items())

    if not opt.state or len(saved["param_groups"]) != len(opt.param_groups) \
            or not all(fits(i, p) for i, p in enumerate(params)):
        opt.load_state_dict(saved)
        return
    with torch.no_grad():
        for i, p in enumerate(params):
            for k, v in state.get(i, {}).items():
                mine = opt.state[p][k]
                if isinstance(mine, torch.Tensor):
                    mine.copy_(v)
                else:
                    opt.state[p][k] = v
        for g, sg in zip(opt.param_groups, saved["param_groups"]):
            for k, v in sg.items():
                if k == "params":
                    continue
                if isinstance(g.get(k), torch.Tensor):
                    g[k].copy_(v)
                else:
                    g[k] = v


def _to_host(obj):
    """Host copies of every tensor in a nested structure (so a save in
    flight never reads a tensor the next step rewrites)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _is_zero(state) -> bool:
    """A ZeRO-sharded state (the optimizer's flat shards)."""
    return hasattr(state, "flat_params")


class MultiNodeCheckpointer(Extension):
    """Trainer extension that snapshots (TrainState, loop state) every
    trigger, keeps this rank's ``max_to_keep`` newest steps, and restores
    the newest step every rank holds via :meth:`maybe_load`."""

    def __init__(self, name: str, comm, path: str = "checkpoints",
                 max_to_keep: int = 5, trigger=(1, "epoch"),
                 async_save: bool = True, known_good_keep: int = 3):
        super().__init__(self._fire, trigger=trigger,
                         name=f"checkpointer/{name}")
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.comm = comm
        self._dir = os.path.abspath(os.path.join(path, name))
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.async_save = bool(async_save)
        self._rank = int(getattr(comm, "rank", 0))
        self._save_retry = RetryPolicy(max_attempts=3, base_delay_s=0.2,
                                       multiplier=2.0, max_delay_s=2.0)
        self._restore_retry = RetryPolicy(max_attempts=3, base_delay_s=0.2,
                                          multiplier=2.0, max_delay_s=2.0,
                                          retry_on=(OSError,))
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None
        # Known-good ring (the training-health guard's rollback targets):
        # snapshot steps that survived a clean cross-rank consistency
        # vote, persisted beside the snapshots.
        self._known_good: deque = deque(maxlen=int(known_good_keep))
        for s in self._load_known_good():
            self._known_good.append(int(s))
        self._last_saved_step: Optional[int] = None
        #: bytes of this rank's newest file, and the seconds its host copy
        #: and write took (the write runs on a thread with async_save).
        self.last_save = {}
        #: the newest restore's step, file bytes, and the seconds its read
        #: took and the whole restore took (up to the state on its device).
        self.last_restore = {}

    @property
    def directory(self) -> str:
        return self._dir

    def _rank_file(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)), f"rank{self._rank}.pt")

    # ----------------------------------------------------------------- save
    def _fire(self, trainer):
        self.save(trainer.state, trainer)

    def save(self, state, trainer=None) -> int:
        """Snapshot ``state`` (and ``trainer``'s loop state) at the
        trainer's iteration (``state.step`` without a trainer); returns
        the step."""
        import time

        step = int(trainer.iteration if trainer is not None else state.step)
        self.wait()
        t0 = time.perf_counter()
        zero = _is_zero(state)
        payload = {
            "format": FORMAT, "step": step, "rank": self._rank,
            "world_size": int(getattr(self.comm, "size", 1)),
            "state_step": int(state.step),
            # A ZeRO rank owns its shards, not the model's parameters (the
            # last step's gathered copy): only the buffers are saved.
            "model": _to_host(dict(state.model.named_buffers()) if zero
                              else state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "pending_grads": None if zero else _to_host(state.pending_grads),
            "ef_residual": _to_host(state.ef_residual),
            "ema_params": None if zero else _to_host(state.ema_params),
            "health": _to_host(getattr(state, "health", None)),
            "loop": capture_loop_state(trainer),
        }
        if zero:
            payload["zero"] = {"flat_params": _to_host(
                [p.detach() for p in state.flat_params])}
        host_s = time.perf_counter() - t0
        obs_on = _obs.enabled()

        def write():
            t1 = time.perf_counter()
            with (_otrace.tracer().span("ckpt_save", detail=f"step={step}")
                  if obs_on else contextlib.nullcontext()):
                self._save_retry.call(self._commit, step, payload)
            path = self._rank_file(step)
            self.last_save = {"step": step, "bytes": os.path.getsize(path),
                              "host_copy_s": host_s,
                              "write_s": time.perf_counter() - t1}
            self._gc()
            if obs_on:
                _omet.registry().counter("ckpt.saves").inc()

        self._last_saved_step = step
        if self.async_save:
            def run():
                try:
                    write()
                except BaseException as e:  # surfaced by wait()
                    self._thread_error = e

            self._thread = threading.Thread(target=run, daemon=True,
                                            name="cmn-ckpt-save")
            self._thread.start()
        else:
            write()
        return step

    def _commit(self, step: int, payload: dict) -> None:
        path = self._rank_file(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def wait(self) -> None:
        """Block until a save in flight is committed (re-raising its
        error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._thread_error is not None:
            err, self._thread_error = self._thread_error, None
            raise err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.max_to_keep]:
            with contextlib.suppress(OSError):
                os.remove(self._rank_file(s))
            with contextlib.suppress(OSError):
                os.rmdir(os.path.join(self._dir, str(s)))

    def emergency_save(self, trainer) -> int:
        """One synchronous snapshot at the trainer's iteration unless that
        step is already this rank's newest; returns the step."""
        step = int(trainer.iteration)
        self.wait()
        steps = self.all_steps()
        if not steps or steps[-1] != step:
            was, self.async_save = self.async_save, False
            try:
                self.save(trainer.state, trainer)
            finally:
                self.async_save = was
        return step

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """Steps this rank has committed, oldest first."""
        out = []
        for d in os.listdir(self._dir):
            if d.isdigit() and os.path.exists(self._rank_file(int(d))):
                out.append(int(d))
        return sorted(out)

    def latest_common_step(self) -> Optional[int]:
        """The newest step every rank has committed (collective: the
        ranks ``allgather_obj`` their step lists)."""
        self.wait()
        mine = self.all_steps()
        every = self.comm.allgather_obj(mine) \
            if hasattr(self.comm, "allgather_obj") else [mine]
        common = set(every[0]).intersection(*map(set, every[1:]))
        return max(common) if common else None

    def maybe_load(self, state, trainer=None) -> Tuple[Any, int]:
        """Reference anchor: ``_MultiNodeCheckpointer.maybe_load``: restore
        the newest step every rank holds if there is one, else return the
        inputs unchanged.  Returns ``(state, iteration)``."""
        step = self.latest_common_step()
        if step is None:
            return state, 0
        return self.restore_step(step, state, trainer)

    def restore_step(self, step, state, trainer=None) -> Tuple[Any, int]:
        """Restore this rank's snapshot of ``step`` into ``state`` (in
        place: the model's tensors, the optimizer, the options' state)
        and ``trainer``'s loop.  Every rank restores the same step."""
        import time

        self.wait()
        t0 = time.perf_counter()
        obs_on = _obs.enabled()
        with (_otrace.tracer().span("ckpt_restore", detail=f"step={step}")
              if obs_on else contextlib.nullcontext()):
            payload = self._restore_retry.call(
                torch.load, self._rank_file(step), map_location="cpu",
                weights_only=False)
        load_s = time.perf_counter() - t0
        if payload.get("format") != FORMAT:
            raise ValueError(f"{self._rank_file(step)} is not a "
                             f"{FORMAT} snapshot")
        if _is_zero(state):
            self._restore_zero(state, payload)
        else:
            self._restore_replicated(state, payload)
        p = next(state.model.parameters(), None)
        if p is not None and p.is_cuda:
            torch.cuda.synchronize(p.device)
        self.last_restore = {"step": int(step),
                             "bytes": os.path.getsize(self._rank_file(step)),
                             "load_s": load_s,
                             "seconds": time.perf_counter() - t0}
        if obs_on:
            _omet.registry().counter("ckpt.restores").inc()
        loop = payload["loop"]
        apply_loop_state(trainer, loop)
        if trainer is not None:
            trainer.state = state
        return state, int(loop["iteration"])

    @staticmethod
    def _restore_zero(state, payload) -> None:
        """This rank's shards, shard-sized optimizer state, residuals
        and the model's buffers, in place (the same world size)."""
        if payload.get("zero") is None:
            raise ValueError("the snapshot holds a replicated state, the "
                             "target is ZeRO-sharded")
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["state_step"])
        with torch.no_grad():
            for mine, saved in zip(state.flat_params,
                                   payload["zero"]["flat_params"]):
                mine.copy_(saved)
            if state.ef_residual is not None:
                saved = payload["ef_residual"]
                for mine, r in zip(state.ef_residual,
                                   saved or [None] * len(state.ef_residual)):
                    if r is None:
                        mine.zero_()
                    else:
                        mine.copy_(r)
            bufs = dict(state.model.named_buffers())
            for n, t in payload["model"].items():
                bufs[n].copy_(t)

    @staticmethod
    def _restore_replicated(state, payload) -> None:
        # In place, the optimizer's state included: a captured train step
        # replays on these tensors' addresses.
        state.model.load_state_dict(payload["model"])
        _load_optimizer_in_place(state.optimizer, payload["optimizer"])
        state.step = int(payload["state_step"])
        if state.health is not None and payload.get("health") is not None:
            with torch.no_grad():
                state.health.copy_(payload["health"])
        with torch.no_grad():
            for field in ("pending_grads", "ef_residual", "ema_params"):
                mine, saved = getattr(state, field), payload[field]
                if mine is None:
                    continue
                for n, t in mine.items():
                    if saved is not None:
                        t.copy_(saved[n])
                    elif field == "ema_params":
                        # A snapshot from before the EMA was enabled: seed
                        # the average from the restored parameters.
                        t.copy_(state.params[n].float())
                    else:
                        t.zero_()

    def _complete_steps(self) -> List[Tuple[int, int]]:
        """``(step, world size)`` of every step whose ranks' files are all
        there (``rank0`` .. ``rank{W-1}``, whatever world wrote them),
        oldest first."""
        out = []
        for d in os.listdir(self._dir):
            path = os.path.join(self._dir, d)
            if not d.isdigit() or not os.path.isdir(path):
                continue
            ranks = sorted(int(f[4:-3]) for f in os.listdir(path)
                           if f.startswith("rank") and f.endswith(".pt")
                           and f[4:-3].isdigit())
            if ranks and ranks == list(range(len(ranks))):
                out.append((int(d), len(ranks)))
        return sorted(out)

    def maybe_load_elastic(self, opt, model, trainer=None
                           ) -> Tuple[Any, int]:
        """Elastic restore for the ZeRO tier: resume the newest snapshot
        even when a different number of ranks saved it.  ZeRO shards are
        padded per rank count, so :meth:`maybe_load` cannot map them; each
        rank here reads every saved rank's file and re-lays the state
        through the logical view
        (:func:`~chainermn_tpu_torch.optimizers.reshard_zero_state`).

        ``opt`` is the target :class:`~chainermn_tpu_torch.optimizers.
        ZeroMultiNodeOptimizer`, ``model`` the model to train (its
        parameters are replaced by the snapshot's).  Returns ``(state,
        iteration)``: a fresh ``opt.init(model)`` state when no snapshot
        exists.  Every rank calls it together."""
        import time

        from chainermn_tpu_torch.optimizers.zero import reshard_zero_state

        self.wait()
        steps = self._complete_steps()
        if not steps:
            return opt.init(model), 0
        step, world = steps[-1]
        t0 = time.perf_counter()
        paths = [os.path.join(self._dir, str(step), f"rank{r}.pt")
                 for r in range(world)]
        payloads = [self._restore_retry.call(
            torch.load, p, map_location="cpu", weights_only=False)
            for p in paths]
        for p, payload in zip(paths, payloads):
            if payload.get("format") != FORMAT or \
                    payload.get("zero") is None:
                raise ValueError(f"{p} is not a ZeRO {FORMAT} snapshot")
        raw = [{"flat_params": p["zero"]["flat_params"],
                "optimizer": p["optimizer"],
                "ef_residual": p["ef_residual"],
                "step": p["state_step"]} for p in payloads]
        state = reshard_zero_state(raw, opt, model)
        with torch.no_grad():
            bufs = dict(state.model.named_buffers())
            for n, t in payloads[0]["model"].items():
                bufs[n].copy_(t)
        self.last_restore = {"step": int(step), "world_size": world,
                             "bytes": sum(os.path.getsize(p)
                                          for p in paths),
                             "seconds": time.perf_counter() - t0}
        loop = payloads[0]["loop"]
        apply_loop_state(trainer, loop)
        if trainer is not None:
            trainer.state = state
        return state, int(loop["iteration"])

    # ------------------------------------------------- known-good ring
    def mark_known_good_upto(self, iteration: int) -> List[int]:
        """Bless every committed step <= ``iteration`` not yet in the ring
        (after a clean consistency vote at that iteration); returns the
        newly blessed steps."""
        newest = max(self._known_good, default=None)
        if self._last_saved_step is None or (
                newest is not None and self._last_saved_step <= newest):
            return []
        self.wait()
        eligible = [s for s in self.all_steps() if s <= int(iteration)]
        new = []
        for s in eligible[-self._known_good.maxlen:]:
            if s not in self._known_good:
                self._known_good.append(s)
                new.append(s)
        if new:
            self._persist_known_good()
        return new

    def latest_known_good(self) -> Optional[int]:
        """The newest blessed step still on disk, or None."""
        on_disk = set(self.all_steps())
        good = [s for s in self._known_good if s in on_disk]
        return max(good) if good else None

    def known_good_steps(self) -> List[int]:
        return sorted(self._known_good)

    def discard_after(self, step: int) -> List[int]:
        """Delete this rank's snapshots newer than ``step`` (taken on
        possibly poisoned state); every rank calls it together.  Returns
        the deleted steps."""
        self.wait()
        doomed = [s for s in self.all_steps() if s > step]
        for s in doomed:
            with contextlib.suppress(OSError):
                os.remove(self._rank_file(s))
            if self._rank == 0:
                shutil.rmtree(os.path.join(self._dir, str(s)),
                              ignore_errors=True)
        while self._known_good and max(self._known_good) > step:
            self._known_good.remove(max(self._known_good))
        if self._last_saved_step is not None:
            self._last_saved_step = min(self._last_saved_step, int(step))
        self._persist_known_good()
        return doomed

    def _known_good_path(self) -> str:
        return os.path.join(self._dir, "known_good.json")

    def _load_known_good(self) -> List[int]:
        try:
            with open(self._known_good_path()) as f:
                return [int(s) for s in json.load(f)["steps"]]
        except (OSError, ValueError, KeyError):
            return []

    def _persist_known_good(self) -> None:
        if self._rank != 0:
            return
        try:
            tmp = self._known_good_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"steps": sorted(self._known_good)}, f)
            os.replace(tmp, self._known_good_path())
        except OSError:  # best effort: the ring also lives in memory
            pass

    # ------------------------------------------------------------------ misc
    def finalize(self, trainer=None):
        self.wait()

    def close(self):
        self.wait()


def create_multi_node_checkpointer(name: str, comm, path: str = "checkpoints",
                                   max_to_keep: int = 5,
                                   trigger=(1, "epoch"),
                                   async_save: bool = True,
                                   known_good_keep: int = 3
                                   ) -> MultiNodeCheckpointer:
    """Reference anchor: ``create_multi_node_checkpointer(name, comm)``.
    ``async_save=False`` commits at the trigger (a crash right after it
    still finds the snapshot)."""
    return MultiNodeCheckpointer(name, comm, path=path,
                                 max_to_keep=max_to_keep, trigger=trigger,
                                 async_save=async_save,
                                 known_good_keep=known_good_keep)
