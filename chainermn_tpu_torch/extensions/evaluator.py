"""Multi-node evaluation: the port of ``chainermn_tpu/extensions/
evaluator.py``.

Reference anchor: ``chainermn/evaluators.py`` —
``create_multi_node_evaluator`` averages the per-rank metric dict across
ranks so that rank 0 reports global validation metrics.

Contract, as in the JAX package: ``metric_fn(target, batch) -> {name:
per-example vector}`` (a scalar counts as a per-batch constant), and the
aggregate is mask-exact: every example counts once, the padded tail of
a ragged last batch never.  Each rank runs its OWN iterator (its shard of
the validation set, from ``scatter_dataset``; the shards may differ in
length) and keeps per-metric sums and the example count on the device;
one ``comm.allreduce`` of those sums ends the pass, so every rank runs
the same single collective however many batches it had.  (The JAX
package, one process driving many devices, slices a lockstep global
stream instead; summed over the ranks the result is the same.)

The last batch is padded by wrap-around to the iterator's batch size and
masked, as the JAX package pads to keep one compiled shape: here it keeps
every forward at one shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Evaluator", "create_multi_node_evaluator"]


def _leaves(batch):
    if isinstance(batch, (tuple, list)):
        return [x for b in batch for x in _leaves(b)]
    return [batch]


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    return fn(batch)


class Evaluator:
    """Runs ``metric_fn`` over ``iterator_factory()`` (a fresh
    non-repeating iterator per pass) under ``torch.no_grad()``.

    ``finalize(sums, count) -> {name: value}`` replaces the default
    per-example mean for corpus-level statistics (summed over the whole
    corpus, then combined nonlinearly)."""

    def __init__(self, iterator_factory, metric_fn: Callable, communicator,
                 finalize: Optional[Callable] = None):
        self.iterator_factory = iterator_factory
        self.metric_fn = metric_fn
        self.comm = communicator
        self.finalize = finalize
        self.batches = 0

    @staticmethod
    def _pad(batch, size: int):
        """Pad the leading dim to ``size`` by wrap-around; the mask marks
        the real rows."""
        n = int(_leaves(batch)[0].shape[0])
        mask = np.zeros(size, np.float32)
        mask[:n] = 1.0
        if n == size:
            return batch, mask

        def pad(a):
            if isinstance(a, torch.Tensor):
                reps = -(-size // n)
                return torch.cat([a] * reps)[:size]
            return np.concatenate([a, np.resize(a, (size - n,) + a.shape[1:])])

        return _map(pad, batch), mask

    def evaluate_stats(self, target) -> Tuple[Dict[str, float], float]:
        """Mask-exact summed statistics and the valid-example count over
        every rank's pass (what the mean and ``finalize`` share)."""
        dev = getattr(self.comm, "device", torch.device("cpu"))
        it = self.iterator_factory()
        size = getattr(it, "batch_size", None)
        sums: Dict[str, torch.Tensor] = {}
        count = torch.zeros((), dtype=torch.float64, device=dev)
        self.batches = 0
        with torch.no_grad():
            for batch in it:
                n = int(_leaves(batch)[0].shape[0])
                batch, mask = self._pad(batch, max(size or n, n))
                m = torch.as_tensor(mask, device=dev)
                out = self.metric_fn(target, batch)
                for k, v in out.items():
                    v = torch.as_tensor(v, device=dev).float()
                    if v.dim() == 0:
                        v = v.expand(m.shape)
                    s = (v * m).sum().double()
                    sums[k] = s if k not in sums else sums[k] + s
                count = count + m.sum().double()
                self.batches += 1
        # One reduction per pass on every rank, whatever its batch count;
        # a rank whose shard held no batch still reports every metric name
        # the others saw.
        names = sorted(sums)
        if getattr(self.comm, "size", 1) > 1:
            names = sorted(set().union(*self.comm.allgather_obj(names)))
        vec = torch.stack([sums.get(k, torch.zeros((), dtype=torch.float64,
                                                   device=dev))
                           for k in names] + [count])
        vec = self.comm.allreduce(vec, op="sum").cpu().numpy()
        return ({k: float(vec[i]) for i, k in enumerate(names)},
                float(vec[-1]))

    def evaluate(self, target) -> Dict[str, float]:
        sums, count = self.evaluate_stats(target)
        if self.finalize is not None:
            return self.finalize(sums, count)
        return {k: v / max(count, 1.0) for k, v in sums.items()}

    def __call__(self, target) -> Dict[str, float]:
        return self.evaluate(target)


class _MultiNodeEvaluator:
    """The reference's wrapper shape.  The wrapped evaluator's pass
    already ends with the cross-rank reduction (every rank holds the
    global result), so this adds nothing but the API."""

    def __init__(self, actual_evaluator, communicator):
        self.actual = actual_evaluator
        self.comm = communicator

    def evaluate(self, *args, **kw) -> Dict[str, float]:
        return self.actual.evaluate(*args, **kw)

    def __call__(self, *args, **kw):
        return self.evaluate(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.actual, name)


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Reference anchor: ``create_multi_node_evaluator(ev, comm)``."""
    return _MultiNodeEvaluator(actual_evaluator, communicator)
