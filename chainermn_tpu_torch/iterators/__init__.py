"""Batch iterators of the port (``chainermn_tpu/iterators``): a numpy copy
of the JAX package's ``SerialIterator``, with the same epoch semantics and
``RandomState`` shuffling, so a seed draws the same batches in both
packages; the multi-node iterators over the communicator's ``bcast_obj``
(reference anchors ``create_multi_node_iterator`` and
``create_synchronized_iterator``); :class:`PrefetchIterator` over the
native threaded batch assembler, in the serial iterator's order; and
:class:`DevicePrefetchIterator`, pinned staging plus a side-stream copy
to the card."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["DevicePrefetchIterator", "PrefetchIterator", "SerialIterator",
           "create_device_prefetch_iterator", "create_multi_node_iterator",
           "create_synchronized_iterator"]


def _next_epoch_indices(it):
    """Advance an epoch-ordered iterator one batch: ``(indices,
    completes_epoch, wrapped)`` or None when a non-repeating pass is
    exhausted.  A batch spanning the epoch boundary wraps with the next
    epoch's freshly shuffled order."""
    n = it._n
    if it._pos >= n:
        if not it._repeat:
            return None
        it._order = it._new_order()
        it._pos = 0
    idx = it._order[it._pos:it._pos + it.batch_size]
    it._pos += it.batch_size
    completes = it._pos >= n
    wrapped = 0
    if len(idx) < it.batch_size and it._repeat:
        it._order = it._new_order()
        extra = it._order[:it.batch_size - len(idx)]
        idx = np.concatenate([idx, extra])
        it._pos = len(extra)
        wrapped = len(extra)
    return np.asarray(idx, np.int64), completes, wrapped


class SerialIterator:
    """Epoch-aware batch iterator; yields tuples of stacked numpy arrays
    for tuple datasets."""

    def __init__(self, dataset, batch_size: int, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._n = len(dataset)
        self.reset()

    def reset(self):
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._order = self._new_order()
        self._pos = 0

    def _new_order(self):
        n = len(self.dataset)
        return self._rng.permutation(n) if self._shuffle else np.arange(n)

    def __iter__(self):
        return self

    def __next__(self):
        nxt = _next_epoch_indices(self)
        if nxt is None:
            raise StopIteration
        idx, completes, _ = nxt
        self.iteration += 1
        self.is_new_epoch = bool(completes)
        if completes:
            self.epoch += 1
        batch = [self.dataset[int(i)] for i in idx]
        if isinstance(batch[0], tuple):
            return tuple(np.stack([b[i] for b in batch])
                         for i in range(len(batch[0])))
        return np.stack(batch)

    @property
    def epoch_detail(self):
        return self.epoch + self._pos / max(len(self.dataset), 1)


class _MultiNodeIterator:
    """Every rank steps its own iterator (so its epoch bookkeeping, which
    the trainer's triggers read, advances), and every rank gets rank
    ``rank_master``'s batch through the communicator's ``bcast_obj``."""

    def __init__(self, actual_iterator, comm, rank_master: int = 0):
        self.actual = actual_iterator
        self.comm = comm
        self.rank_master = rank_master

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.actual)
        return self.comm.bcast_obj(batch, root=self.rank_master)

    def __getattr__(self, name):
        return getattr(self.actual, name)


def create_multi_node_iterator(actual_iterator, communicator,
                               rank_master: int = 0):
    """Reference anchor: ``create_multi_node_iterator``, for datasets that
    cannot be scattered: the other ranks receive the master's batches.
    Every rank passes an iterator of the same length and batch size."""
    return _MultiNodeIterator(actual_iterator, communicator, rank_master)


def create_synchronized_iterator(actual_iterator, communicator):
    """Reference anchor: ``create_synchronized_iterator``: every rank
    draws the same batches, rank 0's, as in the JAX package."""
    return _MultiNodeIterator(actual_iterator, communicator, rank_master=0)


from chainermn_tpu_torch.iterators.prefetch import PrefetchIterator  # noqa: E402,E501
from chainermn_tpu_torch.iterators.device_prefetch import (  # noqa: E402
    DevicePrefetchIterator,
    create_device_prefetch_iterator,
)
