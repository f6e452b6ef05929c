"""Batch iterators of the port: a numpy copy of the JAX package's
``SerialIterator`` (``chainermn_tpu/iterators/__init__.py``), with the
same epoch semantics and ``RandomState`` shuffling, so a seed draws the
same batches in both packages.  The native prefetching iterators are not
ported yet (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["SerialIterator"]


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
