"""Data distribution of the port: numpy copies of the JAX package's
``datasets`` (``ArrayDataset``, ``SubDataset``, ``scatter_dataset``) and
``datasets/packing.py``, with the same shuffling and seeds, so the same
rows reach both packages.

Sharding is by communicator rank: one PyTorch process drives one card, so
a rank here is what a host process is to the JAX package (one process
with many devices there sees the whole dataset and shards at batch time).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chainermn_tpu_torch.datasets.packing import (
    pack_sequences,
    packing_efficiency,
)

__all__ = ["ArrayDataset", "SubDataset", "scatter_dataset",
           "pack_sequences", "packing_efficiency"]


class SubDataset:
    """A view of ``dataset`` through an index list."""

    def __init__(self, dataset, indices: np.ndarray):
        self._dataset = dataset
        self._indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self._indices[i]]
        return self._dataset[int(self._indices[i])]


class ArrayDataset:
    """Tuple-of-arrays dataset."""

    def __init__(self, *arrays: np.ndarray):
        if len({len(a) for a in arrays}) != 1:
            raise ValueError("all arrays must share their leading dim")
        self._arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self):
        return len(self._arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self._arrays)

    @property
    def arrays(self):
        return self._arrays


def scatter_dataset(dataset, comm, root: int = 0, shuffle: bool = False,
                    seed: Optional[int] = None,
                    force_equal_length: bool = True) -> SubDataset:
    """Shard ``dataset`` across the communicator's ranks.

    Every rank computes the same permutation (``RandomState(seed)``, as
    the JAX package does) and takes its own slice; ``force_equal_length``
    pads the tail shards by wrap-around so all ranks step in lockstep.
    Without a seed, rank ``root`` draws one and broadcasts it."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        if seed is None:
            seed = comm.bcast_obj(int(np.random.randint(0, 2**31 - 1)),
                                  root=root)
        order = np.random.RandomState(seed).permutation(n)
    nproc, pidx = max(comm.size, 1), comm.rank
    per = -(-n // nproc)
    if force_equal_length:
        mine = np.resize(order, per * nproc)[pidx * per:(pidx + 1) * per]
    else:
        mine = order[pidx * per:(pidx + 1) * per]
    return SubDataset(dataset, mine)
