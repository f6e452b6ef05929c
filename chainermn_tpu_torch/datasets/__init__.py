"""Data distribution of the port: numpy copies of the JAX package's
``datasets`` (``ArrayDataset``, ``NpzDataset``, ``SubDataset``,
``scatter_dataset``, ``create_empty_dataset``,
``make_synthetic_classification``), ``datasets/packing.py`` and
``datasets/seq.py`` (the seq2seq family's buckets and corpora), with the
same shuffling and seeds, so the same rows reach both packages.

Sharding is by communicator rank: one PyTorch process drives one card, so
a rank here is what a host process is to the JAX package (one process
with many devices there sees the whole dataset and shards at batch time).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chainermn_tpu_torch.datasets.packing import (
    pack_pairs,
    pack_sequences,
    packing_efficiency,
)

__all__ = ["ArrayDataset", "NpzDataset", "SubDataset",
           "create_empty_dataset", "make_synthetic_classification",
           "scatter_dataset", "pack_pairs", "pack_sequences",
           "packing_efficiency"]


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

    @property
    def base(self):
        """The dataset this view selects from (array-aware consumers such
        as ``PrefetchIterator`` compose index maps through it)."""
        return self._dataset

    @property
    def indices(self) -> np.ndarray:
        """This view's row indices into :attr:`base`."""
        return self._indices


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


class _EmptyDataset:
    def __init__(self, n: int):
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return ()


def create_empty_dataset(dataset):
    """Reference anchor: ``create_empty_dataset`` — placeholder of the same
    length for ranks that only do model-parallel compute."""
    return _EmptyDataset(len(dataset))


class NpzDataset(ArrayDataset):
    """File-backed dataset (the reference's on-disk ImageNet role,
    ``examples/imagenet/train_imagenet.py`` ``PreprocessedDataset`` over image
    files — here numpy containers, the idiomatic zero-copy format for array
    data).

    Accepts either

    * a ``.npz`` archive — members are loaded via numpy's lazy ``NpzFile``
      (each member materializes once, on open; zipped members cannot be
      memory-mapped), or
    * a directory of ``.npy`` files — each memory-mapped (``mmap_mode='r'``),
      so rows are paged from disk on access and the resident set stays at
      the OS page cache's discretion.  This is the path that exercises real
      input-pipeline pressure: the prefetch workers fault pages in while the
      chip runs the current step.

    ``keys`` orders the member arrays into the example tuple (default: the
    container's sorted key order, with ``x``/``y``-style names first when
    present).  All members must share their leading dimension.
    """

    _PREFERRED = ("x", "images", "data", "y", "labels", "targets")

    def __init__(self, path, keys=None, mmap_mode: str = "r"):
        import os

        self.path = str(path)
        if os.path.isdir(self.path):
            found = {
                fn[:-4]: os.path.join(self.path, fn)
                for fn in sorted(os.listdir(self.path))
                if fn.endswith(".npy")
            }
            if not found:
                raise ValueError(f"no .npy files in directory {self.path}")
            keys = keys or self._order_keys(found)
            arrays = [np.load(found[k], mmap_mode=mmap_mode) for k in keys]
        else:
            with np.load(self.path) as npz:  # members materialize here;
                # close the zip handle rather than hold it for our lifetime
                keys = keys or self._order_keys(npz.files)
                arrays = [npz[k] for k in keys]
        self.keys = tuple(keys)
        ns = {len(a) for a in arrays}
        if len(ns) != 1:
            raise ValueError(
                f"members {self.keys} disagree on leading dim: "
                f"{[len(a) for a in arrays]}"
            )
        # Bypass ArrayDataset.__init__'s np.asarray (it would materialize a
        # memory-mapped member into RAM); np.memmap is already an ndarray.
        self._arrays = tuple(arrays)

    @classmethod
    def _order_keys(cls, names):
        names = sorted(names)
        pref = [k for k in cls._PREFERRED if k in names]
        return pref + [k for k in names if k not in pref]


def make_synthetic_classification(
    n: int = 4096,
    dim: int = 784,
    classes: int = 10,
    seed: int = 0,
    noise: float = 0.3,
    task_seed: int = 1234,
) -> ArrayDataset:
    """Deterministic learnable classification task (MNIST stand-in for the
    zero-egress environment: class = argmax of a fixed random projection plus
    noise).  ``task_seed`` fixes the projection (the "task"); ``seed`` draws
    the samples — so train/val splits share a task but not samples.
    Examples/tests use this where the reference used MNIST."""
    proj = (
        np.random.RandomState(task_seed)
        .normal(size=(dim, classes))
        .astype(np.float32)
    )
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    logits = x @ proj + noise * rng.normal(size=(n, classes)).astype(np.float32)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return ArrayDataset(x, y)
