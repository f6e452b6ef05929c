"""The communicator interface of the port (``chainermn_tpu/comm/base.py``
``CommunicatorBase``): ranks and sizes, the gradient all-reduce of the
data-parallel optimizer, the few collectives training needs and the
object plane's gathers and reductions (``gather_obj``, ``allgather_obj``,
``allreduce_obj``).  The rest of the JAX surface raises until it is
ported."""

from __future__ import annotations

from typing import Any, List

import numpy as np

_REST = ("not ported yet (ROADMAP Queue 1 item 4: the rest of the "
         "communicator surface)")


class CommunicatorBase:
    """Abstract communicator; see :class:`ProcessGroupCommunicator`."""

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def intra_rank(self) -> int:
        raise NotImplementedError

    @property
    def intra_size(self) -> int:
        raise NotImplementedError

    @property
    def inter_rank(self) -> int:
        raise NotImplementedError

    @property
    def inter_size(self) -> int:
        raise NotImplementedError

    def allreduce_grad(self, model) -> None:
        """Replace every gradient of ``model`` (an ``nn.Module`` or an
        iterable of parameters) by its mean over the ranks, in place."""
        raise NotImplementedError

    def allreduce(self, x: Any, op: str = "sum") -> Any:
        raise NotImplementedError

    def bcast_data(self, data: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        """Parity with the reference API: nothing to tear down (the
        process group belongs to the program)."""

    def _unported(self, name: str):
        raise NotImplementedError(f"{type(self).__name__}.{name} is "
                                  f"{_REST}")

    def alltoall(self, xs):
        self._unported("alltoall")

    def allgather(self, x):
        self._unported("allgather")

    def permute(self, x, perm):
        self._unported("permute")

    def gather(self, x, root: int = 0):
        self._unported("gather")

    def scatter(self, x, root: int = 0):
        self._unported("scatter")

    def gather_obj(self, obj, root: int = 0):
        """Every rank's picklable ``obj`` as a list on ``root`` (None
        elsewhere)."""
        raise NotImplementedError

    def allgather_obj(self, obj) -> List[Any]:
        """Every rank's picklable ``obj``, as a list in rank order, on
        every rank."""
        raise NotImplementedError

    def allreduce_obj(self, obj, op: str = "sum"):
        """Leaf-wise numeric reduction of a nested dict/list/tuple of
        numbers or arrays over the ranks (``sum``/``mean``/``max``/
        ``min``)."""
        return reduce_objs(self.allgather_obj(obj), op)

    def send_obj(self, obj, dest: int, source=None):
        self._unported("send_obj")

    def recv_obj(self, source: int, dest=None, timeout=None):
        self._unported("recv_obj")

    def split(self, color, key=None):
        self._unported("split")

    @property
    def axis_name(self):
        self._unported("axis_name")


_REDUCE = {"sum": lambda c: np.sum(np.asarray(c), axis=0),
           "mean": lambda c: np.mean(np.asarray(c), axis=0),
           "max": lambda c: np.max(np.asarray(c), axis=0),
           "min": lambda c: np.min(np.asarray(c), axis=0)}


def reduce_objs(objs: List[Any], op: str) -> Any:
    """Reduce equal-structured objects leaf by leaf (the JAX package's
    ``CommunicatorBase._reduce_objs``): dicts, lists and tuples recurse,
    every other leaf is a number or an array; a 0-d result comes back as
    a Python scalar unless the objects themselves are arrays."""
    if op not in _REDUCE:
        raise ValueError(f"unknown op {op!r}")
    if not objs:
        return None
    first = objs[0]
    if isinstance(first, dict):
        return {k: reduce_objs([o[k] for o in objs], op) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(reduce_objs([o[i] for o in objs], op)
                           for i in range(len(first)))
    out = _REDUCE[op](objs)
    if np.ndim(out) == 0 and not isinstance(first, np.ndarray):
        return out.item()
    return out
