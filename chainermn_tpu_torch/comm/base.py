"""The communicator interface of the port (``chainermn_tpu/comm/base.py``
``CommunicatorBase``): ranks and sizes, the gradient all-reduce of the
data-parallel optimizer, the array collectives (each rank passes its own
tensor), the object plane (broadcast, gathers, reductions and
rank-addressed point to point) and the structuring calls (``split``,
``axis_name``).  :class:`~chainermn_tpu_torch.comm.process_group.
ProcessGroupCommunicator` implements all of it."""

from __future__ import annotations

from typing import Any, List

import numpy as np

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

    def alltoall(self, xs):
        """Row ``j`` of this rank's ``(size, ...)`` ``xs`` goes to rank
        ``j``; row ``j`` of the result came from rank ``j``."""
        raise NotImplementedError

    def allgather(self, x):
        """Every rank's ``x`` stacked in rank order."""
        raise NotImplementedError

    def permute(self, x, perm):
        """``x`` moved along ``[(src, dst), ...]``; zeros where no edge
        arrives (the reference's paired ``send``/``recv``)."""
        raise NotImplementedError

    def gather(self, x, root: int = 0):
        raise NotImplementedError

    def scatter(self, x, root: int = 0):
        raise NotImplementedError

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

    def send_obj(self, obj, dest: int, source=None, op: str = "send_obj"):
        """Rank-addressed object send (reference anchor
        ``MpiCommunicatorBase.send_obj``), FIFO per ``(source, dest)``.
        ``op`` names the caller's operation, as on
        :class:`~chainermn_tpu_torch.hostcomm.HostComm`."""
        raise NotImplementedError

    def recv_obj(self, source: int, dest=None, timeout=None,
                 timeout_ms=None, op: str = "recv_obj"):
        """The next object ``source`` sent to this rank; raises
        ``TimeoutError`` after ``timeout`` seconds (or ``timeout_ms``
        milliseconds, as :class:`~chainermn_tpu_torch.hostcomm.HostComm`
        takes it)."""
        raise NotImplementedError

    def split(self, color, key=None):
        """MPI_Comm_split in the JAX package's form: per-rank ``color``
        and ``key`` sequences, ``{color: communicator}`` back."""
        raise NotImplementedError

    @property
    def axis_name(self):
        """What a model takes for collectives inside its forward."""
        raise NotImplementedError

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
