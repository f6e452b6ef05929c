"""The communicator interface of the port (``chainermn_tpu/comm/base.py``
``CommunicatorBase``): ranks and sizes, the gradient all-reduce of the
data-parallel optimizer, and the few collectives training needs.  The
rest of the JAX surface raises until it is ported."""

from __future__ import annotations

from typing import Any

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
        self._unported("gather_obj")

    def allgather_obj(self, obj):
        self._unported("allgather_obj")

    def allreduce_obj(self, obj, op: str = "sum"):
        self._unported("allreduce_obj")

    def send_obj(self, obj, dest: int, source=None):
        self._unported("send_obj")

    def recv_obj(self, source: int, dest=None, timeout=None):
        self._unported("recv_obj")

    def split(self, color, key=None):
        self._unported("split")

    @property
    def axis_name(self):
        self._unported("axis_name")
