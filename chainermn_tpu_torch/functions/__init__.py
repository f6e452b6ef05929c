"""Differentiable communication functions of the port
(``chainermn_tpu/functions``).

Reference anchors: ``chainermn/functions/point_to_point_communication.py``
(``Send``/``Recv``/``pseudo_connect``) and
``chainermn/functions/collective_communication.py`` (``AllToAll``,
``AllGather``, ...).  Each is a ``torch.autograd.Function`` whose backward
issues the transposed call.  The port runs one process per rank, as the
reference did, so the point-to-point functions keep its delegate
variables; see :mod:`~chainermn_tpu_torch.functions.point_to_point` for
how their sends and receives are ordered so that no backward deadlocks.
"""

from chainermn_tpu_torch.functions.collective import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)
from chainermn_tpu_torch.functions.point_to_point import (
    DelegateVariable,
    pseudo_connect,
    recv,
    send,
    send_recv,
    shift,
)

__all__ = ["DelegateVariable", "allgather", "allreduce", "alltoall",
           "bcast", "gather", "pseudo_connect", "recv", "scatter", "send",
           "send_recv", "shift"]
