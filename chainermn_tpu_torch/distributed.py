"""Process-group bootstrap of the port (the counterpart of
``chainermn_tpu/distributed.py`` ``init_distributed``).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) the default group comes from the environment; a
caller may instead give an ``init_method`` such as
``tcp://localhost:<port>`` with ``world_size`` and ``rank``; with neither,
the program is one rank and the group is built over an in-process
``HashStore``, so the collectives of the training step still run.  The
rendezvous store is made before the group (:func:`rendezvous`), so the
ranks can agree over it before they choose a backend.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
#: How long a rank waits at exit for the others (the JAX package's
#: ``jax.distributed.shutdown`` barrier) before it leaves without them.
SHUTDOWN_TIMEOUT_S = 60.0


#: The rendezvous made before the default group exists, kept until
#: :func:`init_distributed` builds the group on it.
_pending = None
_exit_hook = False


def rendezvous(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None):
    """``(store, rank, world_size)`` of the default group, made (once)
    before the group exists when there is none, so that ranks may agree
    on something, such as which backend they can use, before they choose
    it.  Arguments as :func:`init_distributed`'s."""
    global _pending
    if dist.is_initialized():
        return default_store(), dist.get_rank(), dist.get_world_size()
    if _pending is None:
        if init_method is not None:
            _pending = next(dist.rendezvous(
                init_method, -1 if rank is None else rank,
                -1 if world_size is None else world_size))
        elif all(k in os.environ for k in _ENV):
            _pending = next(dist.rendezvous("env://"))
        else:
            _pending = (dist.HashStore(), 0, 1)
    return _pending


def init_distributed(backend: str = "gloo",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Initialize the default process group unless one exists; returns
    whether this call created it.  ``backend`` is ``"nccl"`` for CUDA
    devices and ``"gloo"`` for the CPU."""
    global _pending, _exit_hook
    if dist.is_initialized():
        return False
    store, rank, world_size = rendezvous(init_method, world_size, rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    _pending = None
    if not _exit_hook:
        atexit.register(_shutdown_gloo_groups)
        _exit_hook = True
    return True


def _shutdown_gloo_groups() -> None:
    """At exit, as ``MPI_Finalize`` or the JAX package's shutdown
    barrier: wait for every rank of a gloo default group, then destroy it
    (and so its subgroups) while the interpreter still runs.  Without the
    barrier a rank that is done would close its connections while a peer
    still waits for a message it posted; without the destroy a gloo
    worker thread that drops a finished collective's tensors once
    finalization has begun takes the GIL and aborts the process
    ("terminate called without an active exception").  A rank that does
    not come within :data:`SHUTDOWN_TIMEOUT_S` (it died) leaves the group
    as it is.  NCCL groups are left alone."""
    if not (dist.is_initialized() and dist.get_backend() == "gloo"):
        return
    try:
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=SHUTDOWN_TIMEOUT_S))
    except RuntimeError:
        return
    dist.destroy_process_group()


def default_store() -> "dist.Store":
    """The default process group's key-value store (the rendezvous every
    rank shares), for small exchanges before or beside the group's
    collectives."""
    return dist.distributed_c10d._get_default_store()
