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
import time
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
        atexit.register(shutdown_distributed)
        _exit_hook = True
    return True


def _store_barrier(timeout_s: float) -> bool:
    """Every rank of the default group at this point, over the group's
    store (NCCL's barrier cannot time out): each rank counts itself in,
    waits for the world, then counts itself out, and rank 0 (whose
    process may serve the store) leaves last.  False when a rank did not
    come in time or the store is gone (a peer died)."""
    store, rank, world = default_store(), dist.get_rank(), \
        dist.get_world_size()
    deadline = time.monotonic() + timeout_s
    try:
        for key in ("cmn_torch/shutdown/in", "cmn_torch/shutdown/out"):
            store.add(key, 1)
            if key.endswith("out") and rank != 0:
                return True
            while int(store.add(key, 0)) < world:
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.005)
    except (RuntimeError, OSError):
        return False
    return True


def shutdown_distributed() -> None:
    """End the default group (the ``MPI_Finalize`` analog; the JAX
    package's ``shutdown_distributed``), for NCCL as for gloo; run at
    exit by the hook :func:`init_distributed` registers, and a no-op
    once the group is gone.  Every rank waits for the others first:
    without that a rank that is done would close its connections while a
    peer still waits for a message it posted, and a gloo worker thread
    that drops a finished collective's tensors once finalization has
    begun takes the GIL and aborts the process ("terminate called without
    an active exception").  A rank that does not come within
    :data:`SHUTDOWN_TIMEOUT_S` (it died) leaves the group as it is."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=SHUTDOWN_TIMEOUT_S))
        except RuntimeError:
            return
    elif not _store_barrier(SHUTDOWN_TIMEOUT_S):
        return
    # Every rank is here, so every posted send was received.
    from chainermn_tpu_torch.comm import process_group

    process_group._ORPHANED_SENDS.clear()
    dist.destroy_process_group()


def is_initialized() -> bool:
    """Whether the default process group exists."""
    return dist.is_initialized()


def default_store() -> "dist.Store":
    """The default process group's key-value store (the rendezvous every
    rank shares), for small exchanges before or beside the group's
    collectives."""
    return dist.distributed_c10d._get_default_store()
