"""Process-group bootstrap of the port (the counterpart of
``chainermn_tpu/distributed.py`` ``init_distributed``).

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) the default group comes from the environment; a
caller may instead give an ``init_method`` such as
``tcp://localhost:<port>`` with ``world_size`` and ``rank``; with neither,
the program is one rank and the group is built over an in-process
``HashStore``, so the collectives of the training step still run.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str = "gloo",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Initialize the default process group unless one exists; returns
    whether this call created it.  ``backend`` is ``"nccl"`` for CUDA
    devices and ``"gloo"`` for the CPU."""
    if dist.is_initialized():
        return False
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif all(k in os.environ for k in _ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True
