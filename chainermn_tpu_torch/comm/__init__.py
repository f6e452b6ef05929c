"""Communicator factory of the port (``chainermn_tpu/comm/__init__.py``
``create_communicator``).

Every name of the JAX package is accepted.  In this slice the flat and
hierarchical names give a world-group communicator (NCCL's own rings and
trees do what the hierarchical mesh does on a TPU pod; intra/inter-node
subgroups come with ROADMAP Queue 1 item 4), ``naive`` a gloo group and
``dummy`` identity gradient reductions.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from chainermn_tpu_torch.comm.base import CommunicatorBase
from chainermn_tpu_torch.comm.process_group import (
    DummyCommunicator,
    ProcessGroupCommunicator,
)
from chainermn_tpu_torch.distributed import init_distributed
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["CommunicatorBase", "DummyCommunicator",
           "ProcessGroupCommunicator", "create_communicator"]

_HIERARCHICAL = {"hierarchical", "two_dimensional", "non_cuda_aware"}
_FLAT = {"xla", "pure_nccl", "flat", "single_node"}
NAMES = _HIERARCHICAL | _FLAT | {"naive", "dummy"}


def _wire_dtype(d) -> Optional[torch.dtype]:
    if d is None or isinstance(d, torch.dtype):
        return d
    name = getattr(d, "__name__", None) or getattr(d, "name", None) or str(d)
    dt = getattr(torch, str(name).replace("torch.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"allreduce_grad_dtype {d!r} is not a torch dtype")
    return dt


def create_communicator(communicator_name: str = "hierarchical",
                        device: Union[str, torch.device, None] = None,
                        allreduce_grad_dtype=None) -> CommunicatorBase:
    """A communicator over the default process group, which this call
    creates if none exists (NCCL for a CUDA device, gloo for the CPU).

    ``device`` None means this rank's CUDA device (``LOCAL_RANK`` under
    ``torchrun``) and raises where there is none; pass ``device="cpu"``
    for the CPU.  ``allreduce_grad_dtype`` (e.g. ``torch.bfloat16``) is
    the gradient wire dtype, for any name."""
    name = communicator_name
    if name not in NAMES:
        raise ValueError(f"unknown communicator name {name!r}")
    if device is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(device, "create_communicator")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed("nccl" if dev.type == "cuda" else "gloo")
    group = None
    if name == "naive" and dist.get_backend() != "gloo":
        group = dist.new_group(backend="gloo")
    cls = DummyCommunicator if name == "dummy" else ProcessGroupCommunicator
    return cls(dev, group=group,
               allreduce_grad_dtype=_wire_dtype(allreduce_grad_dtype),
               name=name)
