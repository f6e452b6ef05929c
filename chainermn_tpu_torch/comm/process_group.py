"""Communicators over a ``torch.distributed`` process group: the port's
counterpart of ``XlaCommunicator`` and ``DummyCommunicator``
(``chainermn_tpu/comm/xla.py``).

One process drives one card, so a rank is a process.  The gradient
all-reduce follows the reference's ``pure_nccl`` path (SURVEY.md §2.2):
every gradient goes into one flat bucket in the wire dtype, one
``all_reduce`` sums it, and each gradient gets its slice back, cast to its
own dtype and scaled by ``1 / size``.  The collective runs even on one
rank, so it is on the path the training step takes.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from chainermn_tpu_torch.comm.base import CommunicatorBase

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "mean": dist.ReduceOp.SUM}


def _params(model):
    return list(model.parameters()) if isinstance(model, nn.Module) \
        else list(model)


class ProcessGroupCommunicator(CommunicatorBase):
    """Collectives over ``group`` (None: the default, world group) on
    ``device``; ``allreduce_grad_dtype`` is the gradient wire dtype (cast,
    reduce, cast back), None for the gradients' own."""

    def __init__(self, device: torch.device, group=None,
                 allreduce_grad_dtype: Optional[torch.dtype] = None,
                 name: str = "xla"):
        self.device = torch.device(device)
        self.group = group
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.name = name

    # ------------------------------------------------------------- ranks
    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def intra_size(self) -> int:
        return int(os.environ.get("LOCAL_WORLD_SIZE", self.size))

    @property
    def intra_rank(self) -> int:
        return int(os.environ.get("LOCAL_RANK", self.rank % self.intra_size))

    @property
    def inter_size(self) -> int:
        return max(self.size // self.intra_size, 1)

    @property
    def inter_rank(self) -> int:
        return self.rank // self.intra_size

    @property
    def axis_name(self):
        """The process group of this communicator's ranks: what a model
        takes as ``axis_name`` for collectives inside its forward
        (sync-BN), as the JAX package passes its mesh axis name."""
        return dist.group.WORLD if self.group is None else self.group

    def _src(self, root: int) -> int:
        return root if self.group is None else \
            dist.get_global_rank(self.group, root)

    # ------------------------------------------------------- collectives
    def allreduce_grad(self, model) -> None:
        params = _params(model)
        for p in params:
            if p.grad is None:  # every rank reduces the same layout
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if not grads:
            return
        wire = self.allreduce_grad_dtype or (
            grads[0].dtype if len({g.dtype for g in grads}) == 1
            else torch.float32)
        bucket = torch.cat([g.reshape(-1).to(wire) for g in grads])
        dist.all_reduce(bucket, group=self.group)
        size = self.size
        at = 0
        for g in grads:
            n = g.numel()
            g.copy_(bucket[at:at + n].view(g.shape).to(g.dtype) / size)
            at += n

    def allreduce(self, x: Any, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks (``sum``/``mean``/``max``/``min``/
        ``prod``), as a new tensor on the communicator's device."""
        if op not in _OPS:
            raise ValueError(f"op={op!r}: expected one of {sorted(_OPS)}")
        t = torch.as_tensor(x, device=self.device).clone()
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t / self.size if op == "mean" else t

    def bcast_data(self, data: Any, root: int = 0) -> Any:
        """Broadcast a module's parameters and buffers, or a tensor, from
        ``root`` in place; returns ``data``."""
        src = self._src(root)
        tensors = ([*data.parameters(), *data.buffers()]
                   if isinstance(data, nn.Module) else [data])
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=src, group=self.group)
        return data

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=self._src(root),
                                   group=self.group,
                                   device=self.device
                                   if self.device.type == "cuda" else None)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class DummyCommunicator(ProcessGroupCommunicator):
    """Identity gradient reduction (each rank keeps its own gradients):
    the communication-cost ablation of the JAX package.  Benchmarking
    only."""

    def allreduce_grad(self, model) -> None:
        for p in _params(model):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
