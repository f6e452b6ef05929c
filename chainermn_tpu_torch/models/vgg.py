"""VGG, the model-parallel example family of the port
(``chainermn_tpu/models/vgg.py``).

BASELINE.json configuration 4: model-parallel VGG through
``MultiNodeChainList``.  The network is a flat list of ops (3×3 conv +
ReLU, 2×2 max-pool) cut into contiguous stages, plus a head (global
average pool, ``Dense(hidden)`` + ReLU, ``Dense(num_classes)``) as the
last stage.  The same stage modules compose into the one-process oracle
(:func:`apply_sequential`), into a chain with one stage per rank
(:func:`build_chain`) and into a GPipe pipeline over the same ranks
(:func:`build_hetero_pipeline`, the configuration's distributed-speedup
tier), so all three share parameters exactly.

Stages take and return NHWC activations, as the JAX package's do; inside,
each runs its convolutions on an NCHW view in ``channels_last`` memory
(no copy at the stage boundary).  Weights follow Flax's initializers
(LeCun-normal kernels, zero biases) from a seed per stage, drawn on the
CPU, so every process builds the same stage.  The bridge is
:func:`~chainermn_tpu_torch.utils.bridge.vgg_stage_params_from_flax`.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.links.chain_list import (
    HeteroPipelineChain,
    MultiNodeChainList,
)
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["VGG_CFGS", "VGGHead", "VGGStage", "apply_sequential",
           "build_chain", "vgg_loss", "vgg_stage_modules", "vgg_stage_ops"]

#: op lists: widths and "M" (max-pool); the head is appended as its own
#: stage.
VGG_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
}

#: Flax's truncated normal draws N(0, 1) cut at ±2; dividing the standard
#: deviation by this keeps the variance asked for.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def _generator(seed: int, stage: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed) * 1009 + int(stage))
    return g


class VGGStage(nn.Module):
    """A contiguous run of conv/ReLU/pool ops (one pipeline stage), NHWC in
    and out; ``in_channels`` is the channel count flowing in."""

    def __init__(self, ops: Sequence[Tuple[str, int]], in_channels: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, stage: int = 0):
        super().__init__()
        dev = resolve_device(device, "VGGStage")
        self.ops = tuple((str(k), int(w)) for k, w in ops)
        self.dtype = dtype
        self.convs = nn.ModuleList()
        g = _generator(seed, stage)
        c = in_channels
        for kind, w in self.ops:
            if kind == "conv":
                conv = nn.Conv2d(c, w, 3, padding=1)
                with torch.no_grad():
                    _lecun_normal_(conv.weight, 9 * c, g)
                    conv.bias.zero_()
                self.convs.append(conv)
                c = w
            elif kind != "pool":
                raise ValueError(kind)
        self.out_channels = c
        self.to(device=dev, dtype=dtype,
                memory_format=torch.channels_last)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        convs = iter(self.convs)
        for kind, _ in self.ops:
            if kind == "conv":
                x = F.relu(next(convs)(x))
            else:
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1)


class VGGHead(nn.Module):
    """Global average pool and an MLP classifier (the dense tail); the
    logits are float32."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 512,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0, stage: int = 0):
        super().__init__()
        dev = resolve_device(device, "VGGHead")
        self.dtype = dtype
        self.fc1 = nn.Linear(in_channels, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)
        g = _generator(seed, stage)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2):
                _lecun_normal_(fc.weight, fc.in_features, g)
                fc.bias.zero_()
        self.to(device=dev, dtype=dtype)

    def forward(self, x):
        x = x.to(self.dtype).mean(dim=(1, 2))
        x = F.relu(self.fc1(x))
        return self.fc2(x).float()


def vgg_stage_ops(cfg: Union[str, Sequence] = "vgg11", n_stages: int = 4,
                  width_mult: float = 1.0) -> List[List[Tuple[str, int]]]:
    """The op lists of the ``n_stages - 1`` conv stages, cut as the JAX
    package cuts them (``np.array_split`` of the op list)."""
    ops_cfg = VGG_CFGS[cfg] if isinstance(cfg, str) else list(cfg)
    ops: List[Tuple[str, int]] = []
    for w in ops_cfg:
        ops.append(("pool", 0) if w == "M"
                   else ("conv", max(int(w * width_mult), 1)))
    if n_stages < 2:
        raise ValueError("need at least 2 stages (conv stages + head)")
    chunks = np.array_split(np.arange(len(ops)), n_stages - 1)
    return [[ops[i] for i in c] for c in chunks]


def vgg_stage_modules(cfg: Union[str, Sequence] = "vgg11",
                      num_classes: int = 10, n_stages: int = 4,
                      width_mult: float = 1.0,
                      dtype: torch.dtype = torch.float32, device=None,
                      seed: int = 0, in_channels: int = 3,
                      stages: Optional[Sequence[int]] = None
                      ) -> List[Optional[nn.Module]]:
    """The ``n_stages`` stage modules (conv stages, then the head) whose
    sequential composition is the whole network.  ``stages`` limits which
    are built (the others are None): a rank of a chain builds its own
    only.  ``device`` None means the current CUDA device."""
    conv_ops = vgg_stage_ops(cfg, n_stages, width_mult)
    want = set(range(n_stages) if stages is None else stages)
    out: List[Optional[nn.Module]] = []
    c = in_channels
    for s, ops in enumerate(conv_ops):
        out.append(VGGStage(ops, c, dtype=dtype, device=device, seed=seed,
                            stage=s) if s in want else None)
        c = next((w for k, w in reversed(ops) if k == "conv"), c)
    out.append(VGGHead(num_classes, c, dtype=dtype, device=device,
                       seed=seed, stage=n_stages - 1)
               if n_stages - 1 in want else None)
    return out


def apply_sequential(modules: Sequence[nn.Module], x):
    """The one-process oracle: the stages applied back to back."""
    for m in modules:
        x = m(x)
    return x


def build_chain(modules: Sequence[Optional[nn.Module]], comm
                ) -> MultiNodeChainList:
    """Place stage ``s`` on rank ``s`` of ``comm`` through a
    :class:`~chainermn_tpu_torch.links.MultiNodeChainList` (reference:
    ``add_link(link, rank_in, rank_out)`` chains); ``modules`` may hold
    None for the stages other ranks own."""
    S = len(modules)
    if S > comm.size:
        raise ValueError(f"{S} stages > {comm.size} ranks")
    chain = MultiNodeChainList(comm)
    for s, m in enumerate(modules):
        chain.add_link(m, rank=s, rank_in=s - 1 if s > 0 else None,
                       rank_out=s + 1 if s < S - 1 else None)
    return chain


def build_hetero_pipeline(modules: Sequence[Optional[nn.Module]], comm,
                          sample_input, n_microbatches: int = 4
                          ) -> HeteroPipelineChain:
    """The VGG chain on :class:`~chainermn_tpu_torch.links.
    HeteroPipelineChain` (the JAX package's ``build_hetero_pipeline``):
    rank ``s`` of ``comm`` runs stage ``s`` on GPipe microbatches.
    ``modules`` holds this rank's stage (the others may be None);
    ``sample_input`` is one example batch, ``(1, H, W, C)`` or more rows,
    from which each stage's activation shapes are read: the owner of
    stage ``s`` runs it on one row of zeros and broadcasts the shape, so
    no rank needs another's stage."""
    S = len(modules)
    if S != comm.size:
        raise ValueError(
            f"{S} stages must equal the stage-axis size {comm.size}")
    in_shape = tuple(sample_input.shape[1:])
    io_shapes = []
    for s in range(S):
        out = None
        if comm.rank == s:
            m = modules[s]
            p = next(m.parameters(), None)
            with torch.no_grad():
                y = m(torch.zeros((1, *in_shape), device=comm.device,
                                  dtype=p.dtype if p is not None
                                  else torch.float32))
            out = tuple(y.shape[1:])
        out = tuple(comm.bcast_obj(out, root=s))
        io_shapes.append((in_shape, out))
        in_shape = out
    return HeteroPipelineChain(comm, list(modules), io_shapes,
                               n_microbatches)


def vgg_loss(logits: torch.Tensor, labels) -> Tuple[torch.Tensor, Any]:
    """Softmax cross-entropy over integer labels (mean) and the accuracy,
    the example's loss."""
    y = torch.as_tensor(labels, device=logits.device).long()
    loss = F.cross_entropy(logits.float(), y)
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc
