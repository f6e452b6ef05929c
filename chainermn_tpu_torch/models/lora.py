"""LoRA (low-rank adaptation) fine-tuning: the port of
``chainermn_tpu/models/lora.py`` in PyTorch's idiom.

The JAX package transforms a parameter tree: ``lora_init`` builds an
adapter tree beside the frozen base, and ``lora_merge`` forms ``kernel +
(alpha / rank) * A @ B`` inside the jitted step.  Here :func:`lora_init`
freezes the base model (``requires_grad=False``) and registers on every
targeted ``nn.Linear`` weight a parametrization
(``torch.nn.utils.parametrize``) that returns the merged weight, so every
read of the weight inside the step merges: a captured train step records
the merge, remat's recomputation in the backward merges again, and
autograd reaches only the adapters.  It returns a :class:`LoRA` module
that holds the adapters as its only parameters and the base beside them
(not as a submodule).  So the adapters are all that the optimizer,
``allreduce_grad``, the captured step's snapshot and the checkpointer
see; the base, and the losses built for it, run merged.

Layouts.  At a targeted ``nn.Linear`` of ``in_features`` x
``out_features``, ``a`` is ``(in, rank)`` (normal, std 1/sqrt(rank)) and
``b`` ``(rank, out)`` (zeros: step 0 computes the base model exactly), the
JAX package's ``(prod_in, rank)`` / ``(rank, prod_out)`` for the same
layer (its ``_split_shape``); the merged weight is ``W + scale * (A @
B).T``, since ``nn.Linear`` keeps ``(out, in)`` where Flax keeps ``(in,
out)``.  The port's fused projections flatten their output (``qkv``) or
input (``proj``) axes in the Flax order, so the transposed product lands
on the same entries.

Example::

    base = TransformerLM(..., device="cuda")
    lora = lora_init(base, rank=16)                  # adapters only
    opt = create_multi_node_optimizer(adamw(1e-4), comm)
    state = opt.init(lora)                           # state: adapters only
    step = opt.make_train_step(make_lora_loss(lm_loss(base)), has_aux=True)
    state, metrics = step(state, batch)
    merged = lora_merge(lora)                        # export: a plain model
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

#: names of the modules that get an adapter by default: the attention
#: projections (the fused ``qkv`` layout does not split q from v).
DEFAULT_TARGETS: Tuple[str, ...] = ("qkv", "q", "kv", "proj")

def _targets(model: nn.Module, targets: Sequence[str]
             ) -> Iterator[Tuple[str, nn.Linear]]:
    """``(path, linear)`` of every ``nn.Linear`` whose own name is a
    target, in registration order."""
    for path, mod in model.named_modules():
        if isinstance(mod, nn.Linear) and path.rsplit(".", 1)[-1] in targets:
            yield path, mod


class _Adapter(nn.Module):
    """A weight's parametrization: ``W -> W + scale * (a @ b).T``, the
    delta cast to the weight's dtype."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, scale: float):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.scale = scale

    def forward(self, weight):
        delta = (self.a @ self.b).t() * self.scale
        return weight + delta.to(weight.dtype)


class LoRA(nn.Module):
    """Adapters over a frozen base model (see the module docstring).

    ``adapters`` mirrors the base's module paths (``adapters.blocks.0.qkv.
    a`` adapts ``blocks.0.qkv.weight``); ``base`` is the model, which runs
    merged; ``forward(*args)`` is its forward.  ``alpha`` defaults to the
    rank (scale 1)."""

    def __init__(self, base: nn.Module, adapters: Dict[str, Tuple[
            torch.Tensor, torch.Tensor]], alpha: Optional[float] = None):
        super().__init__()
        base.requires_grad_(False)
        # Not a submodule: the base's weights are no parameters of this
        # module (the optimizer, the reduction and checkpoints skip them).
        self.__dict__["base"] = base
        self.adapters = nn.ModuleDict()
        self.paths = list(adapters)
        for path, (a, b) in adapters.items():
            rank = a.shape[-1]
            ad = _Adapter(a, b, (alpha if alpha is not None else rank) / rank)
            parametrize.register_parametrization(base.get_submodule(path),
                                                 "weight", ad)
            node = self.adapters
            parts = path.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = nn.ModuleDict()
                node = node[p]
            node[parts[-1]] = ad

    def adapter(self, path: str) -> _Adapter:
        node = self.adapters
        for p in path.split("."):
            node = node[p]
        return node

    def forward(self, *args, **kwargs):
        return self.base(*args, **kwargs)


def lora_init(model: nn.Module, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS,
              dtype=torch.float32, alpha: Optional[float] = None,
              seed: int = 0) -> LoRA:
    """Freeze ``model`` and wrap it with rank-``rank`` adapters at every
    ``nn.Linear`` named in ``targets``: ``a`` ``(in, rank)`` normal with
    std ``1/sqrt(rank)`` from ``seed``, ``b`` ``(rank, out)`` zeros,
    ``dtype`` fp32 whatever the base's dtype (the delta is cast at the
    merge).  For a conv net pass explicit ``targets`` (ResNet's shortcut is
    also named ``proj``, but is no ``nn.Linear`` and is never matched)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    found = list(_targets(model, tuple(targets)))
    if not found:
        raise ValueError(
            f"no nn.Linear matched targets {tuple(targets)}: check the "
            "module names against the model")
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    adapters = {}
    for path, lin in found:
        a = torch.randn((lin.in_features, rank), generator=g, device=dev,
                        dtype=dtype) / math.sqrt(rank)
        b = torch.zeros((rank, lin.out_features), device=dev, dtype=dtype)
        adapters[path] = (a, b)
    return LoRA(model, adapters, alpha)


@torch.no_grad()
def lora_merge(lora: LoRA) -> nn.Module:
    """The merged export: a copy of the base model with plain weights,
    each adapted one ``W + scale * (A @ B).T`` (every other tensor copied
    unchanged), ready for evaluation and generation as a fully fine-tuned
    model."""
    merged = copy.deepcopy(lora.base)
    for path in lora.paths:
        parametrize.remove_parametrizations(merged.get_submodule(path),
                                            "weight",
                                            leave_parametrized=True)
    return merged


def make_lora_loss(loss_fn: Callable) -> Callable:
    """``loss_fn(model, batch)`` of the base model as a loss of the
    :class:`LoRA` module: the train step differentiates, reduces and
    updates the adapters only, and the merge runs inside the step."""

    def wrapped(lora: LoRA, batch):
        return loss_fn(lora.base, batch)

    return wrapped


def lora_param_count(module: nn.Module) -> int:
    """The parameter count of ``module``: of a :class:`LoRA`, its
    adapters (the trainable parameters)."""
    return sum(p.numel() for p in module.parameters())
