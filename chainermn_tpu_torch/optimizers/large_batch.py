"""Large-batch training: LARS and LAMB with layer-wise trust ratios, linear
LR scaling and warmup schedules -- the port of
``chainermn_tpu/optimizers/large_batch.py``.

* :func:`linear_scaled_lr` -- Goyal et al.'s rule, ``base_lr · global_batch
  / base_batch``.
* :func:`warmup_cosine_schedule` -- a linear ramp then cosine decay, as
  the optax schedules the JAX package joins, evaluated on a step-count
  tensor on the card (or a Python number).
* :func:`lars` / :func:`lamb` -- factories of :class:`Lars` / :class:`Lamb`
  (``torch.optim.Optimizer`` s following ``optax.lars`` and
  ``optax.lamb``'s arithmetic, :mod:`~chainermn_tpu_torch.optimizers.
  rules`), with the JAX package's masks: weight decay (and LARS's trust
  ratio) on "kernels" only, the leaves of rank >= 2.

:func:`kernel_mask` gives that mask for a port model by the rank its
parameter has in the JAX package, read off the model's weight bridge:
the port keeps a Flax ``DenseGeneral`` bias such as the fused ``qkv``'s
``(3, H, Dh)`` flat, so rank alone would exempt what the JAX package
decays.  Without a mask the rules use the port's ranks.  As in the JAX
package, LARS/LAMB need the whole layer's norms: use the replicated
optimizer, not ZeRO.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from chainermn_tpu_torch.optimizers.rules import (
    LearningRate,
    OptaxRule,
    adam_direction,
    adam_state,
    trust_ratio,
)
from chainermn_tpu_torch.utils.bridge import flax_shapes

__all__ = ["Lamb", "Lars", "kernel_mask", "lamb", "lars",
           "linear_scaled_lr", "warmup_cosine_schedule"]


def kernel_mask(model: nn.Module, to_flax: Optional[Callable] = None
                ) -> Dict[nn.Parameter, bool]:
    """``{parameter: is_kernel}``: True for leaves of rank >= 2 in the JAX
    package's layout (conv, dense and embedding weights, position tables,
    the ``DenseGeneral`` projection biases), False for biases and
    normalization scales and shifts.  The layout is the bridge's:
    ``to_flax`` is the model's mapping in :mod:`chainermn_tpu_torch.utils.
    bridge` (see :func:`~chainermn_tpu_torch.utils.bridge.flax_shapes`);
    None takes the port's ranks."""
    shapes = {} if to_flax is None else flax_shapes(model, to_flax)
    return {p: len(shapes.get(p, p.shape)) >= 2 for p in model.parameters()}


def linear_scaled_lr(base_lr: float, global_batch: int,
                     base_batch: int = 256) -> float:
    """``base_lr * global_batch / base_batch`` (``base_lr`` is the LR
    known good at ``base_batch``)."""
    if global_batch <= 0 or base_batch <= 0:
        raise ValueError(f"batch sizes must be positive, got "
                         f"{global_batch=} {base_batch=}")
    return base_lr * (global_batch / float(base_batch))


def _count(count) -> torch.Tensor:
    return torch.as_tensor(count, dtype=torch.float32)


def _linear(init: float, end: float, steps: int) -> Callable:
    """``optax.linear_schedule``."""
    if steps <= 0:
        return lambda count: torch.full_like(_count(count), init)

    def schedule(count):
        c = _count(count).clamp(0, steps)
        return (init - end) * (1 - c / steps) + end

    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable:
    """``optax.cosine_decay_schedule`` (exponent 1)."""

    def schedule(count):
        c = torch.clamp_max(_count(count), float(steps))
        decay = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable:
    """``optax.join_schedules`` of two schedules."""

    def schedule(count):
        c = _count(count)
        return torch.where(c < boundary, first(c), second(c - boundary))

    return schedule


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, *, warmup_factor: float = 0.0,
                           end_lr: float = 0.0) -> Callable:
    """Linear ramp ``warmup_factor · peak_lr -> peak_lr`` over
    ``warmup_steps``, cosine decay to ``end_lr`` over the remainder
    (``optax.warmup_cosine_decay_schedule``); ``total_steps ==
    warmup_steps`` is the ramp then constant, both 0 a constant.  The
    result maps a step count (a tensor on any device, or a number) to a
    0-d fp32 tensor on the count's device."""
    if total_steps < warmup_steps:
        raise ValueError(
            f"total_steps ({total_steps}) < warmup_steps ({warmup_steps})")
    ramp = _linear(warmup_factor * peak_lr, peak_lr, warmup_steps)
    if total_steps == warmup_steps:
        const = _linear(peak_lr, peak_lr, 0)
        return const if warmup_steps == 0 else _join(ramp, const,
                                                     warmup_steps)
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr
    return _join(ramp, _cosine(peak_lr, total_steps - warmup_steps, alpha),
                 warmup_steps)


class Lars(OptaxRule):
    """``optax.lars``: ``u = g + weight_decay · p`` (kernels), ``u *=
    trust_ratio`` with ``trust_coefficient`` and ``eps`` (kernels; 1 at a
    zero norm), ``u *= -lr(count)``, then the trace ``t = u + momentum ·
    t``, the update ``t`` (nesterov: ``u + momentum · t``).  Rank < 2
    leaves take plain momentum SGD."""

    def __init__(self, params, learning_rate: LearningRate,
                 weight_decay: float = 1e-4, momentum: float = 0.9,
                 trust_coefficient: float = 0.001, nesterov: bool = False,
                 eps: float = 0.0, mask=None):
        super().__init__(params, learning_rate, mask,
                         weight_decay=weight_decay, momentum=momentum,
                         trust_coefficient=trust_coefficient,
                         nesterov=nesterov, eps=eps)

    def init_state(self, p, group):
        return {"trace": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        u = g
        if self.is_kernel(p):
            u = u + group["weight_decay"] * p
            u = u * trust_ratio(u, p, group["trust_coefficient"],
                                group["eps"])
        u = u * -self.lr(group, state["step"])
        t = state["trace"]
        t.copy_(u + group["momentum"] * t)
        return u + group["momentum"] * t if group["nesterov"] else t


class Lamb(OptaxRule):
    """``optax.lamb``: the Adam direction, plus ``weight_decay · p`` on
    kernels, times the trust ratio on every leaf (coefficient 1, 1 at a
    zero norm), times ``-lr(count)``."""

    def __init__(self, params, learning_rate: LearningRate,
                 weight_decay: float = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6, mask=None):
        super().__init__(params, learning_rate, mask,
                         weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)

    def init_state(self, p, group):
        return adam_state(p)

    def update(self, p, g, state, group):
        u = adam_direction(g, state, group["b1"], group["b2"], group["eps"])
        if self.is_kernel(p):
            u = u + group["weight_decay"] * p
        u = u * trust_ratio(u, p)
        return u * -self.lr(group, state["step"])


def lars(learning_rate: LearningRate, *, weight_decay: float = 1e-4,
         momentum: float = 0.9, trust_coefficient: float = 0.001,
         nesterov: bool = False, eps: float = 0.0,
         mask: Optional[Dict[nn.Parameter, bool]] = None):
    """A :class:`Lars` factory (``params -> optimizer``) with the JAX
    package's defaults; ``mask`` from :func:`kernel_mask` (None: the
    port's ranks)."""
    return lambda params: Lars(params, learning_rate,
                               weight_decay=weight_decay, momentum=momentum,
                               trust_coefficient=trust_coefficient,
                               nesterov=nesterov, eps=eps, mask=mask)


def lamb(learning_rate: LearningRate, *, weight_decay: float = 1e-2,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         mask: Optional[Dict[nn.Parameter, bool]] = None):
    """A :class:`Lamb` factory with the JAX package's defaults; weight
    decay on the kernels of ``mask`` (None: the port's ranks)."""
    return lambda params: Lamb(params, learning_rate,
                               weight_decay=weight_decay, b1=b1, b2=b2,
                               eps=eps, mask=mask)
