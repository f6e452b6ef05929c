"""Update rules that follow optax's arithmetic, capturable on the card.

``torch.optim`` has no LARS and no LAMB, its ``Adafactor`` computes
another update than ``optax.adafactor``, and its SGD takes a
learning-rate schedule only from the host.  The rules here are
``torch.optim.Optimizer`` subclasses that compute the optax update
transform by transform, in the parameter's dtype, with every quantity on
the parameter's device: the step count is a 0-d fp32 tensor in each
parameter's state, a learning-rate schedule is evaluated on it
(:func:`~chainermn_tpu_torch.optimizers.large_batch.
warmup_cosine_schedule` returns such a function), and trust ratios and
their zero-norm guards are ``torch.where`` on the device.  No step reads
a value back to the host, so the captured train step records the update
whole, schedule included.  The state is built at the first step.

:class:`OptaxRule` is the shared frame: the learning rate (a float, or a
schedule of the step count), the kernel mask (a dict ``{parameter:
bool}``; None: rank >= 2, the JAX package's ``kernel_mask`` on the port's
shapes) and one ``update`` per parameter.  This module holds
:class:`Adafactor`, :class:`RMSProp` and the scheduled form of optax's
``sgd``;
:mod:`~chainermn_tpu_torch.optimizers.large_batch` holds LARS and LAMB.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

LearningRate = Union[float, Callable]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The Frobenius norm over every element (``jnp.linalg.norm`` of the
    flattened array)."""
    return torch.linalg.vector_norm(x)


def trust_ratio(update: torch.Tensor, param: torch.Tensor,
                coefficient: float = 1.0, eps: float = 0.0) -> torch.Tensor:
    """``optax.scale_by_trust_ratio``'s factor: ``coefficient * |p| / (|u|
    + eps)``, 1 where either norm is zero, as a 0-d tensor on the
    parameter's device."""
    pn, un = _norm(param), _norm(update)
    ratio = coefficient * pn / (un + eps)
    return torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio),
                       ratio)


class OptaxRule(torch.optim.Optimizer):
    """One optax chain as a torch optimizer (see the module docstring).
    Subclasses define :meth:`init_state` and :meth:`update`; ``step()``
    applies ``p += update`` to every parameter with a gradient."""

    def __init__(self, params, learning_rate: LearningRate,
                 mask: Optional[Dict[torch.Tensor, bool]] = None,
                 **defaults):
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = 0.0 if self.schedule is not None else float(learning_rate)
        super().__init__(params, dict(lr=lr, capturable=True, **defaults))
        self._mask = None if mask is None else {id(p): bool(v)
                                                for p, v in mask.items()}

    def is_kernel(self, p: torch.Tensor) -> bool:
        if self._mask is None:
            return p.dim() >= 2
        return self._mask[id(p)]

    def lr(self, group, count: torch.Tensor):
        """The learning rate at step ``count`` (the schedule's count, from
        0): a device tensor under a schedule, else the group's float."""
        return self.schedule(count) if self.schedule is not None \
            else group["lr"]

    def init_state(self, p: torch.Tensor, group) -> dict:
        return {}

    def update(self, p, g, state, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state.update(self.init_state(p, group))
                p.add_(self.update(p, p.grad.to(p.dtype), state, group))
                state["step"] += 1
        return loss


class ScheduledSGD(OptaxRule):
    """``optax.sgd(schedule, momentum, nesterov)``: ``t = g + momentum ·
    t``, the update ``-lr(count) · t`` (nesterov: ``g + momentum · t``);
    plain SGD when ``momentum`` is None.

    ``torch.optim.SGD`` cannot carry a schedule inside a captured step:
    its for-each and per-tensor forms read a tensor learning rate back to
    the host (``alpha=-lr``), and it keeps no step count for a schedule to
    read (``adamw`` reads torch AdamW's)."""

    def __init__(self, params, learning_rate: LearningRate,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, learning_rate, momentum=momentum,
                         nesterov=nesterov)

    def init_state(self, p, group):
        if group["momentum"] is None:
            return {}
        return {"trace": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        mom = group["momentum"]
        u = g
        if mom is not None:
            t = state["trace"]
            t.copy_(g + mom * t)
            u = g + mom * t if group["nesterov"] else t
        return u * -self.lr(group, state["step"])


class RMSProp(OptaxRule):
    """``optax.rmsprop(learning_rate, decay, eps)`` at its defaults
    (``initial_scale`` 0, ``eps_in_sqrt``, not centered, no momentum):
    ``nu = (1 - decay) · g² + decay · nu``, the update ``-lr · g ·
    rsqrt(nu + eps)``.  ``torch.optim.RMSprop`` adds ``eps`` outside the
    square root, which moves small moments' updates by up to a third."""

    def __init__(self, params, learning_rate: LearningRate,
                 decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, learning_rate, decay=decay, eps=eps)

    def init_state(self, p, group):
        return {"nu": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        nu, decay = state["nu"], group["decay"]
        nu.copy_((1 - decay) * (g * g) + decay * nu)
        return g * torch.rsqrt(nu + group["eps"]) \
            * -self.lr(group, state["step"])


def adam_direction(g, state, b1: float, b2: float, eps: float,
                   eps_root: float = 0.0) -> torch.Tensor:
    """``optax.scale_by_adam``: the moments advanced in ``state`` (``mu``,
    ``nu``) and the bias-corrected direction ``mu_hat / (sqrt(nu_hat +
    eps_root) + eps)`` at count ``step + 1``."""
    mu, nu = state["mu"], state["nu"]
    mu.copy_((1 - b1) * g + b1 * mu)
    nu.copy_((1 - b2) * (g * g) + b2 * nu)
    count = state["step"] + 1
    mu_hat = mu / (1 - b1 ** count).to(mu.dtype)
    nu_hat = nu / (1 - b2 ** count).to(nu.dtype)
    return mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)


def adam_state(p) -> dict:
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}


#: ``optax.adafactor``'s defaults, the JAX ``train_lm``'s: the smaller of
#: the two largest axes a factored moment needs, the decay exponent, the
#: epsilon added to the squared gradient, the update's block-rms clip and
#: the floor of the parameter scale.
FACTOR_MIN_DIM, DECAY_RATE, EPS, CLIP, MIN_SCALE = 128, 0.8, 1e-30, 1.0, 1e-3


class Adafactor(OptaxRule):
    """``optax.adafactor(learning_rate)`` at its defaults (the JAX
    ``train_lm``'s): factored second moments over the two largest axes
    when the smaller of them has at least 128 elements (row and column
    statistics, else a full one), decay ``1 - (count + 1) ** -0.8``,
    ``1e-30`` added to the squared gradient, the update clipped to a
    block rms of 1, times the learning rate and ``max(rms(p), 1e-3)``,
    negated.  No momentum and no weight decay (optax's defaults).

    The factored axes are those of the JAX layout: ``shapes`` (the
    bridge's :func:`~chainermn_tpu_torch.utils.bridge.flax_shapes`) gives
    each parameter's Flax shape, and a parameter whose Flax rank differs
    is updated on that view: a ``DenseGeneral`` kernel ``(D, 3, H, Dh)``
    is the port's ``(3·H·Dh, D)`` weight, which would factor over other
    axes.  A 2-D weight's view is ``W.t().reshape(shape)`` (the bridge
    checks that its mapping transposes), any other a reshape.  At equal
    rank the Flax leaf permutes the port's axes (a ``Dense`` kernel's
    transpose, a conv's HWIO), which factors over the same two axes and
    gives the same update: the row and column statistics swap."""

    def __init__(self, params, learning_rate: LearningRate,
                 shapes: Optional[Dict[torch.Tensor, tuple]] = None):
        super().__init__(params, learning_rate)
        self._shapes = {id(p): tuple(s) for p, s in (shapes or {}).items()
                        if len(s) != p.dim()}

    def _view(self, t, p):
        """``t`` (shaped as ``p``) in the Flax layout of ``p``."""
        shape = self._shapes.get(id(p))
        if shape is None:
            return t
        return (t.t() if t.dim() == 2 else t).reshape(shape)

    @staticmethod
    def factored_dims(shape):
        """``(d1, d0)``: the second-largest and the largest axis (ties by
        position, as numpy's ``argsort``), or None for a full moment."""
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
        if shape[order[-2]] < FACTOR_MIN_DIM:
            return None
        return order[-2], order[-1]

    def init_state(self, p, group):
        p = self._view(p, p)
        dims = self.factored_dims(p.shape)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": torch.zeros_like(p.sum(dim=d0)),
                "v_col": torch.zeros_like(p.sum(dim=d1))}

    def update(self, p, g, state, group):
        u = self._update(self._view(p, p), self._view(g, p), state, group)
        if id(p) not in self._shapes:
            return u
        return u.reshape(p.shape[::-1]).t() if p.dim() == 2 \
            else u.reshape(p.shape)

    def _update(self, p, g, state, group):
        step = state["step"]
        decay = (1.0 - (step + 1) ** -DECAY_RATE).to(p.dtype)
        g2 = g * g + EPS
        dims = self.factored_dims(p.shape)
        if dims is None:
            v = state["v"]
            v.copy_(decay * v + (1.0 - decay) * g2)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            vr, vc = state["v_row"], state["v_col"]
            vr.copy_(decay * vr + (1.0 - decay) * g2.mean(dim=d0))
            vc.copy_(decay * vc + (1.0 - decay) * g2.mean(dim=d1))
            rd1 = d1 - 1 if d1 > d0 else d1
            row = (vr / vr.mean(dim=rd1, keepdim=True)) ** -0.5
            u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
        u = u / torch.clamp_min(torch.sqrt((u * u).mean()) / CLIP, 1.0)
        u = u * self.lr(group, step)
        rms_p = torch.sqrt((p * p).mean())
        u = u * torch.where(rms_p <= MIN_SCALE,
                            torch.full_like(rms_p, MIN_SCALE), rms_p)
        return -u
