"""The optimizers' updates in plain PyTorch, as ``torch.optim`` defines
them, on ``{name: tensor}`` dicts updated in place."""

from __future__ import annotations

from typing import Dict

import torch


class SGD:
    """``p -= lr · buf``, ``buf = g`` at the first step, then ``buf =
    momentum · buf + g`` (no dampening, no weight decay)."""

    def __init__(self, lr: float, momentum: float = 0.0, **_):
        self.lr, self.momentum = lr, momentum
        self.buf: Dict[str, torch.Tensor] = {}

    def step(self, w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]):
        for k, p in w.items():
            b = self.buf.get(k)
            b = g[k].clone() if b is None else b.mul_(self.momentum).add_(g[k])
            self.buf[k] = b
            p.sub_(self.lr * b)

    def first_grad(self, k: str):
        """The first step's gradient, worked out from the state after
        it: ``(state tensor, scale)``, the gradient their product."""
        return self.buf[k], 1.0


class AdamW:
    """Decoupled weight decay, then the bias-corrected Adam step."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, **_):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, \
            weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in w.items():
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g[k], alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g[k], g[k], value=1 - self.b2)
            p.addcdiv_(m, (v / c2).sqrt_().add_(self.eps),
                       value=-self.lr / c1)

    def first_grad(self, k: str):
        return self.m[k], 1.0 / (1 - self.b1)


OPTIMIZERS = {"sgd": SGD, "adamw": AdamW}


def build(spec: dict):
    """The optimizer a traffic file names (``{"name": ..., ...}``)."""
    kw = {k: v for k, v in spec.items() if k != "name"}
    return OPTIMIZERS[spec["name"]](**kw)
