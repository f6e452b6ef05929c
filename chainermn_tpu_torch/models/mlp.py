"""MLP classifier: the port of ``chainermn_tpu/models/mlp.py``, the
reference MNIST example's model (``examples/mnist/train_mnist.py``,
``class MLP(chainer.Chain)``: two hidden ReLU layers and a linear head).

Parameters are fp32 ``nn.Linear`` layers in ``layers`` (``layers.i``
carries Flax's ``Dense_i``; its ``weight`` is the transposed ``(in,
out)`` kernel, see ``utils.mlp_params_from_flax``), initialized as Flax's
``Dense`` is: LeCun-normal kernels (a normal cut at two standard
deviations, variance 1 / fan_in) and zero biases, from ``seed``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["MLP", "classification_loss", "classification_metrics"]

#: Flax's truncated normal draws N(0, 1) cut at +-2 and divides the
#: standard deviation by this to keep the variance asked for.
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    """``hidden`` ReLU layers then a linear head of ``n_out`` logits over
    flattened ``in_features``-wide inputs (784 for MNIST)."""

    def __init__(self, hidden: Sequence[int] = (1000, 1000), n_out: int = 10,
                 in_features: int = 784, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device, "MLP")
        widths = [in_features, *hidden, n_out]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=torch.float32)
            for a, b in zip(widths[:-1], widths[1:]))
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for lin in self.layers:
            std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=g)
            lin.bias.zero_()

    def forward(self, x):
        x = torch.as_tensor(x, device=self.device, dtype=torch.float32)
        x = x.reshape(x.shape[0], -1)
        for lin in self.layers[:-1]:
            x = F.relu(lin(x))
        return self.layers[-1](x)


def classification_loss(model: nn.Module):
    """``loss_fn(model, (x, y)) -> (loss, {"accuracy": acc})``: the mean
    softmax cross-entropy over integer labels."""

    def loss_fn(m, batch):
        x, y = batch[0], batch[1]
        logits = m(x)
        y = torch.as_tensor(y, device=logits.device).long()
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"accuracy": acc.detach()}

    return loss_fn


def classification_metrics(model: nn.Module):
    """Evaluator metric function: PER-EXAMPLE ``val/loss`` and
    ``val/accuracy`` vectors (the evaluator masks and sums them)."""

    def metric_fn(m, batch):
        x, y = batch[0], batch[1]
        logits = m(x)
        y = torch.as_tensor(y, device=logits.device).long()
        loss = F.cross_entropy(logits, y, reduction="none")
        acc = (logits.argmax(-1) == y).float()
        return {"val/loss": loss, "val/accuracy": acc}

    return metric_fn
