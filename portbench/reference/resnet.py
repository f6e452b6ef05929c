"""Plain ResNet (He et al. 2016) in float32: the reference that the ResNet
cells' training steps are judged by.

The 50-layer network of the source's Table 1 with bottleneck blocks
(1×1 reduce, 3×3, 1×1 expand ×4, a projection shortcut where the shape
changes) and the stride on each stage's first 3×3 convolution.
Convolutions pad as XLA's ``SAME`` does, ``(total // 2, total - total //
2)``, and the 3×3/2 max-pool pads with ``-inf``.  Batch normalization in
training mode over the whole batch: float32 moments, the biased variance
``E[x²] - mean²``, ``(x - mean) · rsqrt(var + eps) · scale + bias``.  Then
a global average, a float32 head and the mean cross-entropy.  Weights
are a ``{name: tensor}`` dict in the benchmark's layout.  Imports nothing
but PyTorch.

``rnd`` (None: exact) rounds wherever the program's compute dtype does:
the operands and the result of every convolution, every normalisation's
output, every residual sum and the pooled features that enter the head
(the head itself runs in float32, as in the program).  The control
passes a rounding to a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Rnd = Optional[Callable[[torch.Tensor], torch.Tensor]]


def block_plan(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    """``(prefix, cin, features, stride, projection)`` of every block."""
    plan, cin = [], cfg["width"]
    j = 0
    for i, n in enumerate(cfg["stage_sizes"]):
        feats = cfg["width"] * 2 ** i
        for b in range(n):
            stride = 2 if i > 0 and b == 0 else 1
            out = feats * cfg["expansion"]
            plan.append((f"blocks.{j}.", cin, feats, stride,
                         stride != 1 or cin != out))
            cin, j = out, j + 1
    return plan


def conv_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, int, int, int],
                                         int, str]]:
    """``(weight name, (out, in, k, k), stride, bn prefix)`` of every
    convolution, in the order they run."""
    e = cfg["expansion"]
    out = [("conv_init.weight", (cfg["width"], cfg["in_channels"], 7, 7), 2,
            "bn_init.")]
    for p, cin, f, s, proj in block_plan(cfg):
        out += [(p + "conv0.weight", (f, cin, 1, 1), 1, p + "bn0."),
                (p + "conv1.weight", (f, f, 3, 3), s, p + "bn1."),
                (p + "conv2.weight", (f * e, f, 1, 1), 1, p + "bn2.")]
        if proj:
            out.append((p + "proj.weight", (f * e, cin, 1, 1), s,
                        p + "proj_bn."))
    return out


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _id(x):
    return x


def conv(x, w, stride, rnd):
    k = w.shape[-1]
    (lh, hh), (lw, hw) = (same_pads(n, k, stride) for n in x.shape[2:])
    x = F.pad(x, (lw, hw, lh, hh))
    return rnd(F.conv2d(rnd(x), rnd(w), stride=stride))


def batch_norm(x, scale, bias, eps):
    dims = [0, 2, 3]
    mean = x.mean(dim=dims)
    var = x.square().mean(dim=dims) - mean.square()
    inv = torch.rsqrt(var + eps)
    return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
            * scale[None, :, None, None] + bias[None, :, None, None])


def forward(w: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            rnd: Rnd = None) -> torch.Tensor:
    """NHWC images -> float32 logits."""
    rnd = rnd or _id
    eps = cfg["bn_epsilon"]

    def cbn(x, name, stride, bn):
        return rnd(batch_norm(conv(x, w[name], stride, rnd), w[bn + "scale"],
                              w[bn + "bias"], eps))

    x = images.float().permute(0, 3, 1, 2)
    x = F.relu(cbn(x, "conv_init.weight", 2, "bn_init."))
    (lh, hh), (lw, hw) = (same_pads(n, 3, 2) for n in x.shape[2:])
    x = F.max_pool2d(F.pad(x, (lw, hw, lh, hh), value=float("-inf")), 3, 2)
    for p, _, _, s, proj in block_plan(cfg):
        y = F.relu(cbn(x, p + "conv0.weight", 1, p + "bn0."))
        y = F.relu(cbn(y, p + "conv1.weight", s, p + "bn1."))
        y = cbn(y, p + "conv2.weight", 1, p + "bn2.")
        r = cbn(x, p + "proj.weight", s, p + "proj_bn.") if proj else x
        x = F.relu(rnd(y + r))
    x = rnd(x.mean(dim=(2, 3)))
    return x @ w["head.weight"].t() + w["head.bias"]


def loss_and_grads(w: Dict[str, torch.Tensor], cfg: dict, batch,
                   rows: int, rnd: Rnd = None):
    """The mean cross-entropy of ``batch = (images, labels)`` and its
    gradient in every weight.  Batch statistics span the whole batch, so
    it runs in one block (``rows`` must cover the batch)."""
    images, labels = batch
    if rows < images.shape[0]:
        raise ValueError("batch normalization's statistics span the whole "
                         "batch: the reference runs it in one block")
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    loss = F.cross_entropy(forward(params, cfg, images, rnd), labels)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in params.items()}
