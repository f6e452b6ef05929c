"""ResNet: the port of ``chainermn_tpu/models/resnet.py``, the benchmark
model family (``BASELINE.md``'s headline numbers are ResNet-50).

The JAX package's choices carry over: bf16 compute over fp32 parameters
(``dtype``), an fp32 head, cross-rank sync-BN
(:class:`~chainermn_tpu_torch.links.MultiNodeBatchNormalization`) when an
``axis_name`` (the communicator's process group) is given, and the
``bn``/``conv1``/``stem`` knobs.  ``conv1="pallas"`` runs each bottleneck
block's 1×1 convs as the fused conv + frozen-BN affine + ReLU kernel K6
(:func:`chainermn_tpu_torch.ops.conv_fused.conv1x1_bn_relu`), ``"xla"`` as
its plain twin; the other convolutions are cuDNN calls, as the JAX package
leaves them to XLA.

Layout.  The public input is NHWC ``(B, H, W, C)``, as in the JAX package.
Inside, activations are NCHW tensors in ``torch.channels_last`` memory:
cuDNN runs its NHWC kernels on them, and K6's ``(B·H·W, C)`` view of one
is free.  Convolutions pad as XLA's ``SAME`` does -- ``(total // 2, total -
total // 2)``, asymmetric for even inputs at stride 2 -- which
``nn.Conv2d(padding=k // 2)`` does not; the max-pool pads with ``-inf``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
)
from chainermn_tpu_torch.ops.conv_fused import conv1x1_bn_relu
from chainermn_tpu_torch.ops.pooling import max_pool_fused
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["BasicBlock", "BottleneckBlock", "FusedConv1x1", "ResNet",
           "ResNet18", "ResNet50", "ResNetTiny", "resnet_loss",
           "s2d_stem_kernel", "same_pads", "space_to_depth"]

#: Flax's truncated-normal initializers draw from N(0, 1) cut at ±2 and
#: divide the standard deviation by this to keep the variance asked for.
_TRUNC_STD = 0.87962566103423978


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding ``(lo, hi)`` of a length-``n`` axis for a
    window ``k`` at stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad2d(x, pads, value=0.0):
    """``x`` (NCHW) padded by ``((lo_h, hi_h), (lo_w, hi_w))``; returns
    the tensor and the symmetric padding still to apply in the op, so that
    a symmetric case makes no copy."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def _he_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """``flax.linen.initializers.he_normal()``: truncated normal with
    variance 2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False)`` over NCHW activations:
    ``weight`` (out, in, k, k) fp32, cast to the activation's dtype per
    call; padding ``"SAME"`` (XLA's) or explicit ``((lo, hi), (lo,
    hi))``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding="SAME", device=None):
        super().__init__()
        self.k, self.stride, self.padding = k, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))

    def forward(self, x):
        if self.padding == "SAME":
            pads = tuple(same_pads(n, self.k, self.stride)
                         for n in x.shape[2:])
        else:
            pads = self.padding
        x, pad = _pad2d(x, pads)
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pad)


def max_pool_same(x, k: int = 3, s: int = 2):
    """``flax.linen.max_pool(x, (k, k), (s, s), padding="SAME")`` over
    NCHW: ``-inf`` fills the padding."""
    pads = tuple(same_pads(n, k, s) for n in x.shape[2:])
    x, pad = _pad2d(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s, padding=pad)


class FusedConv1x1(nn.Module):
    """1×1 conv + frozen-BN affine (+ ReLU) through
    :func:`~chainermn_tpu_torch.ops.conv_fused.conv1x1_bn_relu`: one pass,
    fp32 accumulation, the epilogue on the accumulator.  ``impl="pallas"``
    is the kernel K6, ``"xla"`` its plain twin (identical math and
    backward).  Parameters as in the JAX package: ``kernel`` (Cin, Cout),
    ``scale`` and ``bias`` (Cout,), all fp32."""

    def __init__(self, cin: int, features: int, relu: bool = True,
                 strides: int = 1, impl: str = "xla", dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.relu, self.strides, self.impl, self.dtype = (relu, strides,
                                                          impl, dtype)
        self.kernel = nn.Parameter(torch.empty(cin, features, device=device))
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        # NCHW in channels_last memory -> its NHWC view, and back.
        y = conv1x1_bn_relu(
            x.to(self.dtype).permute(0, 2, 3, 1), self.kernel.to(self.dtype),
            self.scale, self.bias, relu=self.relu,
            strides=(self.strides, self.strides), impl=self.impl)
        return y.permute(0, 3, 1, 2)


def _check_modes(bn: str, conv1: str) -> None:
    if bn not in ("sync", "frozen"):
        raise ValueError(f"bn={bn!r}: expected 'sync' or 'frozen'")
    if conv1 not in ("none", "xla", "pallas"):
        raise ValueError(
            f"conv1={conv1!r}: expected 'none', 'xla' or 'pallas'")
    if conv1 != "none" and bn != "frozen":
        raise ValueError(
            "conv1 fusion folds BN into an affine epilogue — training-mode "
            "batch stats cannot be fused across (set bn='frozen')")


class BottleneckBlock(nn.Module):
    """1×1 reduce, 3×3 (strided), 1×1 expand (×4), projection shortcut
    where the shape changes.  ``bn``: ``"sync"`` (training-mode sync-BN,
    the headline) or ``"frozen"`` (stored-statistics affine even in
    training).  ``conv1``: ``"none"`` (convolutions and BN), or
    ``"xla"``/``"pallas"``: the three 1×1 convs as :class:`FusedConv1x1`
    (requires ``bn="frozen"``).  Submodule names follow the Flax tree
    (``conv{j}`` for ``Conv_{j}``, ``bn{j}`` for
    ``MultiNodeBatchNormalization_{j}``)."""

    expansion = 4

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16, axis_name=None,
                 norm_momentum: float = 0.9, bn: str = "sync",
                 conv1: str = "none", device=None):
        super().__init__()
        _check_modes(bn, conv1)
        self.bn, self.conv1_mode = bn, conv1
        out = features * 4
        shortcut = strides != 1 or cin != out

        def norm(c):
            return MultiNodeBatchNormalization(
                c, axis_name=axis_name, momentum=norm_momentum,
                device=device)

        if conv1 != "none":
            fused = dict(impl=conv1, dtype=dtype, device=device)
            self.fc1 = FusedConv1x1(cin, features, relu=True, **fused)
            self.conv0 = Conv(features, features, 3, strides, device=device)
            self.bn0 = norm(features)
            self.fc3 = FusedConv1x1(features, out, relu=False, **fused)
            if shortcut:
                self.proj_f = FusedConv1x1(cin, out, relu=False,
                                           strides=strides, **fused)
            return
        self.conv0 = Conv(cin, features, 1, device=device)
        self.bn0 = norm(features)
        self.conv1 = Conv(features, features, 3, strides, device=device)
        self.bn1 = norm(features)
        self.conv2 = Conv(features, out, 1, device=device)
        self.bn2 = norm(out)
        if shortcut:
            self.proj = Conv(cin, out, 1, strides, device=device)
            self.proj_bn = norm(out)

    def forward(self, x, train: bool = True):
        ra = (not train) or self.bn == "frozen"
        residual = x
        if self.conv1_mode != "none":
            y = self.fc1(x)
            y = F.relu(self.bn0(self.conv0(y), ra))
            y = self.fc3(y)
            if hasattr(self, "proj_f"):
                residual = self.proj_f(residual)
            return F.relu(y + residual.to(y.dtype))
        y = F.relu(self.bn0(self.conv0(x), ra))
        y = F.relu(self.bn1(self.conv1(y), ra))
        y = self.bn2(self.conv2(y), ra)
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj(residual), ra)
        return F.relu(y + residual.to(y.dtype))


class BasicBlock(nn.Module):
    """Two-3×3-conv residual block (the ResNet-18/34 block)."""

    expansion = 1

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype=torch.bfloat16, axis_name=None,
                 norm_momentum: float = 0.9, bn: str = "sync",
                 conv1: str = "none", device=None):
        super().__init__()
        if conv1 != "none":
            raise ValueError(
                "conv1 fusion targets the bottleneck block's 1x1 convs; "
                "BasicBlock has none")
        self.bn = bn

        def norm(c):
            return MultiNodeBatchNormalization(
                c, axis_name=axis_name, momentum=norm_momentum,
                device=device)

        self.conv0 = Conv(cin, features, 3, strides, device=device)
        self.bn0 = norm(features)
        self.conv1 = Conv(features, features, 3, device=device)
        self.bn1 = norm(features)
        if strides != 1 or cin != features:
            self.proj = Conv(cin, features, 1, strides, device=device)
            self.proj_bn = norm(features)

    def forward(self, x, train: bool = True):
        ra = (not train) or self.bn == "frozen"
        residual = x
        y = F.relu(self.bn0(self.conv0(x), ra))
        y = self.bn1(self.conv1(y), ra)
        if hasattr(self, "proj"):
            residual = self.proj_bn(self.proj(residual), ra)
        return F.relu(y + residual.to(y.dtype))


def space_to_depth(x, block: int = 2):
    """NHWC ``(B, H, W, C) -> (B, H/b, W/b, b²·C)``: each ``b×b`` spatial
    tile becomes channels, packed ``(a, b, c)``-major (row offset, column
    offset, then the original channel)."""
    B, H, W, C = x.shape
    if H % block or W % block:
        raise ValueError(f"H/W {H}x{W} not divisible by block {block}")
    x = x.reshape(B, H // block, block, W // block, block, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // block, W // block, block * block * C)


def s2d_stem_kernel(w7):
    """Rearrange a ``conv_init`` kernel in Flax's HWIO layout ``(7, 7, C,
    O)`` into the exactly equivalent ``(4, 4, 4C, O)`` kernel of the
    space-to-depth stem (the JAX package's function, for checkpoint
    migration between stems): the stride-2 7×7 SAME conv (pad (2, 3)) is a
    stride-1 4×4 conv with pad (1, 2) on the s2d(2) tensor, with ``W'[t+1,
    s+1, (2a+b)·C + c] = W[2t+a+2, 2s+b+2, c]`` and zeros where the 7-tap
    index falls outside.  For the port's OIHW weights, permute ``(2, 3, 1,
    0)`` before and ``(3, 2, 0, 1)`` after."""
    k7 = np.asarray(w7)
    assert k7.shape[:2] == (7, 7), k7.shape
    C, O = k7.shape[2], k7.shape[3]
    out = np.zeros((4, 4, 4 * C, O), k7.dtype)
    for t in range(-1, 3):
        for s in range(-1, 3):
            for a in (0, 1):
                for b in (0, 1):
                    di, dj = 2 * t + a + 2, 2 * s + b + 2
                    if 0 <= di < 7 and 0 <= dj < 7:
                        out[t + 1, s + 1,
                            (2 * a + b) * C:(2 * a + b + 1) * C] = \
                            k7[di, dj]
    return out


class ResNet(nn.Module):
    """NHWC-input ResNet; ``stage_sizes=[3, 4, 6, 3]`` with the bottleneck
    block is ResNet-50, ``[2, 2, 2, 2]`` with the basic block ResNet-18.

    ``stem``: ``"conv7"`` (stride-2 7×7) or ``"s2d"`` (space-to-depth(2)
    then a stride-1 4×4 conv, exactly equivalent via
    :func:`s2d_stem_kernel`).  ``maxpool``: ``"xla"`` (``F.max_pool2d``)
    or ``"fused"`` (:func:`~chainermn_tpu_torch.ops.max_pool_fused`: the
    same forward, and a backward that routes a tie to the first maximum
    in row-major window order, as the JAX package's does).  ``bn`` and
    ``conv1``: see :class:`BottleneckBlock` (they apply to every block and
    the stem BN).  ``axis_name``: the process group of sync-BN (the
    communicator's ``axis_name``), None for local BN.

    ``device`` places the parameters (None: the current CUDA device,
    raising where there is none); they are initialized from ``seed`` with
    Flax's initializers (He-normal convs, LeCun-normal head) through a
    private generator.  ``forward(x, train=None)`` takes ``(B, H, W,
    in_channels)`` images and returns fp32 logits; ``train`` None follows
    ``self.training``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype=torch.bfloat16, axis_name=None,
                 block=BottleneckBlock, stem: str = "conv7",
                 maxpool: str = "xla", bn: str = "sync", conv1: str = "none",
                 in_channels: int = 3, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device, "ResNet")
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem={stem!r}: expected 'conv7' or 's2d'")
        if maxpool not in ("xla", "fused"):
            raise ValueError(
                f"maxpool={maxpool!r}: expected 'xla' or 'fused'")
        _check_modes(bn, conv1 if block is BottleneckBlock else "none")
        self.stage_sizes = list(stage_sizes)
        self.num_classes, self.width, self.dtype = num_classes, width, dtype
        self.stem, self.bn, self.conv1 = stem, bn, conv1
        self.maxpool = maxpool
        if stem == "s2d":
            self.conv_init_s2d = Conv(4 * in_channels, width, 4, 1,
                                      padding=((1, 2), (1, 2)),
                                      device=device)
        else:
            self.conv_init = Conv(in_channels, width, 7, 2, device=device)
        self.bn_init = MultiNodeBatchNormalization(width, axis_name=axis_name,
                                                   device=device)
        blocks, cin = [], width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                feats = width * 2 ** i
                blocks.append(block(
                    cin, feats, strides=2 if i > 0 and j == 0 else 1,
                    dtype=dtype, axis_name=axis_name, bn=bn, conv1=conv1,
                    device=device))
                cin = feats * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device,
                              dtype=torch.float32)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Flax's initializers from ``seed``: He-normal conv and fused
        kernels, LeCun-normal head kernel, zero biases, unit scales, BN
        running statistics (0, 1)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, Conv):
                _he_normal_(mod.weight, mod.weight[0].numel(), g)
            elif isinstance(mod, FusedConv1x1):
                _he_normal_(mod.kernel, mod.kernel.shape[0], g)
                mod.scale.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MultiNodeBatchNormalization):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        std = math.sqrt(1.0 / self.head.in_features) / _TRUNC_STD
        nn.init.trunc_normal_(self.head.weight, 0.0, std, -2 * std, 2 * std,
                              generator=g)
        self.head.bias.zero_()

    @torch.no_grad()
    def scale_residual_branches(self, value: float) -> None:
        """Set the last affine scale of every residual branch and
        projection shortcut (``fc3``/``proj_f`` of a fused block, ``bn2``/
        ``proj_bn`` (``bn1`` in a basic block) otherwise) to ``value``.  A
        small value keeps a ``bn="frozen"`` model finite when it trains
        from random weights: stored statistics do not normalize, so with
        unit scales the residual stream's variance grows with every block
        (the JAX package's frozen-BN runs from random init read NaN)."""
        for blk in self.blocks:
            for name in ("fc3", "proj_f", "bn2", "proj_bn"):
                if hasattr(blk, name):
                    getattr(blk, name).scale.fill_(value)
            if isinstance(blk, BasicBlock):
                blk.bn1.scale.fill_(value)

    def forward(self, x, train: Optional[bool] = None):
        train = self.training if train is None else train
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        # NHWC -> NCHW view: the channels_last layout of the activations.
        x = x.contiguous().permute(0, 3, 1, 2)
        stem = self.conv_init_s2d if self.stem == "s2d" else self.conv_init
        ra = (not train) or self.bn == "frozen"
        x = F.relu(self.bn_init(stem(x), ra))
        if self.maxpool == "fused":
            # NCHW in channels_last memory is an NHWC tensor: no copy.
            x = max_pool_fused(x.permute(0, 2, 3, 1), (3, 3), (2, 2),
                               "SAME").permute(0, 3, 1, 2)
        else:
            x = max_pool_same(x, 3, 2)
        for blk in self.blocks:
            x = blk(x, train=train)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], **kw)


def ResNet18(**kw) -> ResNet:
    """True ResNet-18: basic blocks, [2, 2, 2, 2] stages."""
    return ResNet(stage_sizes=[2, 2, 2, 2], block=BasicBlock, **kw)


def ResNetTiny(**kw) -> ResNet:
    """One bottleneck block per stage -- the CI/test workhorse (14 conv
    layers; intentionally NOT named ResNet-18, which it is not)."""
    return ResNet(stage_sizes=[1, 1, 1, 1], **kw)


def resnet_loss(model: ResNet):
    """Stateful loss for the data-parallel train step (the JAX package's
    ``resnet_loss``): ``loss_fn(model, (x, y)) -> (loss, (aux,
    model_state))`` with the fp32 softmax cross-entropy over integer
    labels, averaged; ``aux = {"accuracy": ...}``; ``model_state`` the
    BN buffers, which the training forward updates in place."""

    def loss_fn(m, batch):
        x, y = batch
        y = torch.as_tensor(y, device=m.device).long()
        logits = m(x, train=True)
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, ({"accuracy": acc.detach()}, dict(m.named_buffers()))

    return loss_fn
