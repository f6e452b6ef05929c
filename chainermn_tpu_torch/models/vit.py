"""Vision Transformer in PyTorch: the port of ``chainermn_tpu/models/vit.py``.

Patch embedding as one strided convolution (a library convolution: no
Pallas kernel sits there in the JAX package either), learned position
embeddings, pre-norm encoder blocks over non-causal self-attention
(:func:`~chainermn_tpu_torch.ops.flash_attention`, K1-K3 on the card, or
the eager materialized-score path), mean-pooled tokens and an fp32 head.
Compute in ``dtype`` (bf16 by default) over fp32 parameters, LayerNorm
statistics in fp32 and eps 1e-6, the tanh approximation of GELU, as the
JAX model.  ``attention="auto"`` resolves through
``resolve_attention(impl, T, causal=False)``, so the port's
``FLASH_MIN_SEQ_NONCAUSAL`` decides (on the CPU ``auto`` is the eager
path).  The input is NHWC, as the JAX model's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch.models.transformer import LN_EPS, _dense, _layer_norm
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
    resolve_attention,
)
from chainermn_tpu_torch.utils.device import resolve_device


class _EncoderBlock(nn.Module):
    """Pre-norm block: ``ln1``, ``qkv`` (3·H·Dh, D), ``proj`` (D, H·Dh),
    ``ln2``, ``ff1``, ``ff2``."""

    def __init__(self, d_model, n_heads, d_ff, dtype, attention, fk):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, d_model // n_heads
        self.dtype, self.attention = dtype, attention
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.qkv = nn.Linear(d_model, 3 * d_model, **fk)
        self.proj = nn.Linear(d_model, d_model, **fk)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.ff1 = nn.Linear(d_model, d_ff, **fk)
        self.ff2 = nn.Linear(d_ff, d_model, **fk)

    def forward(self, h):
        B, T = h.shape[:2]
        H, Dh, dt = self.n_heads, self.head_dim, self.dtype
        x = _layer_norm(h, self.ln1, dt)
        q, k, v = _dense(x, self.qkv, dt).view(B, T, 3, H, Dh).unbind(2)
        if resolve_attention(self.attention, T, causal=False,
                             device=h.device) == "flash":
            a = flash_attention(q, k, v, causal=False)
        else:
            a = reference_attention(q, k, v, causal=False)
        h = h + _dense(a.reshape(B, T, H * Dh), self.proj, dt)
        x = _layer_norm(h, self.ln2, dt)
        x = F.gelu(_dense(x, self.ff1, dt), approximate="tanh")
        return h + _dense(x, self.ff2, dt)


class ViT(nn.Module):
    """``(B, H, W, 3)`` images -> ``(B, num_classes)`` fp32 logits.

    Defaults are ViT-S/16: patch 16, d_model 384, 6 heads, d_ff 1536, 12
    layers.  ``image_size`` fixes the position table's length ``T =
    (image_size / patch)**2`` (the JAX model takes it from its first
    input).  ``remat`` recomputes each block in the backward.
    Parameters: ``patch_embed`` (a conv, D x 3 x p x p), ``pos_embed`` (1,
    T, D), ``blocks.{i}``, ``ln_f``, ``head``; initialized from ``seed``
    (dense kernels normal with std 1/sqrt(fan_in), the patch kernel with
    std 1/sqrt(3·p·p), zero biases, unit LayerNorm scales, positions std
    0.02).  ``device`` None means the current CUDA device (raises where
    there is none)."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 d_model: int = 384, n_heads: int = 6, d_ff: int = 1536,
                 n_layers: int = 12, image_size: int = 224,
                 dtype=torch.bfloat16, attention: str = "auto",
                 remat: bool = False, device=None, seed: int = 0):
        super().__init__()
        if attention not in ("flash", "xla", "auto"):
            raise ValueError(f"attention={attention!r}: expected 'flash', "
                             "'xla' or 'auto'")
        if image_size % patch:
            raise ValueError(
                f"image {image_size}x{image_size} not divisible by patch "
                f"{patch}")
        device = resolve_device(device, "ViT")
        fk = dict(device=device, dtype=torch.float32)
        self.num_classes, self.patch, self.d_model = num_classes, patch, \
            d_model
        self.n_heads, self.d_ff, self.n_layers = n_heads, d_ff, n_layers
        self.image_size, self.dtype = image_size, dtype
        self.attention, self.remat = attention, remat
        self.patch_embed = nn.Conv2d(3, d_model, patch, stride=patch, **fk)
        T = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, T, d_model, **fk))
        self.blocks = nn.ModuleList([
            _EncoderBlock(d_model, n_heads, d_ff, dtype, attention, fk)
            for _ in range(n_layers)])
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.head = nn.Linear(d_model, num_classes, **fk)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, x, train: bool = True):
        """``train`` changes nothing (no dropout, no batch statistics); it
        keeps the classifier contract of ``ResNet``."""
        x = torch.as_tensor(x, device=self.device)
        B, Hx, Wx, _ = x.shape
        p, dt = self.patch, self.dtype
        if Hx % p or Wx % p:
            raise ValueError(f"image {Hx}x{Wx} not divisible by patch {p}")
        T = (Hx // p) * (Wx // p)
        if T != self.pos_embed.shape[1]:
            raise ValueError(
                f"image {Hx}x{Wx} gives {T} patches; the model was built "
                f"for {self.pos_embed.shape[1]} (image_size "
                f"{self.image_size})")
        # NHWC -> an NCHW view; the patch grid flattens row-major as the
        # JAX reshape of (B, H/p, W/p, D) does.
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        h = y.flatten(2).transpose(1, 2) + self.pos_embed.to(dt)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                h = checkpoint(blk, h, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = blk(h)
        h = _layer_norm(h, self.ln_f, dt).float().mean(dim=1)
        return F.linear(h, self.head.weight.float(), self.head.bias.float())


def vit_loss(model: ViT):
    """``loss_fn(model, (x, y)) -> (loss, {"accuracy": ...})``: the fp32
    softmax cross-entropy over integer labels, averaged (the contract of
    ``resnet_loss`` without a model state)."""
    if not isinstance(model, ViT):
        raise TypeError(f"vit_loss expects a ViT, got {type(model).__name__}")

    def loss_fn(m, batch):
        x, y = batch
        y = torch.as_tensor(y, device=m.device).long()
        logits = m(x, train=True)
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"accuracy": acc.detach()}

    return loss_fn
