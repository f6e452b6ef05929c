"""Max pooling with a hand-written backward: the port of
``chainermn_tpu/ops/pooling.py`` ``max_pool_fused``.

- forward: one running max/argmax chain over the ``kh*kw`` shifted,
  strided slices of the padded input (elementwise compares and selects),
  saving the winning window offset per output element as a uint8 residual
  (int32 past 256 offsets, where a uint8 would wrap);
- backward: for each window offset, the cotangent masked to the outputs
  that offset won is added back onto the strided positions it was read
  from (stride becomes the step of the slice), accumulated in fp32; the
  ``kh*kw`` placements summed are the gradient.

Tie semantics: the FIRST maximum in row-major window order wins (a strict
``>`` keeps the earlier offset), as in the JAX package, whose backward
matches XLA's ``select_and_scatter``.  ``F.max_pool2d``'s routing of ties
is not pinned down, which is why ``ResNet(maxpool="fused")`` runs this
instead.  NaNs propagate through the forward (a NaN slice always takes
the window), as ``lax.max`` does.

Tensors are NHWC ``(B, H, W, C)``, the JAX package's layout; a ResNet's
NCHW activation in ``channels_last`` memory is such a tensor after
``permute(0, 2, 3, 1)``, without a copy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _idx_dtype(n_offsets: int) -> torch.dtype:
    return torch.uint8 if n_offsets <= 256 else torch.int32


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA ``SAME`` padding: what ``ceil(size / stride)`` windows need."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _resolve_pads(shape, window, strides, padding):
    if isinstance(padding, str):
        if padding == "VALID":
            return ((0, 0), (0, 0))
        if padding == "SAME":
            return tuple(_same_pads(s, w, st)
                         for s, w, st in zip(shape, window, strides))
        raise ValueError(f"padding={padding!r}: expected 'SAME'/'VALID' "
                         "or explicit ((lo, hi), (lo, hi))")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _geometry(H, W, window, strides, pads):
    (plh, phh), (plw, phw) = pads
    Hp, Wp = H + plh + phh, W + plw + phw
    Ho = max((Hp - window[0]) // strides[0] + 1, 0)
    Wo = max((Wp - window[1]) // strides[1] + 1, 0)
    return Hp, Wp, Ho, Wo


def _fwd_argmax(x, window, strides, pads):
    kh, kw = window
    sh, sw = strides
    (plh, phh), (plw, phw) = pads
    B, H, W, C = x.shape
    Hp, Wp, Ho, Wo = _geometry(H, W, window, strides, pads)
    if Ho == 0 or Wo == 0:
        return (x.new_zeros((B, Ho, Wo, C)),
                torch.zeros((B, Ho, Wo, C), dtype=torch.uint8,
                            device=x.device))
    is_float = x.is_floating_point()
    neg = float("-inf") if is_float else torch.iinfo(x.dtype).min
    xp = x.new_full((B, Hp, Wp, C), neg)
    xp[:, plh:plh + H, plw:plw + W, :] = x
    idx_dtype = _idx_dtype(kh * kw)
    best = arg = None
    for a in range(kh):          # row-major window order
        for b in range(kw):
            sl = xp[:, a:a + (Ho - 1) * sh + 1:sh,
                    b:b + (Wo - 1) * sw + 1:sw, :]
            k = a * kw + b
            if best is None:
                best = sl.contiguous()
                arg = torch.zeros(sl.shape, dtype=idx_dtype,
                                  device=x.device)
                continue
            # Strict > keeps the earlier offset on ties; a NaN takes the
            # window so that it propagates.
            take = sl > best
            if is_float:
                take |= torch.isnan(sl)
            best = torch.where(take, sl, best)
            # A Python scalar, never a tensor made from one: that would be
            # a host-to-device copy, which waits for the card each time.
            arg = arg.masked_fill(take, k)
    return best, arg


class MaxPoolFusedFunction(torch.autograd.Function):
    """``max_pool_fused`` with its scatter-free backward."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        best, arg = _fwd_argmax(x, window, strides, pads)
        ctx.save_for_backward(arg)
        ctx.geom = (tuple(x.shape), x.dtype, window, strides, pads)
        return best

    @staticmethod
    def backward(ctx, g):
        (arg,) = ctx.saved_tensors
        (B, H, W, C), dtype, window, strides, pads = ctx.geom
        kh, kw = window
        sh, sw = strides
        (plh, _), (plw, _) = pads
        Hp, Wp, Ho, Wo = _geometry(H, W, window, strides, pads)
        if Ho == 0 or Wo == 0:
            return torch.zeros((B, H, W, C), dtype=dtype,
                               device=g.device), None, None, None
        # fp32 accumulation: up to kh*kw windows overlap one input position
        # at stride < window.
        acc = torch.zeros((B, Hp, Wp, C), dtype=torch.float32,
                          device=g.device)
        g32 = g.float()
        for a in range(kh):
            for b in range(kw):
                acc[:, a:a + (Ho - 1) * sh + 1:sh,
                    b:b + (Wo - 1) * sw + 1:sw, :] += \
                    g32.masked_fill(arg != a * kw + b, 0.0)
        grad = acc[:, plh:plh + H, plw:plw + W, :].to(dtype)
        return grad, None, None, None


def max_pool_fused(x: torch.Tensor, window: Sequence[int] = (3, 3),
                   strides: Sequence[int] = (2, 2),
                   padding="SAME") -> torch.Tensor:
    """``flax.linen.max_pool`` (NHWC) with the first-max-wins backward."""
    window = tuple(int(w) for w in window)
    strides = tuple(int(s) for s in strides)
    if x.dim() != 4:
        raise ValueError(f"expected NHWC rank-4 input, got shape "
                         f"{tuple(x.shape)}")
    pads = _resolve_pads(tuple(x.shape[1:3]), window, strides, padding)
    return MaxPoolFusedFunction.apply(x, window, strides, pads)
