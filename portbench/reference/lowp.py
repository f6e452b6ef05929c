"""Rounding to float8 (e4m3) with one scale a tensor: the control's
precision, the step below the configurations' bfloat16; and rounding to
bfloat16, the configurations' own precision, for a witness of what
rounding alone does to the compared numbers.  The forward rounds a
tensor; the backward rounds the gradient that reaches it."""

from __future__ import annotations

import torch

#: the largest finite float8 e4m3 value.
E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale)


class _E4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3(g)


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` computed in float8: rounded, and its gradient rounded."""
    return _E4M3.apply(x)


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` computed in bfloat16: rounded, and its gradient rounded."""
    return _BF16.apply(x)
