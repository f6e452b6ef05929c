"""Rotary position embeddings (RoPE, Su et al. 2021), NeoX half-split
convention: feature pairs are ``(i, i + D/2)``.

Angles are computed in fp32 whatever the activation dtype (bf16 loses the
high position bits past a few thousand tokens), with theta 10000 by
default.  Positions are explicit, ``(T,)`` or per-row ``(B, T)``, so one
function serves a full forward (``arange``) and KV-cache decode (the write
positions).
"""

from __future__ import annotations

import torch


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """``(cos, sin)`` rotation tables, each ``(..., T, 1, head_dim // 2)``
    in fp32; compute once per step and share across layers."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head dim, got {head_dim}")
    half = head_dim // 2
    positions = torch.as_tensor(positions)
    inv_freq = theta ** (
        -torch.arange(half, dtype=torch.float32, device=positions.device)
        / half
    )
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor = None,
               theta: float = 10000.0, tables=None) -> torch.Tensor:
    """Rotate ``x`` ``(..., T, H, D)`` by its positions (or precomputed
    ``tables`` from :func:`rope_tables`); same shape and dtype as ``x``."""
    D = x.shape[-1]
    if D % 2:
        raise ValueError(f"RoPE needs an even head dim, got {D}")
    half = D // 2
    if tables is None:
        tables = rope_tables(positions, D, theta)
    cos, sin = tables
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
