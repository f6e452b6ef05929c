"""Peaks of the card and the least time a piece of work can take on it.

The arithmetic is copied from the port's chip smoke (``bound``,
``flash_bounds``, ``paged_bound``) so that the benchmark owns it: every
input byte is read once and every output byte written once, and two
operations count per multiply-add over the work the inputs need.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

#: H100 SXM data-sheet rates (dense, at the 700 W power limit): device
#: memory bytes per second and peak operations per second by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
            "float8": 1979e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, dtype: str = "bfloat16"
          ) -> Tuple[float, str]:
    """The least seconds a kernel moving ``nbytes`` and doing ``ops``
    operations can take, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_bounds(B: int, T: int, H: int, D: int, itemsize: int = 2
                 ) -> Dict[str, Tuple[float, str]]:
    """Bound of each flash-attention kernel at causal ``(B, T, H, D)``:
    the forward (K1), dK/dV (K2) and dQ (K3).  Each input read once and
    each output written once; two operations per multiply-add over the
    admitted (q, k) pairs: two products in the forward, four in dK/dV,
    three in dQ (the score product recomputed)."""
    pairs = B * H * T * (T + 1) // 2
    x = B * T * H * D * itemsize  # one of q, k, v, dO, o, dq, dk, dv
    row = B * H * T * 4           # one fp32 per-row vector (lse, delta)
    return {
        "fwd": bound(4 * x + row, 4 * D * pairs),
        "bwd_dkv": bound(6 * x + 2 * row, 8 * D * pairs),
        "bwd_dq": bound(5 * x + 2 * row, 6 * D * pairs),
    }


def paged_decode_bound(valid: Iterable[int], slots: int, H: int, KH: int,
                       Dh: int, block_len: int, itemsize: int = 2
                       ) -> Tuple[float, str]:
    """Bound of one paged decode-attention launch (K4, one layer) over
    ``slots`` rows whose live ones attend ``valid`` positions each (idle
    rows attend none): the K/V rows of those positions, the table entries
    that reach them, q and the output, and ``valid_len``; ``4 * Dh``
    operations per (query head, attended position)."""
    valid = [int(v) for v in valid]
    pos = sum(valid)
    nbytes = 2 * KH * pos * Dh * itemsize
    nbytes += 4 * sum(math.ceil(v / block_len) for v in valid)
    nbytes += 2 * slots * H * Dh * itemsize + 4 * slots
    ops = 4 * Dh * H * pos
    return bound(nbytes, ops)
