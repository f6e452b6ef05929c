"""All-to-all sequence parallelism, DeepSpeed-Ulysses style
(``chainermn_tpu/parallel/ulysses.py``).

Instead of rotating K/V, two all-to-alls re-shard the activations
sequence <-> heads, so any local attention (the flash kernels included)
runs unchanged on the full sequence with ``H/S`` heads per rank.  Built
on the reference's ``chainermn.functions.alltoall``
(:func:`~chainermn_tpu_torch.functions.alltoall`), whose backward is the
inverse all-to-all.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from chainermn_tpu_torch.functions.collective import alltoall


def _default_attention(q, k, v, causal, segment_ids=None, impl="auto"):
    """The measured ``auto`` policy (:func:`~chainermn_tpu_torch.ops.
    resolve_attention`) on the full length the all-to-all gathered: the
    flash kernels from the card's crossover (``ops.FLASH_MIN_SEQ``), the
    plain path below it and on the CPU.  Segment-masked rows resolve with
    the causal crossover, as in the JAX package."""
    from chainermn_tpu_torch.ops.flash_attention import (
        flash_attention,
        reference_attention,
        resolve_attention,
    )

    if resolve_attention(impl, q.shape[1],
                         causal=(causal or segment_ids is not None),
                         device=q.device) == "flash":
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids)
    return reference_attention(q, k, v, causal, segment_ids=segment_ids)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      comm, causal: bool = False,
                      attn_fn: Optional[Callable] = None,
                      segment_ids: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> torch.Tensor:
    """Exact attention over a sequence sharded on ``comm``.

    Every rank of ``comm`` calls it with its blocks ``(B, T/S, H, D)``;
    ``H % S == 0``.  ``attn_fn(q, k, v, causal) -> out`` runs on the full
    sequence with ``H/S`` heads (default: flash or plain by the measured
    crossover, ``impl`` "auto", or forced "flash"/"xla"); with
    ``segment_ids`` (this rank's ``(B, T/S)`` slice, all-gathered to the
    full sequence) it gets them as a fifth argument."""
    S = comm.size
    B, T, H, D = q.shape
    if H % S != 0:
        raise ValueError(f"heads {H} not divisible by sequence shards {S}")
    if attn_fn is None:
        attn_fn = partial(_default_attention, impl=impl)

    def seq_to_heads(x):
        # (B, T/S, H, D) -> (B, T, H/S, D): row j of the all-to-all is
        # head group j, and the rows that come back are the sequence
        # chunks of this rank's head group, in rank order.
        b, t, h, d = x.shape
        rows = x.reshape(b, t, S, h // S, d).permute(2, 0, 1, 3, 4)
        got = alltoall(comm, rows.contiguous())  # (S, B, T/S, H/S, D)
        return got.permute(1, 0, 2, 3, 4).reshape(b, S * t, h // S, d)

    def heads_to_seq(x):
        b, t, h, d = x.shape  # (B, T, H/S, D)
        rows = x.reshape(b, S, t // S, h, d).permute(1, 0, 2, 3, 4)
        got = alltoall(comm, rows.contiguous())  # (S, B, T/S, H/S, D)
        return got.permute(1, 2, 0, 3, 4).reshape(b, t // S, S * h, d)

    qf, kf, vf = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if segment_ids is not None:
        # Segments have no head axis to scatter: gather the sequence.
        seg = torch.as_tensor(segment_ids, device=q.device)
        seg_full = comm.allgather(seg).permute(1, 0, 2).reshape(B, S * T)
        out = attn_fn(qf, kf, vf, causal, seg_full)
    else:
        out = attn_fn(qf, kf, vf, causal)
    return heads_to_seq(out)
