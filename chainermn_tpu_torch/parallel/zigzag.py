"""Zigzag ring attention: load-balanced causal context parallelism
(``chainermn_tpu/parallel/zigzag.py``).

With contiguous shards the causal ring is lopsided: rank ``i``'s queries
see only ranks ``<= i``, so the last rank attends ``S`` blocks and rank 0
one.  The zigzag layout splits the sequence into ``2S`` chunks and gives
rank ``i`` the pair ``(i, 2S-1-i)``; every rank then attends ``2S + 1``
chunk quadrants.  Each ring step attends the needed quadrants of the
visiting pair and skips the fully masked ones (a Python branch: every
rank still takes part in each rotation).

:func:`zigzag_shard` / :func:`zigzag_unshard` reorder a global sequence
axis between contiguous and zigzag order; the attention returns its
output in the zigzag layout it was given.
"""

from __future__ import annotations

import numpy as np
import torch

from chainermn_tpu_torch.functions.point_to_point import send_recv
from chainermn_tpu_torch.ops.flash_attention import NEG_INF as _NEG_INF
from chainermn_tpu_torch.parallel.ring_attention import (
    _NEG,
    _attend,
    _expand,
    _kv_groups,
    _ring,
)


def _merge_flash_block(m, l, o, o_f, lse_f):
    """Merge a normalized flash block ``(o_f, lse_f)`` into the running
    unnormalized state ``(m, l, o)``: the block is the partial ``(m =
    lse_f, l = 1, acc = o_f)``.  Rows the kernel marked dead (``lse =
    NEG_INF``) contribute nothing."""
    alive = lse_f > _NEG_INF * 0.5
    lse_eff = torch.where(alive, lse_f, torch.full_like(lse_f, _NEG))
    m_new = torch.maximum(m, lse_eff)
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    corr = torch.exp(torch.where(torch.isneginf(m), m, m - m_safe))
    c2 = torch.where(alive, torch.exp(lse_f - m_safe),
                     torch.zeros_like(lse_f))
    l_new = l * corr + c2
    o_new = (o * corr.transpose(1, 2)[..., None]
             + o_f.float() * c2.transpose(1, 2)[..., None])
    return m_new, l_new, o_new


def zigzag_order(S: int) -> np.ndarray:
    """Chunk indices in zigzag order: rank i owns chunks (i, 2S-1-i)."""
    out = []
    for i in range(S):
        out += [i, 2 * S - 1 - i]
    return np.asarray(out)


def _chunks(x: torch.Tensor, S: int, axis: int):
    T = x.shape[axis]
    if T % (2 * S):
        raise ValueError(f"seq len {T} must divide into 2*{S} chunks")
    return torch.chunk(x, 2 * S, dim=axis)


def zigzag_shard(x: torch.Tensor, S: int, axis: int = 1) -> torch.Tensor:
    """Reorder a contiguous global sequence axis into zigzag layout:
    shard ``i`` of the result holds rank ``i``'s chunk pair."""
    parts = _chunks(x, S, axis)
    return torch.cat([parts[j] for j in zigzag_order(S)], dim=axis)


def zigzag_unshard(x: torch.Tensor, S: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    parts = _chunks(x, S, axis)
    order = zigzag_order(S)
    inv = np.empty_like(order)
    inv[order] = np.arange(2 * S)
    return torch.cat([parts[j] for j in inv], dim=axis)


def zigzag_ring_self_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, comm, remat: bool = True,
                               segment_ids=None, impl: str = "einsum"
                               ) -> torch.Tensor:
    """Causal self-attention over a ZIGZAG-sharded sequence on ``comm``.

    ``q``/``k``/``v`` are this rank's ``(B, 2c, H, D)`` pair (first half
    the early chunk ``rank``, second half the late chunk ``2S-1-rank``);
    k/v may carry fewer heads (GQA).  ``segment_ids`` is this rank's
    zigzag-sharded ``(B, 2c)`` slice; the key side rotates with its pair.
    ``impl="flash"`` runs each quadrant through the flash kernels (the
    diagonal quadrant with the kernel's causal mask) and merges them
    through their logsumexps; ``"einsum"`` attends plain blocks.  Returns
    the output in the same layout."""
    if impl not in ("einsum", "flash"):
        raise ValueError(f"impl={impl!r}: expected 'einsum' or 'flash'")
    B, T2, H, D = q.shape
    if T2 % 2:
        raise ValueError("local zigzag block must hold an even chunk pair")
    c = T2 // 2
    S, my = comm.size, comm.rank
    perm = _ring(comm)
    segmented = segment_ids is not None
    G = _kv_groups(H, k)
    dev = q.device

    def chunk_ids(rank):
        return rank, 2 * S - 1 - rank  # (early, late) global chunk index

    def split(x):
        return x[:, :c], x[:, c:]

    idx = torch.arange(c, device=dev)
    diag_mask = (idx[:, None] - idx[None, :]) >= 0

    def attend_pair(qc, q_id, sq, kc, vc, k_id, sk, state):
        """One (q chunk, k chunk) quadrant under the chunk-level causal
        structure; a fully masked quadrant is skipped."""
        if q_id < k_id:
            return state
        diag = q_id == k_id
        m, l, o = state
        if impl == "flash":
            from chainermn_tpu_torch.ops.flash_attention import (
                flash_attention_lse,
            )

            o_f, lse_f = flash_attention_lse(
                qc, kc, vc, causal=diag,
                segment_ids=sq if segmented else None,
                kv_segment_ids=sk if segmented else None)
            return _merge_flash_block(m, l, o, o_f, lse_f)
        mask = diag_mask if diag else None
        if segmented:
            seg_mask = sq[:, :, None] == sk[:, None, :]
            mask = seg_mask if mask is None else (mask[None] & seg_mask)
        return _attend(remat, qc, _expand(kc, G), _expand(vc, G), m, l, o,
                       mask)

    def fresh():
        return (torch.full((B, H, c), _NEG, dtype=torch.float32, device=dev),
                torch.zeros((B, H, c), dtype=torch.float32, device=dev),
                torch.zeros((B, c, H, D), dtype=torch.float32, device=dev))

    acc_e, acc_l = fresh(), fresh()
    q_e, q_l = split(q)
    sq_e, sq_l = split(segment_ids) if segmented else (None, None)
    my_e, my_l = chunk_ids(my)
    k_cur, v_cur, seg_cur = k, v, segment_ids
    for step in range(S):
        src = (my - step) % S
        k_e, k_l = split(k_cur)
        v_e, v_l = split(v_cur)
        sk_e, sk_l = split(seg_cur) if segmented else (None, None)
        src_e, src_l = chunk_ids(src)
        for kc, vc, k_id, sk in ((k_e, v_e, src_e, sk_e),
                                 (k_l, v_l, src_l, sk_l)):
            acc_e = attend_pair(q_e, my_e, sq_e, kc, vc, k_id, sk, acc_e)
            acc_l = attend_pair(q_l, my_l, sq_l, kc, vc, k_id, sk, acc_l)
        if step < S - 1:
            k_cur = send_recv(k_cur, comm, perm)
            v_cur = send_recv(v_cur, comm, perm)
            if segmented:
                seg_cur = comm.permute(seg_cur, perm)

    def finish(m, l, o):
        l = torch.clamp_min(l, torch.finfo(torch.float32).tiny)
        return o / l.transpose(1, 2)[..., None]

    out = torch.cat([finish(*acc_e), finish(*acc_l)], dim=1)
    return out.to(q.dtype)
