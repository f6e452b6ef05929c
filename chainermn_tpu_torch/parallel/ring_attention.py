"""Ring attention: context parallelism over a ``seq`` process group
(``chainermn_tpu/parallel/ring_attention.py``).

Q, K and V are sharded over the sequence: each of the ``S`` ranks of the
sequence communicator holds a ``(B, T/S, H, D)`` block.  K/V blocks
rotate around the ring (rank ``i`` sends to ``i + 1``) while every rank
accumulates attention of its own Q block against each visiting block;
after ``S`` steps every rank holds its exact output, and no rank ever
holds the whole sequence.

Two local forms, as in the JAX package:

* :func:`ring_self_attention` -- plain blocks with the flash-style
  online softmax (running max, normalizer and fp32 accumulator), each
  block's scores materialized (and, with ``remat``, recomputed in the
  backward rather than stored);
* :func:`ring_flash_self_attention` -- each visiting block through the
  flash kernels (K1 forward, K2/K3 backward,
  :func:`~chainermn_tpu_torch.ops.flash_attention_lse`), the per-block
  results merged exactly through their logsumexps
  (:func:`_merge_blocks`).  Causal structure is block-constant: the
  diagonal block uses the kernel's causal mask, past blocks attend
  fully, and a future block's kernel is skipped on that rank (a plain
  Python branch: the rank still takes part in every rotation).

The rotation is :func:`~chainermn_tpu_torch.functions.send_recv`, whose
backward rotates the gradients the other way round the ring.  Every rank
of the sequence communicator calls these functions, in the same order.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch.functions.point_to_point import send_recv

_NEG = float("-inf")


def _block_attend(q, k, v, m, l, o, mask):
    """One online-softmax accumulation of a visiting K/V block.

    q: ``(B, Tq, H, D)``; k/v: ``(B, Tk, H, D)``; m/l: ``(B, H, Tq)``
    fp32; o: ``(B, Tq, H, D)`` fp32; mask: bool (True = attend),
    ``(Tq, Tk)`` or ``(B, Tq, Tk)``, or None."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        s = torch.where(mask[:, None], s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # Fully-masked rows keep m_new == -inf; a finite stand-in makes their
    # exponentials 0 instead of NaN.
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(torch.where(torch.isneginf(m), m, m - m_safe))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _attend(remat: bool, *args):
    """:func:`_block_attend`, its scores recomputed in the backward when
    ``remat`` (the JAX package's ``jax.checkpoint`` of a ring step, less
    the rotation, which holds no scores)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_block_attend, *args, use_reentrant=False)
    return _block_attend(*args)


def _ring(comm):
    S = comm.size
    return [(i, (i + 1) % S) for i in range(S)]


def _expand(x, G):
    return x.repeat_interleave(G, dim=2) if G > 1 else x


def _kv_groups(H, k):
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KH}")
    return H // KH


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        comm, causal: bool = False, remat: bool = True,
                        segment_ids=None) -> torch.Tensor:
    """Exact self-attention over a sequence sharded on ``comm`` (the
    sequence communicator; the JAX package's ``axis_name``).

    Arguments are this rank's blocks ``(B, T_local, H, D)``; k/v may carry
    fewer heads (GQA: the compact blocks circulate, each expanded to the
    query heads only when attended).  ``segment_ids`` is this rank's
    ``(B, T_local)`` slice of the packed rows' segments; the key-side
    slice rotates with its K/V block.  Returns this rank's output block
    in ``q``'s dtype."""
    B, T, H, D = q.shape
    S, my = comm.size, comm.rank
    G = _kv_groups(H, k)
    dev = q.device
    m = torch.full((B, H, T), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=dev)
    perm = _ring(comm)
    idx = torch.arange(T, device=dev)
    rel = idx[:, None] - idx[None, :]  # q_pos - k_pos (local)
    k_cur, v_cur, seg_cur = k, v, segment_ids
    for step in range(S):
        mask = None
        if causal:
            # The visiting block came from rank (my - step) mod S; global
            # positions differ by (my - src) * T.
            src = (my - step) % S
            mask = (rel + (my - src) * T) >= 0
        if segment_ids is not None:
            seg_mask = segment_ids[:, :, None] == seg_cur[:, None, :]
            mask = seg_mask if mask is None else (mask[None] & seg_mask)
        m, l, o = _attend(remat, q, _expand(k_cur, G), _expand(v_cur, G),
                          m, l, o, mask)
        if step < S - 1:
            k_cur = send_recv(k_cur, comm, perm)
            v_cur = send_recv(v_cur, comm, perm)
            if segment_ids is not None:
                seg_cur = comm.permute(seg_cur, perm)
    # A row with no mass (impossible for causal self-attention, where a
    # query sees itself) would divide 0/0.
    l = torch.clamp_min(l, torch.finfo(torch.float32).tiny)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _merge_blocks(o1, lse1, o2, lse2):
    """Exactly combine two normalized attention results over disjoint key
    sets through their logsumexps.  o: ``(B, T, H, D)`` fp32; lse:
    ``(B, H, T)``.  A side with ``lse = -inf`` (a skipped block)
    contributes nothing; rows the kernel marked dead (``lse = NEG_INF``,
    finite) have zero outputs on both sides and stay zero."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    tot = torch.clamp_min(w1 + w2, torch.finfo(torch.float32).tiny)
    wt1 = (w1 / tot).transpose(1, 2)[..., None]
    wt2 = (w2 / tot).transpose(1, 2)[..., None]
    o = o1 * wt1 + o2 * wt2
    lse = m_safe + torch.log(tot)
    lse = torch.where(torch.isneginf(m), m, lse)
    return o, lse


def ring_flash_self_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, comm, causal: bool = False,
                              segment_ids=None) -> torch.Tensor:
    """:func:`ring_self_attention` with each visiting block through the
    flash kernels (K1 forward; K2 and K3 backward, the lse cotangent of
    the merge folded into their ``delta``) and the blocks merged through
    their logsumexps.  On CPU tensors the kernels' plain versions run.
    In a causal ring rank ``r`` runs ``r + 1`` blocks (the diagonal and
    ``r`` past ones): the future blocks are skipped."""
    from chainermn_tpu_torch.ops.flash_attention import flash_attention_lse

    _kv_groups(q.shape[2], k)
    S, my = comm.size, comm.rank
    perm = _ring(comm)
    segmented = segment_ids is not None

    def local(kb, vb, causal_blk, seg_kv):
        o, lse = flash_attention_lse(
            q, kb, vb, causal=causal_blk,
            segment_ids=segment_ids if segmented else None,
            kv_segment_ids=seg_kv)
        return o.float(), lse

    # Step 0 is the diagonal block on every rank.
    o_acc, lse_acc = local(k, v, causal, segment_ids)
    k_cur, v_cur, seg_cur = k, v, segment_ids
    used = True
    for step in range(1, S):
        k_cur = send_recv(k_cur, comm, perm)
        v_cur = send_recv(v_cur, comm, perm)
        if segmented:
            seg_cur = comm.permute(seg_cur, perm)
        src = (my - step) % S
        used = not (causal and src > my)
        if not used:
            # A future block: nothing of it is visible, and merging its
            # (zeros, -inf) would leave the accumulator as it is.
            continue
        o_blk, lse_blk = local(k_cur, v_cur, False, seg_cur)
        o_acc, lse_acc = _merge_blocks(o_acc, lse_acc, o_blk, lse_blk)
    if not used:
        o_acc = _tie(o_acc, k_cur, v_cur)
    return o_acc.to(q.dtype)


def _tie(out, *tensors):
    """``out`` with the ``tensors`` joined into its graph as a zero
    term.  Each rotation's backward is a collective, so every rank must
    run it: a rank whose last visiting blocks were all skipped (rank 0 of
    a causal ring sees no block after its own) would otherwise never
    backprop into its rotations, and its peers would wait for it."""
    tie = sum(t.float().sum() for t in tensors) * 0.0
    return out + tie
