"""Chunked softmax cross-entropy: the LM loss without the logits.

The counterpart of ``chainermn_tpu/ops/chunked_ce.py``.  The standard LM
head materializes ``(N, vocab)`` fp32 logits and, in the backward, their
gradient.  This op streams the vocabulary in chunks through an online
logsumexp: working memory is ``O(N × chunk)``, and the backward recomputes
each chunk's logits from the saved per-token logsumexp instead of storing
them (what the JAX package gets from ``jax.checkpoint`` around its scan
body).  Each chunk is a plain matrix product (``torch.matmul``), as it is
in the JAX package, which computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch


def _chunks(V: int, chunk_size: int):
    """``(start, width)`` of each vocab block: ``V // chunk`` full chunks,
    then the ragged tail (``V % chunk``) as one extra block."""
    chunk = min(chunk_size, V)
    out = [(s, chunk) for s in range(0, V - V % chunk, chunk)]
    if V % chunk:
        out.append((V - V % chunk, V % chunk))
    return out


class _ChunkedCE(torch.autograd.Function):
    """Per-token ``lse - logit[target]`` over ``(N, D)`` fp32 hidden
    states; the backward recomputes one ``(N, chunk)`` block at a time."""

    @staticmethod
    def forward(ctx, h, weight, bias, targets, chunk_size):
        N = h.shape[0]
        V = weight.shape[0]
        valid = targets >= 0
        ts = torch.where(valid, targets, torch.zeros_like(targets))
        m = torch.full((N,), float("-inf"), device=h.device)
        s = torch.zeros((N,), device=h.device)
        tl = torch.zeros((N,), device=h.device)
        for start, width in _chunks(V, chunk_size):
            logits = _block(h, weight, bias, start, width)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = ts - start
            inc = (local >= 0) & (local < width)
            lt = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
            tl = torch.where(inc, lt, tl)
        lse = m + torch.log(s)
        ctx.chunk_size = chunk_size
        ctx.save_for_backward(h, weight, bias, ts, valid, lse)
        return (lse - tl) * valid.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, weight, bias, ts, valid, lse = ctx.saved_tensors
        V = weight.shape[0]
        # d ce / d logits = (softmax - onehot(target)), zero where ignored.
        gv = g * valid.to(g.dtype)
        need_h, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        need_b = bias is not None and ctx.needs_input_grad[2]
        dh = torch.zeros_like(h) if need_h else None
        dw = torch.zeros_like(weight, dtype=torch.float32) if need_w \
            else None
        db = torch.zeros((V,), device=h.device) if need_b else None
        for start, width in _chunks(V, ctx.chunk_size):
            logits = _block(h, weight, bias, start, width)
            dl = torch.exp(logits - lse[:, None])
            local = ts - start
            inc = (local >= 0) & (local < width)
            dl.scatter_add_(1, local.clamp(0, width - 1)[:, None],
                            -inc.to(dl.dtype)[:, None])
            dl = dl * gv[:, None]
            w_c = weight[start:start + width].float()
            if need_h:
                dh += dl @ w_c
            if need_w:
                dw[start:start + width] = dl.t() @ h
            if need_b:
                db[start:start + width] = dl.sum(dim=0)
        if dw is not None:
            dw = dw.to(weight.dtype)
        if db is not None:
            db = db.to(bias.dtype)
        return dh, dw, db, None, None


def _block(h, weight, bias, start, width):
    """fp32 logits ``(N, width)`` of vocab rows ``start:start + width``."""
    logits = h @ weight[start:start + width].float().t()
    if bias is not None:
        logits = logits + bias[start:start + width].float()
    return logits


def chunked_softmax_cross_entropy(hidden: torch.Tensor,
                                  weight: torch.Tensor,
                                  targets: torch.Tensor,
                                  bias: Optional[torch.Tensor] = None,
                                  chunk_size: int = 4096) -> torch.Tensor:
    """Per-token cross entropy of ``softmax(hidden @ weight.T + bias)``
    against ``targets``, never materializing the full logits.

    Args:
      hidden: ``(..., D)`` final hidden states (any float dtype; the chunk
        products run in fp32).
      weight: ``(V, D)`` LM-head weight, ``nn.Linear``'s layout (the JAX
        function takes the ``(D, V)`` kernel).
      targets: ``(...)`` integer target ids; negative = ignore (0 loss,
        0 gradient).
      bias: optional ``(V,)`` LM-head bias.
      chunk_size: vocab slice per step; a ragged tail (``V % chunk``) is
        one extra block, so the head weight is never padded or copied.

    Returns ``(...)`` fp32 per-token losses (0 where ``targets < 0``);
    callers normalize (mask-mean), as with the JAX function.
    """
    if weight.dim() != 2:
        raise ValueError(f"weight must be (V, D), got {tuple(weight.shape)}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    lead = hidden.shape[:-1]
    h = hidden.reshape(-1, hidden.shape[-1]).float()
    t = targets.reshape(-1).to(device=h.device, dtype=torch.long)
    ce = _ChunkedCE.apply(h, weight, bias, t, int(chunk_size))
    return ce.reshape(lead)
