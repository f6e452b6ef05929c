"""Decoder-only Transformer LM and KV-cache generation, in PyTorch.

The counterpart of ``chainermn_tpu/models/transformer.py``'s
``TransformerLM`` (single-device tier) and ``lm_generate``, with the same
arithmetic and parameter layout choices:

* compute in ``dtype`` (bf16 by default) over ``param_dtype`` (fp32)
  parameters, cast at each use as Flax does;
* LayerNorm with eps 1e-6, statistics in fp32 (Flax's ``LayerNorm``);
* the tanh approximation of GELU (``flax.linen.gelu``'s default);
* the LM head in fp32;
* learned or RoPE positions; a fused ``qkv`` projection for multi-head
  attention, split ``q`` + ``kv`` projections under grouped-query
  attention (``n_kv_heads < n_heads``);
* a dense FFN, or with ``n_experts > 0`` the single-device
  mixture-of-experts FFN (:meth:`DecoderBlock.moe_ffn`: top-k routing
  with per-expert capacity, experts as stacked ``(E, ...)`` weights).

Three KV-cache layouts, as in the JAX model, chosen by the arguments of
:meth:`TransformerLM.forward`:

* **paged** (``block_tables`` given): the cache entries are the serving
  engine's block pools ``(KH, num_blocks, block_len, Dh)``; under
  ``decode_attention="fused"`` single-token steps and speculative verify
  chunks run the paged kernel
  (:func:`~chainermn_tpu_torch.ops.paged_decode_attention`), prefill
  chunks the gathered plain attention;
* **kv-major** (``decode_attention="fused"``): a contiguous ``(B, KH, L,
  Dh)`` cache; single-token steps run the fused kernel
  (:func:`~chainermn_tpu_torch.ops.fused_decode_attention`);
* **einsum** (the default): a ``(B, L, KH, Dh)`` cache and plain
  attention; with ``rolling=True`` (window models) a ring of ``window``
  slots, slot ``pos % window``.

Caches are updated in place (the JAX model returns new arrays): the
forward still returns the cache beside its output, so callers read the
same way, but no copy of a cache is ever made.  Paged writes of idle
slots land in the reserved parking block 0, which no live slot reads; the
JAX model writes their own old value back there instead.

Training (the no-cache branch): ``segment_ids`` train packed rows --
attention masked within each document and positions restarting at each
document boundary (:func:`segment_positions`); ``attention="flash"`` runs
the hand-written flash-attention kernels forward and backward
(:mod:`chainermn_tpu_torch.ops.flash_attention`), ``"xla"`` the eager
materialized-score :func:`reference_attention`, and ``"auto"`` the
former on a CUDA device and the latter on the CPU; ``remat=True``
recomputes each block in the backward (``torch.utils.checkpoint``).
:func:`lm_loss` is the data-parallel optimizer's loss,
:func:`lm_loss_chunked` the same with the LM head streamed in vocab
chunks (:func:`~chainermn_tpu_torch.ops.chunked_softmax_cross_entropy`).
Beam search and speculative generation are in
:mod:`chainermn_tpu_torch.models.decoding`.

The functional *parallel* tier (:class:`ParallelLM`,
:func:`init_parallel_lm`, :func:`dense_lm_reference`) is the JAX
package's 5-way-parallel program: data parallel over ``data``, GPipe over
``stage`` (:class:`~chainermn_tpu_torch.links.PipelineChain`),
tensor-parallel heads and the expert-parallel MoE over ``model``
(:class:`~chainermn_tpu_torch.parallel.MoELayer`), ring attention over
``seq``.  One process per rank of a 4-axis rank grid, each holding its
own slice of the parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch.functions.collective import allgather, allreduce
from chainermn_tpu_torch.links.chain_list import PipelineChain
from chainermn_tpu_torch.ops.decode_attention import (
    MAX_FUSED_LEN,
    MAX_VERIFY_T,
    NEG_INF,
    fused_decode_attention,
    paged_decode_attention,
    sharded_fused_decode_attention,
    sharded_paged_decode_attention,
)
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
    resolve_attention,
)
from chainermn_tpu_torch.ops.chunked_ce import chunked_softmax_cross_entropy
from chainermn_tpu_torch.ops.rope import apply_rope, rope_tables
from chainermn_tpu_torch.parallel.moe import MoELayer, _topk_dispatch
from chainermn_tpu_torch.parallel.ring_attention import (
    ring_flash_self_attention,
    ring_self_attention,
)
from chainermn_tpu_torch.utils.device import resolve_device

#: Flax ``LayerNorm``'s epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


def _dense(x, lin: nn.Linear, dtype):
    """Flax ``Dense(dtype=...)``: input and parameters cast to ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class _TensorParallel:
    """The collectives of one tensor-parallel model rank (inference
    only): the row-parallel sum and the vocab all-gather over ``comm``,
    the communicator over the model ranks.  ``local`` (set while the
    engine counts a step's operations, which it does on one rank alone)
    skips the wire: the sum keeps this rank's part, the gather repeats
    it."""

    def __init__(self, comm):
        self.comm = comm
        self.size = int(comm.size)
        self.rank = int(comm.rank)
        self.local = False

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.local else self.comm.allreduce(x)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along the last axis in rank order."""
        if self.local:
            return torch.cat([x] * self.size, dim=-1)
        g = self.comm.allgather(x)  # (M, ..., n)
        return torch.movedim(g, 0, -2).reshape(*x.shape[:-1], -1)


def _row_parallel(x, lin: nn.Linear, dtype, tp: "_TensorParallel"):
    """A row-parallel ``Dense``: this rank's partial product over its
    slice of the input features, summed over the model ranks.  The bias
    joins rank 0's part only, so the sum holds it once (and one rank's
    sum is the unsharded layer bit for bit)."""
    bias = lin.bias if tp.rank == 0 else None
    y = F.linear(x.to(dtype), lin.weight.to(dtype),
                 None if bias is None else bias.to(dtype))
    return tp.sum(y)


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """Flax ``LayerNorm(dtype=...)``: statistics and affine in fp32, the
    result cast to ``dtype``."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), eps=LN_EPS)
    return y.to(dtype)


def _is_scalar(pos) -> bool:
    """One position for the whole chunk: a Python int or a 0-d tensor.
    A 0-d tensor stays on its device (a CUDA graph replays it with new
    contents); only a ``(B,)`` vector gives each row its own position."""
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def _host_int(pos):
    """``pos`` as a Python int when it is one (or a numpy integer), else
    None: a tensor position is never read back to the host."""
    return None if isinstance(pos, torch.Tensor) else int(pos)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-document position restart for packed rows ``(B, T)``: each
    token's index minus its (contiguous) segment's start."""
    B, T = segment_ids.shape
    idx = torch.arange(T, device=segment_ids.device)[None, :].expand(B, T)
    is_new = torch.ones((B, T), dtype=torch.bool, device=segment_ids.device)
    is_new[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)),
                          dim=1).values
    return idx - starts


def _attend_kv_major(q, kc, vc, q_pos, window, ks_c=None, vs_c=None):
    """Grouped attention of a ``(B, T, H, Dh)`` query chunk against a
    kv-head-major ``(B, KH, L, Dh)`` cache: causal length bound per row,
    optional sliding window, int8 scales ``(B, KH, L)``."""
    B, T, H, Dh = q.shape
    KH, L = kc.shape[1], kc.shape[2]
    qg = q.reshape(B, T, KH, H // KH, Dh)
    s = torch.einsum("btkgd,bkld->bkgtl", qg.float(), kc.float()) \
        / math.sqrt(Dh)
    if ks_c is not None:
        s = s * ks_c[:, :, None, None, :]
    t_idx = torch.arange(L, device=q.device)[None, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    visible = t_idx <= qp
    if window:
        visible &= t_idx > qp - window
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if vs_c is not None:
        p = p * vs_c[:, :, None, None, :]
    a = torch.einsum("bkgtl,bkld->btkgd", p, vc.float())
    return a.reshape(B, T, H, Dh).to(q.dtype)


def _quantize(x):
    """Symmetric absmax int8 per (token, kv head) row: values and fp32
    scales ``x.shape[:-1]``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


class DecoderBlock(nn.Module):
    """One pre-norm decoder block (attention and FFN residuals)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype,
                 param_dtype, attention: str = "auto", n_kv_heads: int = 0,
                 window: int = 0, decode_attention: str = "einsum",
                 pos_enc: str = "learned", n_experts: int = 0,
                 moe_k: int = 2, moe_capacity_factor: float = 1.25,
                 moe_group: int = 512, device=None, tp=None):
        super().__init__()
        kh = n_kv_heads or n_heads
        if not 0 < kh <= n_heads or n_heads % kh:
            raise ValueError(
                f"n_kv_heads ({kh}) must divide n_heads ({n_heads})"
            )
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        # Tensor parallel (``tp``, a :class:`_TensorParallel`): this rank
        # holds H/M query heads, KH/M KV heads and, when M divides it,
        # d_ff/M of the FFN's hidden axis (else the FFN stays whole, no
        # reduction).  One rank runs the same collectives, of one rank.
        M = 1 if tp is None else tp.size
        self.tp = tp
        self.tp_ffn = tp is not None and d_ff % M == 0
        self.head_dim = d_model // n_heads
        n_heads, kh = n_heads // M, kh // M
        d_ff = d_ff // M if self.tp_ffn else d_ff
        self.d_model, self.n_heads, self.n_kv_heads = d_model, n_heads, kh
        self.dtype = dtype
        self.attention = attention
        self.window = window
        self.decode_attention = decode_attention
        self.pos_enc = pos_enc
        fk = dict(device=device, dtype=param_dtype)
        hd = self.head_dim
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        if kh == n_heads:
            self.qkv = nn.Linear(d_model, 3 * n_heads * hd, **fk)
        else:
            self.q = nn.Linear(d_model, n_heads * hd, **fk)
            self.kv = nn.Linear(d_model, 2 * kh * hd, **fk)
        self.proj = nn.Linear(n_heads * hd, d_model, **fk)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.n_experts, self.moe_k = n_experts, moe_k
        self.moe_capacity_factor, self.moe_group = moe_capacity_factor, \
            moe_group
        #: ``(moe_aux, moe_dropped)`` of each MoE forward since the model's
        #: last forward began (the JAX block ``sow``s them); read by
        #: :func:`moe_stats`.
        self.moe_stats: List[tuple] = []
        if n_experts:
            E, D, F_ = n_experts, d_model, d_ff
            # The JAX block's layouts; the router stays fp32 whatever
            # the parameter dtype.
            self.router = nn.Parameter(torch.empty(
                (D, E), device=device, dtype=torch.float32))
            self.moe_w1 = nn.Parameter(torch.empty((E, D, F_), **fk))
            self.moe_b1 = nn.Parameter(torch.empty((E, F_), **fk))
            self.moe_w2 = nn.Parameter(torch.empty((E, F_, D), **fk))
            self.moe_b2 = nn.Parameter(torch.empty((E, D), **fk))
        else:
            self.ff1 = nn.Linear(d_model, d_ff, **fk)
            self.ff2 = nn.Linear(d_ff, d_model, **fk)

    def forward(self, h, cache=None, decode_pos=None, rope=None,
                block_tables=None, slot_mask=None, segment_ids=None,
                rolling: bool = False):
        """Full path: ``h`` ``(B, T, D)`` -> ``(B, T, D)``, causal
        attention within ``segment_ids`` (``(B, T)`` int32, or None).
        Decode path
        (``cache`` given): attends against the cache after writing this
        chunk's K/V at ``decode_pos`` (an int, or ``(B,)`` per-row
        positions); ``block_tables``/``slot_mask`` select the paged
        layout; ``rolling`` treats a ``window``-slot legacy cache as a
        ring (single-token chunks, slot ``pos % window``)."""
        B, T = h.shape[:2]
        H, KH, Dh, dt = self.n_heads, self.n_kv_heads, self.head_dim, \
            self.dtype
        x = _layer_norm(h, self.ln1, dt)
        if KH == H:
            q, k, v = _dense(x, self.qkv, dt).view(B, T, 3, H, Dh).unbind(2)
        else:
            q = _dense(x, self.q, dt).view(B, T, H, Dh)
            k, v = _dense(x, self.kv, dt).view(B, T, 2, KH, Dh).unbind(2)
        if self.pos_enc == "rope":
            q = apply_rope(q, tables=rope)
            k = apply_rope(k, tables=rope)
        if cache is None:
            attend = flash_attention if resolve_attention(
                self.attention, T, device=q.device) == "flash" \
                else reference_attention
            a = attend(q, k, v, causal=True, segment_ids=segment_ids,
                       window=self.window or None)
        else:
            a = self._decode(q, k, v, cache, decode_pos, block_tables,
                             slot_mask, rolling)
        a = a.reshape(B, T, H * Dh)
        h = h + (_dense(a, self.proj, dt) if self.tp is None
                 else _row_parallel(a, self.proj, dt, self.tp))
        return h + self.ffn(_layer_norm(h, self.ln2, dt))

    def ffn(self, x):
        """The dense FFN: ``ff2(gelu(ff1(x)))`` with the tanh
        approximation of GELU (``flax.linen.gelu``'s default); the
        mixture of experts (:meth:`moe_ffn`) when ``n_experts > 0``."""
        if self.n_experts:
            return self.moe_ffn(x)
        y = F.gelu(_dense(x, self.ff1, self.dtype), approximate="tanh")
        if self.tp_ffn:
            return _row_parallel(y, self.ff2, self.dtype, self.tp)
        return _dense(y, self.ff2, self.dtype)

    def moe_ffn(self, x):
        """Single-device mixture-of-experts FFN, the JAX block's
        ``_moe_ffn``: tokens routed in groups of ``G`` (the largest size
        <= ``moe_group`` dividing ``N = B·T``), each group with capacity
        ``C = max(1, ceil(k · cf · G / E))`` per expert
        (:func:`~chainermn_tpu_torch.parallel.moe._topk_dispatch`); the
        router softmax in fp32, the dispatch einsum and the two expert
        products in the compute dtype (each ``(e, c)`` slot receives at
        most one token, so nothing accumulates), the combine in fp32.  A
        routing that loses the capacity race falls through on the
        residual.  Appends ``(moe_aux, moe_dropped)`` to
        :attr:`moe_stats`: the Switch load-balance loss and the share of
        (token, choice) routings dropped."""
        D, E, dt = self.d_model, self.n_experts, self.dtype
        B, T = x.shape[:2]
        N = B * T
        G = min(self.moe_group, N)
        while N % G:
            G -= 1
        n_groups = N // G
        C = max(1, math.ceil(self.moe_k * self.moe_capacity_factor * G / E))
        xg = x.reshape(n_groups, G, D)
        probs = torch.softmax(xg.float() @ self.router, dim=-1)  # (g, G, E)
        dispatch, combine, first = _topk_dispatch(probs, C, self.moe_k)
        f_e = first.mean(dim=1)  # (g, E)
        p_e = probs.mean(dim=1)
        aux = E * (f_e * p_e).sum(dim=-1).mean()
        dropped = 1.0 - dispatch.sum() / (N * self.moe_k)
        self.moe_stats.append((aux, dropped))
        send = torch.einsum("gnec,gnd->egcd", dispatch.to(dt), xg.to(dt)) \
            .reshape(E, n_groups * C, D)
        hmid = F.gelu(torch.einsum("exd,edf->exf", send, self.moe_w1.to(dt))
                      + self.moe_b1[:, None, :].to(dt), approximate="tanh")
        out = torch.einsum("exf,efd->exd", hmid, self.moe_w2.to(dt))
        if self.tp_ffn:
            # Row parallel over the expert hidden axis: the bias joins
            # rank 0's partial sum (see :func:`_row_parallel`).
            if self.tp.rank == 0:
                out = out + self.moe_b2[:, None, :].to(dt)
            out = self.tp.sum(out)
        else:
            out = out + self.moe_b2[:, None, :].to(dt)
        out = out.reshape(E, n_groups, C, D)
        y = torch.einsum("gnec,egcd->gnd", combine, out.float())
        return y.reshape(B, T, D).to(dt)

    def _decode(self, q, k, v, cache, decode_pos, block_tables, slot_mask,
                rolling=False):
        B, T, H, Dh = q.shape
        dev = q.device
        paged = block_tables is not None
        if rolling and (paged or self.decode_attention == "fused"):
            # The ring's slot arithmetic is the legacy layout's only.
            raise ValueError(
                "rolling decode requires decode_attention='einsum' "
                "and a non-paged cache (got decode_attention="
                f"{self.decode_attention!r}, paged={paged})"
            )
        if rolling:
            if not self.window or cache["k"].shape[1] != self.window:
                raise ValueError(
                    "rolling decode needs a window model and a "
                    f"window-sized cache (window={self.window}, cache "
                    f"len {cache['k'].shape[1]})"
                )
            if T != 1:
                raise ValueError(
                    "rolling decode is single-token (T == 1); prefill "
                    "through a full cache and convert (lm_generate "
                    f"does) — got T = {T}"
                )
        ar = torch.arange(T, device=dev)
        # ``scalar``: one start position for every row (prefill chunks,
        # searches); ``p0`` is that start as a host int when the caller
        # gave one, for slice writes (a 0-d device tensor takes the
        # indexed writes instead, without a read back).
        scalar = _is_scalar(decode_pos)
        p0 = _host_int(decode_pos) if scalar else None
        if scalar:
            start = p0 if p0 is not None else \
                decode_pos.to(device=dev, dtype=torch.long)
            q_pos = (start + ar)[None].expand(B, T)
        else:
            q_pos = decode_pos.to(device=dev, dtype=torch.long)[:, None] + ar
        quant = "k_scale" in cache
        if quant:
            k_w, k_sc = _quantize(k)
            v_w, v_sc = _quantize(v)
        else:
            k_w, v_w = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        if paged:
            return self._decode_paged(q, k_w, v_w, k_sc if quant else None,
                                      v_sc if quant else None, cache,
                                      q_pos, scalar, block_tables,
                                      slot_mask)
        kc, vc = cache["k"], cache["v"]
        ks_c = cache.get("k_scale")
        vs_c = cache.get("v_scale")
        rows = torch.arange(B, device=dev)[:, None]
        if self.decode_attention == "fused":
            # kv-head-major (B, KH, L, Dh): the fused kernel's layout.
            if p0 is not None:
                kc[:, :, p0:p0 + T] = k_w.transpose(1, 2)
                vc[:, :, p0:p0 + T] = v_w.transpose(1, 2)
                if quant:
                    ks_c[:, :, p0:p0 + T] = k_sc.transpose(1, 2)
                    vs_c[:, :, p0:p0 + T] = v_sc.transpose(1, 2)
            else:
                kc[rows, :, q_pos] = k_w
                vc[rows, :, q_pos] = v_w
                if quant:
                    ks_c[rows, :, q_pos] = k_sc
                    vs_c[rows, :, q_pos] = v_sc
            if T == 1 and not self.window and kc.shape[2] <= MAX_FUSED_LEN:
                args = (q[:, 0].contiguous(), kc, vc,
                        (q_pos[:, 0] + 1).to(torch.int32), ks_c, vs_c)
                if self.tp is not None:
                    # This rank's heads (the JAX model's decode_mesh).
                    return sharded_fused_decode_attention(
                        *args, mesh=self.tp.comm)[:, None]
                return fused_decode_attention(*args)[:, None]
            return _attend_kv_major(q, kc, vc, q_pos, self.window, ks_c,
                                    vs_c)
        # Legacy (B, L, KH, Dh) layout, plain grouped attention; a ring
        # of ``window`` slots under ``rolling`` (slot = position mod W).
        W = self.window
        if p0 is not None:
            w0 = p0 % W if rolling else p0
            kc[:, w0:w0 + T] = k_w
            vc[:, w0:w0 + T] = v_w
            if quant:
                ks_c[:, w0:w0 + T] = k_sc
                vs_c[:, w0:w0 + T] = v_sc
        else:
            cols = q_pos % W if rolling else q_pos
            kc[rows, cols] = k_w
            vc[rows, cols] = v_w
            if quant:
                ks_c[rows, cols] = k_sc
                vs_c[rows, cols] = v_sc
        KH = kc.shape[2]
        qg = q.reshape(B, T, KH, H // KH, Dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), kc.float()) \
            / math.sqrt(Dh)
        if quant:
            s = s * ks_c.permute(0, 2, 1)[:, :, None, None, :]
        t_idx = torch.arange(kc.shape[1], device=dev)[None, None, None,
                                                      None, :]
        qp = q_pos[:, None, None, :, None]
        if rolling:
            # Slot s holds position pos - ((pos - s) mod W), the latest
            # one congruent to s that is <= pos: negative means never
            # written.  Every held position lies in (pos - W, pos], so
            # window and causality need no further mask.
            visible = qp - ((qp - t_idx) % W) >= 0
        else:
            visible = t_idx <= qp
            if self.window:
                visible &= t_idx > qp - self.window
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        if quant:
            p = p * vs_c.permute(0, 2, 1)[:, :, None, None, :]
        a = torch.einsum("bkgqt,btkd->bqkgd", p, vc.float())
        return a.reshape(B, T, H, Dh).to(q.dtype)

    def _decode_paged(self, q, k_w, v_w, k_sc, v_sc, cache, q_pos, scalar,
                      block_tables, slot_mask):
        B, T, H, Dh = q.shape
        pool_k, pool_v = cache["k"], cache["v"]
        ks_c, vs_c = cache.get("k_scale"), cache.get("v_scale")
        BL = pool_k.shape[2]
        tbl = block_tables.to(device=q.device, dtype=torch.int32)
        pb = tbl.long().gather(1, q_pos // BL)  # (B, T) physical blocks
        off = q_pos % BL
        if slot_mask is not None:
            # Idle slots write into the parking block 0, never read live.
            live = slot_mask.to(torch.bool)[:, None]
            pb = torch.where(live, pb, torch.zeros_like(pb))
            off = torch.where(live, off, torch.zeros_like(off))
        pool_k[:, pb, off] = k_w.permute(2, 0, 1, 3)
        pool_v[:, pb, off] = v_w.permute(2, 0, 1, 3)
        if k_sc is not None:
            ks_c[:, pb, off] = k_sc.permute(2, 0, 1)
            vs_c[:, pb, off] = v_sc.permute(2, 0, 1)
        # The kernel's bound is the first query position's; offset t adds
        # t in the kernel.  Idle slots get 0: every row masked.
        valid = q_pos[:, 0] + 1
        if slot_mask is not None:
            valid = torch.where(slot_mask.to(torch.bool), valid,
                                torch.zeros_like(valid))
        # Verify chunks (a (B,) position vector, small T: the speculative
        # round) take the kernel's multi-query mode; prefill chunks (one
        # start position, a 0-d tensor included) the gathered attention,
        # as the JAX model decides it (``jnp.ndim(decode_pos) == 1``).
        verify = not scalar and 1 < T <= MAX_VERIFY_T
        if self.decode_attention == "fused" and not self.window and \
                (T == 1 or verify):
            args = (q[:, 0].contiguous() if T == 1 else q.contiguous(),
                    pool_k, pool_v, tbl.contiguous(), valid.to(torch.int32),
                    ks_c, vs_c)
            a = (paged_decode_attention(*args) if self.tp is None
                 else sharded_paged_decode_attention(*args,
                                                     mesh=self.tp.comm))
            return a[:, None] if T == 1 else a
        # Gathered plain attention (prefill chunks; einsum engines): each
        # row's logical kv-head-major view of its blocks.
        KH = pool_k.shape[0]
        idx = tbl.long()
        Lg = idx.shape[1] * BL
        kg = pool_k[:, idx].transpose(0, 1).reshape(B, KH, Lg, Dh)
        vg = pool_v[:, idx].transpose(0, 1).reshape(B, KH, Lg, Dh)
        ksg = vsg = None
        if ks_c is not None:
            ksg = ks_c[:, idx].transpose(0, 1).reshape(B, KH, Lg)
            vsg = vs_c[:, idx].transpose(0, 1).reshape(B, KH, Lg)
        return _attend_kv_major(q, kg, vg, q_pos, self.window, ksg, vsg)


class TransformerLM(nn.Module):
    """Decoder-only LM.

    Args mirror the JAX model's fields: ``vocab``, ``n_layers``,
    ``d_model``, ``n_heads``, ``d_ff``, ``max_len`` (the learned position
    table's length), ``dtype`` (compute), ``param_dtype`` (storage),
    ``attention`` (``"flash"``: the flash-attention kernels; ``"xla"``:
    eager materialized scores; ``"auto"``: on a CUDA device flash from
    the card's measured crossover length on
    (:func:`~chainermn_tpu_torch.ops.resolve_attention`), xla on the
    CPU), ``n_kv_heads`` (0 = ``n_heads``), ``kv_dtype`` (cache storage;
    ``torch.int8`` stores symmetric-absmax int8 with fp32 scales; None =
    ``dtype``), ``window``
    (sliding-window size, 0 = full), ``decode_attention`` (``"einsum"`` or
    ``"fused"``), ``pos_enc`` (``"learned"`` or ``"rope"``), ``remat``
    (recompute each block in the backward of a training forward),
    ``n_experts`` (0 = dense FFN; else the MoE FFN with ``d_ff`` the
    per-expert width), ``moe_k``, ``moe_capacity_factor``, ``moe_group``
    (routing group size) and ``moe_aux_weight`` (the load-balance loss's
    weight in :func:`lm_loss` / :func:`lm_loss_chunked`).

    ``device`` places the parameters; None means the current CUDA device
    and raises where there is none.  Parameters are initialized from
    ``seed`` (a private generator, the global RNG untouched).

    ``tp`` (the communicator over the model ranks of a tensor-parallel
    engine, :func:`~chainermn_tpu_torch.serving.sharding.serving_mesh`)
    builds this rank's part of the model for serving, the JAX model's
    ``decode_mesh``: ``H/M`` query and ``KH/M`` KV heads per block (the
    caches and pools hold only those), the FFN (or each expert's) hidden
    axis and the vocab cut in ``M`` where ``M`` divides them; the
    row-parallel ``proj`` and ``ff2`` (``moe_w2``) each end in one
    all-reduce over the model ranks and the fp32 head's logits are
    all-gathered, so every rank reads the same full row.  The decode
    kernels run on the rank's own heads.  Load the rank's weights with
    :func:`~chainermn_tpu_torch.serving.sharding.shard_model`.  Such a
    model serves and generates; it does not train (``ParallelLM`` is the
    training tier's tensor parallelism).
    """

    def __init__(self, vocab: int, n_layers: int = 4, d_model: int = 256,
                 n_heads: int = 4, d_ff: int = 1024, max_len: int = 1024,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 attention: str = "auto", n_kv_heads: int = 0,
                 kv_dtype=None, window: int = 0,
                 decode_attention: str = "einsum", pos_enc: str = "learned",
                 remat: bool = False, n_experts: int = 0, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25, moe_group: int = 512,
                 moe_aux_weight: float = 0.01, device=None, seed: int = 0,
                 tp=None):
        super().__init__()
        #: the constructor's model arguments (:meth:`config`).
        self._config = dict(
            vocab=vocab, n_layers=n_layers, d_model=d_model,
            n_heads=n_heads, d_ff=d_ff, max_len=max_len, dtype=dtype,
            param_dtype=param_dtype, attention=attention,
            n_kv_heads=n_kv_heads, kv_dtype=kv_dtype, window=window,
            decode_attention=decode_attention, pos_enc=pos_enc,
            remat=remat, n_experts=n_experts, moe_k=moe_k,
            moe_capacity_factor=moe_capacity_factor, moe_group=moe_group,
            moe_aux_weight=moe_aux_weight)
        device = resolve_device(device, "TransformerLM")
        if pos_enc not in ("learned", "rope"):
            raise ValueError(
                f"pos_enc={pos_enc!r}: expected 'learned' or 'rope'"
            )
        if decode_attention not in ("einsum", "fused"):
            raise ValueError(
                f"decode_attention={decode_attention!r}: expected 'einsum' "
                "or 'fused'"
            )
        if attention not in ("flash", "xla", "auto"):
            raise ValueError(
                f"attention={attention!r}: expected 'flash', 'xla' or "
                "'auto'"
            )
        kvd = kv_dtype if kv_dtype is not None else dtype
        if kvd != torch.int8 and not kvd.is_floating_point:
            raise ValueError(
                f"kv_dtype must be a float dtype or torch.int8, got {kvd}"
            )
        self.vocab, self.n_layers, self.d_model = vocab, n_layers, d_model
        self.n_heads, self.d_ff, self.max_len = n_heads, d_ff, max_len
        self.n_kv_heads = n_kv_heads
        self.dtype, self.param_dtype = dtype, param_dtype
        self.kv_dtype = kv_dtype
        self.attention, self.window = attention, window
        self.decode_attention, self.pos_enc = decode_attention, pos_enc
        self.remat = remat
        self.n_experts, self.moe_k = n_experts, moe_k
        self.moe_capacity_factor, self.moe_group = moe_capacity_factor, \
            moe_group
        self.moe_aux_weight = moe_aux_weight
        kh = n_kv_heads or n_heads
        M = 1 if tp is None else int(tp.size)
        if M > 1 and kh % M:
            raise ValueError(
                f"kv heads ({kh}) are not divisible by the {M} model ranks")
        self.tp = None if tp is None else _TensorParallel(tp)
        self.tp_size = M
        #: the head is vocab-sharded (else every rank holds it whole).
        self.tp_head = tp is not None and vocab % M == 0
        fk = dict(device=device, dtype=param_dtype)
        self.embed = nn.Embedding(vocab, d_model, **fk)
        if pos_enc == "learned":
            self.pos = nn.Parameter(torch.empty(max_len, d_model, **fk))
        self.blocks = nn.ModuleList([
            DecoderBlock(d_model, n_heads, d_ff, dtype, param_dtype,
                         attention=attention, n_kv_heads=n_kv_heads,
                         window=window, decode_attention=decode_attention,
                         pos_enc=pos_enc, n_experts=n_experts, moe_k=moe_k,
                         moe_capacity_factor=moe_capacity_factor,
                         moe_group=moe_group, device=device, tp=self.tp)
            for _ in range(n_layers)
        ])
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.lm_head = nn.Linear(d_model, vocab // M if self.tp_head
                                 else vocab, **fk)
        self.init_weights(seed)

    def config(self) -> dict:
        """The model arguments this model was built with (``device``,
        ``seed`` and ``tp`` aside): ``TransformerLM(**m.config())``
        builds the same architecture."""
        return dict(self._config)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def local_heads(self) -> int:
        """Query heads this rank holds (``n_heads`` unsharded)."""
        return self.n_heads // self.tp_size

    @property
    def local_kv_heads(self) -> int:
        """KV heads this rank's caches and pools hold."""
        return self.kv_heads // self.tp_size

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Flax-default-like initialization from ``seed``: dense kernels
        normal with std 1/sqrt(fan_in), zero biases, unit LayerNorm
        scales, embeddings std 1/sqrt(d_model), learned positions std
        0.02; MoE blocks as the JAX block initializes them: the router
        normal with std 0.02, each expert's two kernels lecun-normal
        (truncated at two standard deviations, variance 1/fan_in over
        ``d_model`` and ``d_ff``), zero expert biases."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.d_model),
                                  generator=g)
        if self.pos_enc == "learned":
            self.pos.normal_(0.0, 0.02, generator=g)
        for blk in self.blocks:
            if not blk.n_experts:
                continue
            blk.router.normal_(0.0, 0.02, generator=g)
            for w in (blk.moe_w1, blk.moe_w2):
                # Flax's lecun_normal: a normal truncated at +-2 std,
                # rescaled so that its variance is 1/fan_in.
                std = 1.0 / math.sqrt(w.shape[1]) / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
            blk.moe_b1.zero_()
            blk.moe_b2.zero_()

    def forward(self, tokens, segment_ids=None, return_hidden: bool = False,
                cache=None, decode_pos=None, block_tables=None,
                slot_mask=None, rolling: bool = False):
        """``(B, T)`` tokens -> ``(B, T, vocab)`` fp32 logits (or the
        pre-head hidden states with ``return_hidden``).

        ``segment_ids`` (``(B, T)`` int, from
        :func:`~chainermn_tpu_torch.datasets.pack_sequences`) trains
        packed rows: attention within each document, positions restarting
        at each document boundary.

        With a ``cache`` (from :meth:`init_cache`, or the serving engine's
        pools with ``block_tables``), returns ``(output, cache)``;
        ``decode_pos`` is the chunk's first position, an int or ``(B,)``
        per row; ``rolling`` decodes one token through a ``window``-slot
        ring cache (see :func:`lm_generate`).

        A MoE model's blocks collect this forward's load-balance loss and
        dropped share (:func:`moe_stats`)."""
        B, T = tokens.shape
        dev = self.device
        if self.tp is not None and torch.is_grad_enabled():
            raise RuntimeError(
                "a tensor-parallel TransformerLM serves and generates only "
                "(its collectives carry no gradient): run it under "
                "torch.no_grad(); ParallelLM trains tensor-parallel")
        for blk in self.blocks:
            blk.moe_stats.clear()
        h = F.embedding(tokens, self.embed.weight).to(self.dtype)
        if cache is not None:
            segment_ids = None
            if _is_scalar(decode_pos):
                start = _host_int(decode_pos)
                if start is None:
                    start = decode_pos.to(device=dev, dtype=torch.long)
                pos_arr = start + torch.arange(T, device=dev)
            else:
                pos_arr = decode_pos.to(device=dev, dtype=torch.long)[:, None] \
                    + torch.arange(T, device=dev)
        elif segment_ids is not None:
            segment_ids = torch.as_tensor(segment_ids, device=dev) \
                .to(torch.int32)
            pos_arr = segment_positions(segment_ids)
        else:
            pos_arr = torch.arange(T, device=dev)
        rope = None
        if self.pos_enc == "learned":
            if cache is not None:
                # Decode positions past the table clamp to its last row,
                # as the JAX model's gather does (speculative rounds run
                # finished rows on into their headroom, a prefill chunk's
                # padding may run past it; their outputs unread); on the
                # card an index past the table would be a device-side
                # assert.
                pos_arr = pos_arr.clamp_max(self.max_len - 1)
            if pos_arr.dim() == 1:
                h = h + self.pos[pos_arr][None].to(self.dtype)
            else:
                h = h + self.pos[pos_arr].to(self.dtype)
        else:
            rope = rope_tables(pos_arr, self.head_dim)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if cache is not None:
                h = blk(h, cache[i], decode_pos, rope=rope,
                        block_tables=block_tables, slot_mask=slot_mask,
                        rolling=rolling)
            elif remat:
                # No RNG state to keep (the block draws none), and
                # reading the card's generator state is refused inside a
                # CUDA-graph capture of the train step.
                h = checkpoint(blk, h, rope=rope, segment_ids=segment_ids,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = blk(h, rope=rope, segment_ids=segment_ids)
        h = _layer_norm(h, self.ln_f, self.dtype)
        out = h if return_hidden else self.head(h)
        return out if cache is None else (out, cache)

    def head(self, h):
        """The LM head, in fp32 whatever the compute dtype (a
        vocab-sharded head's logits all-gathered over the model
        ranks)."""
        out = F.linear(h.float(), self.lm_head.weight.float(),
                       self.lm_head.bias.float())
        return self.tp.gather_last(out) if self.tp_head else out

    def init_cache(self, batch: int, max_len: Optional[int] = None
                   ) -> List[dict]:
        """Zeroed per-layer KV cache on the model's device: ``{"k", "v"}``
        of ``(batch, L, KH, Dh)``, or ``(batch, KH, L, Dh)`` under
        ``decode_attention="fused"``; int8 caches add fp32
        ``{"k_scale", "v_scale"}`` of the shape without ``Dh``."""
        L = max_len or self.max_len
        KH = self.local_kv_heads
        if self.decode_attention == "fused":
            shape = (batch, KH, L, self.head_dim)
        else:
            shape = (batch, L, KH, self.head_dim)
        kvd = self.kv_dtype if self.kv_dtype is not None else self.dtype
        dev = self.device
        caches = []
        for _ in range(self.n_layers):
            c = {"k": torch.zeros(shape, dtype=kvd, device=dev),
                 "v": torch.zeros(shape, dtype=kvd, device=dev)}
            if kvd == torch.int8:
                c["k_scale"] = torch.zeros(shape[:3], device=dev)
                c["v_scale"] = torch.zeros(shape[:3], device=dev)
            caches.append(c)
        return caches


def check_generation_length(model: TransformerLM, P: int, n_new: int) -> int:
    """Only the learned position table caps generation length; returns
    ``P + n_new``."""
    total = P + n_new
    if total > model.max_len and model.pos_enc == "learned":
        raise ValueError(
            f"prompt ({P}) + n_new ({n_new}) exceeds max_len {model.max_len}"
        )
    return total


def truncate_logits(scaled, top_k: int = 0, top_p: float = 1.0):
    """top-k, then nucleus filtering of temperature-scaled ``(B, V)``
    logits (one descending sort serves both), as the JAX package does."""
    V = scaled.shape[-1]
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    neg = torch.full_like(scaled, float("-inf"))
    if top_k:
        k = min(top_k, V)
        kth = sorted_l[:, k - 1:k]
        scaled = torch.where(scaled >= kth, scaled, neg)
        sorted_l = torch.where(
            torch.arange(V, device=scaled.device)[None, :] < k, sorted_l,
            torch.full_like(sorted_l, float("-inf")),
        )
    if top_p < 1.0:
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(
            keep, sorted_l, torch.full_like(sorted_l, float("inf"))
        ).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < thresh, neg, scaled)
    return scaled


@torch.no_grad()
def lm_generate(model: TransformerLM, prompt, n_new: int,
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                top_k: int = 0, top_p: float = 1.0, prompt_lengths=None,
                rolling: bool = False) -> torch.Tensor:
    """Autoregressive generation with the KV cache: one batched prefill
    forward over the prompt, then one forward per new token.

    Args:
      prompt: ``(B, P)`` tokens (tensor or array).  Without
        ``prompt_lengths`` every row is a full-length prompt.
      n_new: tokens to generate per row.
      temperature: 0 = greedy argmax; > 0 = softmax sampling with
        ``generator`` (a :class:`torch.Generator` on the model's device).
        The samples cannot equal the JAX package's: the two frameworks'
        generators differ.
      top_k / top_p: truncation of the sampled distribution.
      prompt_lengths: optional ``(B,)`` real lengths of right-padded
        prompts; row ``i`` generates at positions ``length_i, ...``.
      rolling: sliding-window models only (``model.window > 0``, the
        einsum cache): decode through a ring of ``window`` slots instead
        of a ``P + n_new`` cache, O(window) memory however long the
        generation runs.  The prompt prefills through a prompt-sized
        cache, which then collapses into the ring.  Token-identical to
        the full cache up to fp32 summation order: the window mask hides
        everything the ring evicts.  Not with ``prompt_lengths``.

    Returns ``(B, n_new)`` int32 tokens on the model's device.
    """
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.long)
    B, P = prompt.shape
    if n_new < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    total = check_generation_length(model, P, n_new)
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires generator")
    if rolling:
        if not model.window:
            raise ValueError(
                "rolling=True needs a sliding-window model (window > 0)"
            )
        if model.decode_attention == "fused":
            raise ValueError(
                "rolling=True requires decode_attention='einsum'"
            )
        if prompt_lengths is not None:
            raise ValueError(
                "rolling=True does not support ragged prompts: pad slots "
                "written during prefill would alias real ring positions"
            )
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    lengths = None
    if prompt_lengths is not None:
        lv = torch.as_tensor(prompt_lengths).to(torch.long)
        if tuple(lv.shape) != (B,):
            raise ValueError(
                f"prompt_lengths must be ({B},), got {tuple(lv.shape)}"
            )
        if int(lv.min()) < 1 or int(lv.max()) > P:
            raise ValueError(
                f"prompt_lengths must be in [1, {P}], got range "
                f"[{int(lv.min())}, {int(lv.max())}]"
            )
        lengths = lv.to(dev)

    def pick(logits):
        if temperature > 0:
            scaled = logits / temperature
            if top_k or top_p < 1.0:
                scaled = truncate_logits(scaled, top_k, top_p)
            probs = torch.softmax(scaled, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    cache = model.init_cache(B, P if rolling else total)
    logits, cache = model(prompt, cache=cache, decode_pos=0)
    if lengths is None:
        tok = pick(logits[:, -1])
    else:
        tok = pick(logits[torch.arange(B, device=dev), lengths - 1])
    if rolling and n_new > 1:
        # Collapse the prompt-sized cache into the W-slot ring: slot s
        # takes the last prompt position congruent to s (mod W), a gather
        # (a copy).  Slots no prompt position reached (P < W) hold
        # clamped junk that the ring's never-written mask hides until a
        # real write lands there.
        W = model.window
        sl = torch.arange(W, device=dev)
        safe = ((P - 1) - ((P - 1 - sl) % W)).clamp(0, P - 1)
        cache = [{n: c[n][:, safe] for n in c} for c in cache]
    out = [tok]
    for i in range(n_new - 1):
        step_pos = (P + i) if lengths is None else (lengths + i)
        logits, cache = model(tok[:, None], cache=cache, decode_pos=step_pos,
                              rolling=rolling)
        tok = pick(logits[:, 0])
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def moe_stats(model: TransformerLM):
    """The mean ``(moe_aux, moe_dropped)`` over the MoE blocks of the
    model's last forward (the JAX package's ``_moe_stats`` of the sown
    values), or None for a dense model.  ``moe_aux`` keeps its graph: the
    losses add it, weighted, to the training loss."""
    got = [st for blk in model.blocks for st in blk.moe_stats]
    if not got:
        return None
    aux = torch.stack([a for a, _ in got]).mean()
    dropped = torch.stack([d for _, d in got]).mean()
    return aux, dropped


def _lm_batch(m: TransformerLM, batch):
    tokens, targets, *rest = batch
    dev = m.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    targets = torch.as_tensor(targets, device=dev).long()
    seg = torch.as_tensor(rest[0], device=dev) if rest else None
    return tokens, targets, seg


def _with_moe(m: TransformerLM, loss, metrics):
    """Add a MoE model's weighted load-balance loss; report ``moe_aux``
    and ``moe_dropped`` (``ppl_log`` stays the cross-entropy alone)."""
    st = moe_stats(m) if m.n_experts else None
    if st is None:
        return loss, metrics
    aux, dropped = st
    metrics["moe_aux"] = aux.detach()
    metrics["moe_dropped"] = dropped.detach()
    return loss + m.moe_aux_weight * aux, metrics


def lm_loss(model: TransformerLM):
    """``loss_fn(model, batch) -> (loss, {"ppl_log": loss})`` for the
    data-parallel optimizer: the token-mean cross-entropy of the fp32
    logits over targets ``>= 0`` (``-1`` = padding, ignored); a MoE model
    adds ``moe_aux_weight`` times the load-balance loss and reports
    ``moe_aux`` and ``moe_dropped`` beside ``ppl_log``.  A 3-tuple
    batch ``(tokens, targets, segment_ids)`` trains packed rows (see
    :func:`~chainermn_tpu_torch.datasets.pack_sequences`).  Batches may be
    numpy arrays or tensors; they move to the model's device."""
    if not isinstance(model, TransformerLM):
        raise TypeError(f"lm_loss expects a TransformerLM, got "
                        f"{type(model).__name__}")

    def loss_fn(m: TransformerLM, batch):
        tokens, targets, seg = _lm_batch(m, batch)
        logits = m(tokens, segment_ids=seg)
        mask = (targets >= 0).to(torch.float32)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.clamp_min(0).reshape(-1),
                             reduction="none").view_as(mask)
        loss = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        return _with_moe(m, loss, {"ppl_log": loss.detach()})

    return loss_fn


def lm_loss_chunked(model: TransformerLM, chunk_size: int = 4096):
    """Same contract as :func:`lm_loss`, but the LM head is streamed
    through :func:`~chainermn_tpu_torch.ops.chunked_softmax_cross_entropy`
    in vocab chunks of ``chunk_size``: the ``(B, T, vocab)`` logits and
    their gradient are never materialized (working memory
    ``O(B·T·chunk_size)``).  The head's weight and bias are the model's
    own ``lm_head``, so one set of weights serves both losses."""
    if not isinstance(model, TransformerLM):
        raise TypeError(f"lm_loss_chunked expects a TransformerLM, got "
                        f"{type(model).__name__}")

    def loss_fn(m: TransformerLM, batch):
        tokens, targets, seg = _lm_batch(m, batch)
        hidden = m(tokens, segment_ids=seg, return_hidden=True)
        ce = chunked_softmax_cross_entropy(
            hidden, m.lm_head.weight, targets, bias=m.lm_head.bias,
            chunk_size=chunk_size)
        mask = (targets >= 0).to(torch.float32)
        loss = ce.sum() / mask.sum().clamp_min(1.0)
        return _with_moe(m, loss, {"ppl_log": loss.detach()})

    return loss_fn


# =====================================================================
# The functional tier: data x stage x model x seq parallel LM
# =====================================================================
#: The rank grid's axes, in ``hybrid_mesh`` order.
PARALLEL_LM_AXES = ("data", "stage", "model", "seq")


class ParallelLMConfig(NamedTuple):
    """The JAX package's ``ParallelLMConfig``: one transformer block per
    pipeline stage; heads and experts (one per rank) sharded over
    ``model``; ``pos_enc`` "learned" (this shard's slice of a position
    table) or "rope" (rotation at global positions, ``seq_rank *
    T_local + arange``); ``attention`` "auto" (the flash ring on a card
    from ``ops.FLASH_MIN_SEQ`` local positions, the plain ring below and
    on the CPU), "flash" or "xla"; ``n_kv_heads`` 0 (dense) or the kv
    head count (GQA, sharded over ``model`` like the query heads)."""

    vocab: int
    n_stages: int
    d_model: int
    n_heads: int
    d_ff: int  # per expert
    max_len: int
    n_experts: int  # == size of the model axis
    moe_k: int = 2
    capacity_factor: float = 0.0  # 0: ample (no drops; exact vs dense)
    pos_enc: str = "learned"
    attention: str = "auto"
    n_kv_heads: int = 0


def _check_pos_enc(cfg: ParallelLMConfig) -> None:
    if cfg.pos_enc not in ("learned", "rope"):
        raise ValueError(
            f"pos_enc={cfg.pos_enc!r}: expected 'learned' or 'rope'")


def init_parallel_lm(rng: np.random.RandomState, cfg: ParallelLMConfig
                     ) -> Dict:
    """The stage-stacked parameter tree on the host, as numpy arrays: the
    JAX package's ``init_parallel_lm`` line for line, so the same
    ``RandomState`` gives bit-equal parameters."""
    _check_pos_enc(cfg)
    S, D, H, F_, E = (cfg.n_stages, cfg.d_model, cfg.n_heads, cfg.d_ff,
                      cfg.n_experts)
    Dh = D // H

    def g(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return (rng.normal(size=shape) * scale).astype(np.float32)

    KH = cfg.n_kv_heads or H
    if KH != H:
        qkv_leaves = {
            "wq": g(S, D, H, Dh, scale=1.0 / math.sqrt(D)),
            "wkv": g(S, D, 2, KH, Dh, scale=1.0 / math.sqrt(D)),
        }
    else:
        qkv_leaves = {"wqkv": g(S, D, 3, H, Dh, scale=1.0 / math.sqrt(D))}
    tree = {
        "embed": g(cfg.vocab, D, scale=0.02),
        "pos": g(cfg.max_len, D, scale=0.02),
        "stages": {
            "ln1_scale": np.ones((S, D), np.float32),
            "ln1_bias": np.zeros((S, D), np.float32),
            **qkv_leaves,
            "wo": g(S, H, Dh, D, scale=1.0 / math.sqrt(D)),
            "ln2_scale": np.ones((S, D), np.float32),
            "ln2_bias": np.zeros((S, D), np.float32),
            "router": g(S, D, E, scale=1.0 / math.sqrt(D)),
            "w1": g(S, E, D, F_, scale=1.0 / math.sqrt(D)),
            "w2": g(S, E, F_, D, scale=1.0 / math.sqrt(F_)),
        },
        "ln_f_scale": np.ones((D,), np.float32),
        "ln_f_bias": np.zeros((D,), np.float32),
        "lm_head": g(D, cfg.vocab, scale=1.0 / math.sqrt(D)),
    }
    if cfg.pos_enc == "rope":
        del tree["pos"]
    return tree


def parallel_lm_specs(cfg: ParallelLMConfig) -> Dict:
    """The axes each leaf of :func:`init_parallel_lm`'s tree is sharded
    over, one entry per array axis (the JAX package's PartitionSpecs as
    plain tuples): ``"stage"`` -- rank ``s`` of the stage axis holds
    index ``s`` (the axis is dropped from its slice); ``"model"`` -- the
    axis is cut in ``n_experts`` equal blocks, block ``m`` on model rank
    ``m``; None -- whole.  A leaf is replicated over every axis its spec
    does not name (:meth:`ParallelLM.grad_reduce` sums it there)."""
    _check_pos_enc(cfg)
    if cfg.n_kv_heads and cfg.n_kv_heads != cfg.n_heads:
        qkv = {"wq": ("stage", None, "model", None),
               "wkv": ("stage", None, None, "model", None)}
    else:
        qkv = {"wqkv": ("stage", None, None, "model", None)}
    specs = {
        "embed": (),
        "pos": (),
        "stages": {
            "ln1_scale": ("stage", None),
            "ln1_bias": ("stage", None),
            **qkv,
            "wo": ("stage", "model", None, None),
            "ln2_scale": ("stage", None),
            "ln2_bias": ("stage", None),
            "router": ("stage", None, None),
            "w1": ("stage", "model", None, None),
            "w2": ("stage", "model", None, None),
        },
        "ln_f_scale": (),
        "ln_f_bias": (),
        "lm_head": (),
    }
    if cfg.pos_enc == "rope":
        del specs["pos"]
    return specs


def _tree_items(tree, prefix=()):
    """``(path, leaf)`` of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tree_get(tree: Dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _plm_layer_norm(x, scale, bias, eps=1e-5):
    """The JAX package's ``_layer_norm`` of the parallel tier (eps
    1e-5)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


class ParallelLM:
    """The 5-way-parallel LM program, one process per rank.

    ``comm`` spans every rank of the job on a 4-axis grid
    ``hybrid_mesh({"data": D, "stage": S, "model": M, "seq": Q})`` with
    ``S == cfg.n_stages`` and ``M == cfg.n_experts``.  The constructor
    makes one communicator per axis and per set of axes the gradient
    reduction needs, every rank all of them in the same order.  Each rank
    holds its slice of the parameters
    (:func:`~chainermn_tpu_torch.utils.parallel_lm_shard`) and its
    ``(B_local, T_local)`` block of the tokens (batch split over
    ``data``, sequence over ``seq``).

    Per stage: tensor-parallel heads with an all-reduce over ``model``
    after ``wo``; GQA with the compact K/V circulating the ring; RoPE at
    global positions before the ring; the MoE over ``model`` with each
    model rank routing its ``1/M`` of the tokens and the outputs
    all-gathered back.  :meth:`loss` is this rank's share of the global
    loss, divided by the ``stage x model`` ranks that compute it alike,
    so that the sum over every rank (the loss the port's differentiable
    collectives differentiate) is the global loss; :meth:`grad_reduce`
    then sums each leaf's gradient over the axes it is replicated on."""

    def __init__(self, cfg: ParallelLMConfig, comm, n_microbatches: int):
        _check_pos_enc(cfg)
        resolve_attention(cfg.attention, 1)
        if cfg.n_kv_heads and (not 0 < cfg.n_kv_heads <= cfg.n_heads
                               or cfg.n_heads % cfg.n_kv_heads):
            raise ValueError(
                f"n_kv_heads ({cfg.n_kv_heads}) must be in (0, n_heads] "
                f"and divide n_heads ({cfg.n_heads})")
        shape = comm.mesh.shape
        if set(shape) != set(PARALLEL_LM_AXES):
            raise ValueError(f"ParallelLM needs a rank grid over "
                             f"{PARALLEL_LM_AXES}, got {tuple(shape)}")
        if shape["stage"] != cfg.n_stages or \
                shape["model"] != cfg.n_experts:
            raise ValueError(
                f"grid {shape} for n_stages {cfg.n_stages} and n_experts "
                f"{cfg.n_experts}: one stage per stage rank, one expert "
                "per model rank")
        self.cfg = cfg
        self.comm = comm
        self.n_micro = n_microbatches
        self.scomm = comm.sub("stage")
        self.mcomm = comm.sub("model")
        self.qcomm = comm.sub("seq")
        self.dcomm = comm.sub("data")
        self._token_comm = comm.sub(("data", "seq"))
        self._free = {}
        for path, spec in _tree_items(parallel_lm_specs(cfg)):
            free = tuple(a for a in PARALLEL_LM_AXES if a not in spec)
            self._free[path] = free
            if free:
                comm.sub(free)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's position on each axis of the grid."""
        return {"data": self.dcomm.rank, "stage": self.scomm.rank,
                "model": self.mcomm.rank, "seq": self.qcomm.rank}

    # --------------------------------------------------- one stage
    def _stage_apply(self, p, h, rope=None):
        """One block on this rank's ``(stage, model)`` slice ``p``; ``h``
        ``(B, T_local, D)``."""
        cfg = self.cfg
        B, Tl, D = h.shape
        x = _plm_layer_norm(h, p["ln1_scale"], p["ln1_bias"])
        if "wkv" in p:
            # GQA: k/v stay compact on the ring.
            q = torch.einsum("btd,dhe->bthe", x, p["wq"])
            kv = torch.einsum("btd,dche->btche", x, p["wkv"])
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            qkv = torch.einsum("btd,dche->btche", x, p["wqkv"])
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rope is not None:
            # Rotation at global positions before the ring: the keys each
            # shard circulates carry their true positions.
            q = apply_rope(q, tables=rope)
            k = apply_rope(k, tables=rope)
        if resolve_attention(cfg.attention, Tl, device=h.device) == "flash":
            a = ring_flash_self_attention(q, k, v, self.qcomm, causal=True)
        else:
            a = ring_self_attention(q, k, v, self.qcomm, causal=True)
        o = torch.einsum("bthe,hed->btd", a, p["wo"])
        h = h + allreduce(self.mcomm, o)  # the heads' contraction
        x = _plm_layer_norm(h, p["ln2_scale"], p["ln2_bias"])
        E = cfg.n_experts
        N = B * Tl
        if N % E:
            raise ValueError(f"local tokens {N} not divisible by experts "
                             f"{E}")
        n = N // E
        m = self.mcomm.rank
        mine = x.reshape(N, D)[m * n:(m + 1) * n]

        def expert_apply(ep, t):
            w1, w2 = ep  # this rank's expert, (1, D, F) and (1, F, D)
            return F.gelu(t @ w1[0], approximate="tanh") @ w2[0]

        cap_f = cfg.capacity_factor if cfg.capacity_factor > 0 \
            else float(E)
        moe = MoELayer(expert_apply, self.mcomm, k=cfg.moe_k,
                       capacity_factor=cap_f)
        y, _ = moe(p["router"], (p["w1"], p["w2"]), mine)
        # Every model rank's slice back in token order.
        y = allgather(self.mcomm, y).reshape(N, D)
        return h + y.reshape(B, Tl, D)

    # ------------------------------------------------------- forward
    def apply(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's tokens ``(B_local, T_local)`` -> logits ``(B_local,
        T_local, V)`` (on every stage and model rank alike); every rank
        of the grid calls it."""
        cfg = self.cfg
        B, Tl = tokens.shape
        tokens = tokens.long()
        seq_rank = self.qcomm.rank
        h = params["embed"][tokens]
        rope = None
        if cfg.pos_enc == "rope":
            pos = seq_rank * Tl + torch.arange(Tl, device=h.device)
            rope = rope_tables(pos, cfg.d_model // cfg.n_heads)
        else:
            h = h + params["pos"][seq_rank * Tl:(seq_rank + 1) * Tl][None]
        pipe = PipelineChain(lambda p, x: self._stage_apply(p, x, rope),
                             self.scomm, self.n_micro)
        h = pipe(params["stages"], h)
        h = _plm_layer_norm(h, params["ln_f_scale"], params["ln_f_bias"])
        return h @ params["lm_head"]

    def loss(self, params: Dict, batch) -> torch.Tensor:
        """This rank's share of the global masked cross-entropy: its
        local numerator over the GLOBAL valid-token count (an all-reduce
        over ``data x seq``), divided by the ``stage x model`` ranks that
        hold the same value (the JAX package's ``check_vma=False``
        convention).  :meth:`total_loss` sums it over the grid."""
        tokens, targets = batch
        logits = self.apply(params, tokens)
        targets = targets.long()
        mask = (targets >= 0).to(torch.float32)
        safe = targets.clamp_min(0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(-1, safe[..., None])[..., 0]
        n_total = self._token_comm.allreduce(mask.sum())
        share = (ce * mask).sum() / n_total.clamp_min(1.0)
        return share / (self.scomm.size * self.mcomm.size)

    def total_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The global loss from every rank's :meth:`loss` (a sum over the
        grid, no gradient)."""
        return self.comm.allreduce(loss.detach())

    # ------------------------------------------------ grad reduction
    @staticmethod
    def grads_of(params: Dict) -> Dict:
        """The tree of ``params``' ``.grad``, zeros where a leaf got none
        (``embed`` on a stage rank other than 0: the pipeline reads its
        input there only)."""
        out: Dict = {}
        for path, t in _tree_items(params):
            _tree_set(out, path, torch.zeros_like(t) if t.grad is None
                      else t.grad)
        return out

    def grad_reduce(self, grads: Dict) -> Dict:
        """Each leaf's gradient summed over exactly the axes its spec
        does not shard (a replicated leaf's gradient is the sum of its
        copies'), one all-reduce per set of axes; ``grads`` is a tree
        like this rank's parameters (:meth:`grads_of`).  With
        :meth:`loss`'s normalization the result is the JAX package's
        reduced gradient, leaf by leaf."""
        out: Dict = {}
        groups: Dict[tuple, list] = {}
        for path, g in _tree_items(grads):
            free = self._free[path]
            if free:
                groups.setdefault(free, []).append((path, g))
            else:
                _tree_set(out, path, g)
        for free, items in groups.items():
            flat = torch.cat([g.reshape(-1) for _, g in items])
            flat = self.comm.sub(free).allreduce(flat)
            at = 0
            for path, g in items:
                _tree_set(out, path, flat[at:at + g.numel()].view(g.shape))
                at += g.numel()
        return out


def dense_lm_reference(params: Dict, cfg: ParallelLMConfig, tokens,
                       device=None) -> torch.Tensor:
    """One-process oracle with the same arithmetic and no parallelism;
    ``params`` is :func:`init_parallel_lm`'s tree (numpy arrays, or
    tensors to differentiate).  ``device`` None means the current CUDA
    device (numpy leaves are moved there)."""
    dev = resolve_device(device, "dense_lm_reference")
    p = {}
    for path, v in _tree_items(params):
        _tree_set(p, path, v if isinstance(v, torch.Tensor)
                  else torch.as_tensor(np.asarray(v), device=dev))
    tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=dev).long()
    B, T = tokens.shape
    D = cfg.d_model
    h = p["embed"][tokens]
    rope = None
    if cfg.pos_enc == "rope":
        rope = rope_tables(torch.arange(T, device=dev), D // cfg.n_heads)
    else:
        h = h + p["pos"][None, :T]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    for s in range(cfg.n_stages):
        st = {k: v[s] for k, v in p["stages"].items()}
        x = _plm_layer_norm(h, st["ln1_scale"], st["ln1_bias"])
        if "wkv" in st:
            q = torch.einsum("btd,dhe->bthe", x, st["wq"])
            kv = torch.einsum("btd,dche->btche", x, st["wkv"])
            k, v = kv[:, :, 0], kv[:, :, 1]
            G = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        else:
            qkv = torch.einsum("btd,dche->btche", x, st["wqkv"])
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if rope is not None:
            q = apply_rope(q, tables=rope)
            k = apply_rope(k, tables=rope)
        sc = torch.einsum("bqhe,bkhe->bhqk", q, k) / math.sqrt(q.shape[-1])
        sc = sc.masked_fill(~causal[None, None], float("-inf"))
        a = torch.einsum("bhqk,bkhe->bqhe", torch.softmax(sc, dim=-1), v)
        h = h + torch.einsum("bthe,hed->btd", a, st["wo"])
        x = _plm_layer_norm(h, st["ln2_scale"], st["ln2_bias"])
        toks = x.reshape(B * T, D)
        probs = torch.softmax(toks @ st["router"], dim=-1)
        # Dense top-k with renormalized gates (MoELayer with ample
        # capacity).
        top = probs.topk(cfg.moe_k, dim=-1).indices
        sel = F.one_hot(top, cfg.n_experts).sum(dim=1).to(probs.dtype)
        gates = probs * sel
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(
            torch.finfo(torch.float32).tiny)
        expert_out = torch.stack(
            [F.gelu(toks @ st["w1"][e], approximate="tanh") @ st["w2"][e]
             for e in range(cfg.n_experts)], dim=1)
        y = torch.einsum("ne,ned->nd", gates, expert_out)
        h = h + y.reshape(B, T, D)
    h = _plm_layer_norm(h, p["ln_f_scale"], p["ln_f_bias"])
    return h @ p["lm_head"]
