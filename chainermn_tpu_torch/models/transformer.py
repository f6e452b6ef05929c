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
  attention (``n_kv_heads < n_heads``).

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
  attention.

Caches are updated in place (the JAX model returns new arrays): the
forward still returns the cache beside its output, so callers read the
same way, but no copy of a cache is ever made.  Paged writes of idle
slots land in the reserved parking block 0, which no live slot reads; the
JAX model writes their own old value back there instead.

Not ported in this slice: mixture-of-experts FFNs, packed rows
(``segment_ids``), rolling (ring-buffer) decode, the flash-attention
kernel (``attention="flash"`` raises until it is), beam search and
speculative generation.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.ops.decode_attention import (
    MAX_FUSED_LEN,
    MAX_VERIFY_T,
    NEG_INF,
    fused_decode_attention,
    paged_decode_attention,
)
from chainermn_tpu_torch.ops.rope import apply_rope, rope_tables
from chainermn_tpu_torch.utils.device import resolve_device

#: Flax ``LayerNorm``'s epsilon (torch's default is 1e-5).
LN_EPS = 1e-6


def _dense(x, lin: nn.Linear, dtype):
    """Flax ``Dense(dtype=...)``: input and parameters cast to ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """Flax ``LayerNorm(dtype=...)``: statistics and affine in fp32, the
    result cast to ``dtype``."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), eps=LN_EPS)
    return y.to(dtype)


def _is_scalar(pos) -> bool:
    return not isinstance(pos, torch.Tensor) or pos.dim() == 0


def reference_attention(q, k, v, causal: bool = False, window=None):
    """Plain softmax attention over ``(B, T, H, D)`` in fp32, cast back to
    ``q``'s dtype; ``k``/``v`` may carry fewer (grouped) heads.  The
    counterpart of the JAX package's ``reference_attention`` (without
    segment ids)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if H % KH:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KH}")
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        mask &= (qi - ki < window) & (ki - qi < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


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
                 pos_enc: str = "learned", device=None):
        super().__init__()
        kh = n_kv_heads or n_heads
        if not 0 < kh <= n_heads or n_heads % kh:
            raise ValueError(
                f"n_kv_heads ({kh}) must divide n_heads ({n_heads})"
            )
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self.d_model, self.n_heads, self.n_kv_heads = d_model, n_heads, kh
        self.head_dim = d_model // n_heads
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
        self.ff1 = nn.Linear(d_model, d_ff, **fk)
        self.ff2 = nn.Linear(d_ff, d_model, **fk)

    def forward(self, h, cache=None, decode_pos=None, rope=None,
                block_tables=None, slot_mask=None):
        """Full path: ``h`` ``(B, T, D)`` -> ``(B, T, D)``.  Decode path
        (``cache`` given): attends against the cache after writing this
        chunk's K/V at ``decode_pos`` (an int, or ``(B,)`` per-row
        positions); ``block_tables``/``slot_mask`` select the paged
        layout."""
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
            if self.attention == "flash":
                raise NotImplementedError(
                    "attention='flash' needs the flash-attention kernel, "
                    "not ported yet (ROADMAP Queue 2, K1-K3); use 'auto' "
                    "or 'xla'"
                )
            a = reference_attention(q, k, v, causal=True,
                                    window=self.window or None)
        else:
            a = self._decode(q, k, v, cache, decode_pos, block_tables,
                             slot_mask)
        h = h + _dense(a.reshape(B, T, H * Dh), self.proj, dt)
        return h + self.ffn(_layer_norm(h, self.ln2, dt))

    def ffn(self, x):
        """The dense FFN: ``ff2(gelu(ff1(x)))`` with the tanh
        approximation of GELU (``flax.linen.gelu``'s default)."""
        y = F.gelu(_dense(x, self.ff1, self.dtype), approximate="tanh")
        return _dense(y, self.ff2, self.dtype)

    def _decode(self, q, k, v, cache, decode_pos, block_tables, slot_mask):
        B, T, H, Dh = q.shape
        dev = q.device
        ar = torch.arange(T, device=dev)
        if _is_scalar(decode_pos):
            p0 = int(decode_pos)
            q_pos = (p0 + ar)[None].expand(B, T)
        else:
            p0 = None
            q_pos = decode_pos.to(device=dev, dtype=torch.long)[:, None] + ar
        quant = "k_scale" in cache
        if quant:
            k_w, k_sc = _quantize(k)
            v_w, v_sc = _quantize(v)
        else:
            k_w, v_w = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        paged = block_tables is not None
        if paged:
            return self._decode_paged(q, k_w, v_w, k_sc if quant else None,
                                      v_sc if quant else None, cache,
                                      q_pos, p0, block_tables, slot_mask)
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
                return fused_decode_attention(
                    q[:, 0].contiguous(), kc, vc,
                    (q_pos[:, 0] + 1).to(torch.int32), ks_c, vs_c,
                )[:, None]
            return _attend_kv_major(q, kc, vc, q_pos, self.window, ks_c,
                                    vs_c)
        # Legacy (B, L, KH, Dh) layout, plain grouped attention.
        if p0 is not None:
            kc[:, p0:p0 + T] = k_w
            vc[:, p0:p0 + T] = v_w
            if quant:
                ks_c[:, p0:p0 + T] = k_sc
                vs_c[:, p0:p0 + T] = v_sc
        else:
            kc[rows, q_pos] = k_w
            vc[rows, q_pos] = v_w
            if quant:
                ks_c[rows, q_pos] = k_sc
                vs_c[rows, q_pos] = v_sc
        KH = kc.shape[2]
        qg = q.reshape(B, T, KH, H // KH, Dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), kc.float()) \
            / math.sqrt(Dh)
        if quant:
            s = s * ks_c.permute(0, 2, 1)[:, :, None, None, :]
        t_idx = torch.arange(kc.shape[1], device=dev)[None, None, None,
                                                      None, :]
        qp = q_pos[:, None, None, :, None]
        visible = t_idx <= qp
        if self.window:
            visible &= t_idx > qp - self.window
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        if quant:
            p = p * vs_c.permute(0, 2, 1)[:, :, None, None, :]
        a = torch.einsum("bkgqt,btkd->bqkgd", p, vc.float())
        return a.reshape(B, T, H, Dh).to(q.dtype)

    def _decode_paged(self, q, k_w, v_w, k_sc, v_sc, cache, q_pos, p0,
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
        verify = p0 is None and 1 < T <= MAX_VERIFY_T
        if self.decode_attention == "fused" and not self.window and \
                (T == 1 or verify):
            a = paged_decode_attention(
                q[:, 0].contiguous() if T == 1 else q.contiguous(),
                pool_k, pool_v, tbl.contiguous(), valid.to(torch.int32),
                ks_c, vs_c,
            )
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
    ``attention`` (``"auto"``/``"xla"`` take the plain eager path;
    ``"flash"`` raises until its kernel is ported), ``n_kv_heads`` (0 =
    ``n_heads``), ``kv_dtype`` (cache storage; ``torch.int8`` stores
    symmetric-absmax int8 with fp32 scales; None = ``dtype``), ``window``
    (sliding-window size, 0 = full), ``decode_attention`` (``"einsum"`` or
    ``"fused"``), ``pos_enc`` (``"learned"`` or ``"rope"``).

    ``device`` places the parameters; None means the current CUDA device
    and raises where there is none.  Parameters are initialized from
    ``seed`` (a private generator, the global RNG untouched).
    """

    def __init__(self, vocab: int, n_layers: int = 4, d_model: int = 256,
                 n_heads: int = 4, d_ff: int = 1024, max_len: int = 1024,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 attention: str = "auto", n_kv_heads: int = 0,
                 kv_dtype=None, window: int = 0,
                 decode_attention: str = "einsum", pos_enc: str = "learned",
                 device=None, seed: int = 0):
        super().__init__()
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
        fk = dict(device=device, dtype=param_dtype)
        self.embed = nn.Embedding(vocab, d_model, **fk)
        if pos_enc == "learned":
            self.pos = nn.Parameter(torch.empty(max_len, d_model, **fk))
        self.blocks = nn.ModuleList([
            DecoderBlock(d_model, n_heads, d_ff, dtype, param_dtype,
                         attention=attention, n_kv_heads=n_kv_heads,
                         window=window, decode_attention=decode_attention,
                         pos_enc=pos_enc, device=device)
            for _ in range(n_layers)
        ])
        self.ln_f = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.lm_head = nn.Linear(d_model, vocab, **fk)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Flax-default-like initialization from ``seed``: dense kernels
        normal with std 1/sqrt(fan_in), zero biases, unit LayerNorm
        scales, embeddings std 1/sqrt(d_model), learned positions std
        0.02."""
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

    def forward(self, tokens, return_hidden: bool = False, cache=None,
                decode_pos=None, block_tables=None, slot_mask=None):
        """``(B, T)`` tokens -> ``(B, T, vocab)`` fp32 logits (or the
        pre-head hidden states with ``return_hidden``).  With a ``cache``
        (from :meth:`init_cache`, or the serving engine's pools with
        ``block_tables``), returns ``(output, cache)``; ``decode_pos`` is
        the chunk's first position, an int or ``(B,)`` per row."""
        B, T = tokens.shape
        dev = self.device
        h = F.embedding(tokens, self.embed.weight).to(self.dtype)
        if cache is not None:
            if _is_scalar(decode_pos):
                pos_arr = int(decode_pos) + torch.arange(T, device=dev)
            else:
                pos_arr = decode_pos.to(device=dev, dtype=torch.long)[:, None] \
                    + torch.arange(T, device=dev)
        else:
            pos_arr = torch.arange(T, device=dev)
        rope = None
        if self.pos_enc == "learned":
            if pos_arr.dim() == 1:
                h = h + self.pos[pos_arr][None].to(self.dtype)
            else:
                h = h + self.pos[pos_arr].to(self.dtype)
        else:
            rope = rope_tables(pos_arr, self.head_dim)
        for i, blk in enumerate(self.blocks):
            h = blk(h, None if cache is None else cache[i], decode_pos,
                    rope=rope, block_tables=block_tables,
                    slot_mask=slot_mask)
        h = _layer_norm(h, self.ln_f, self.dtype)
        out = h if return_hidden else self.head(h)
        return out if cache is None else (out, cache)

    def head(self, h):
        """The LM head, in fp32 whatever the compute dtype."""
        return F.linear(h.float(), self.lm_head.weight.float(),
                        self.lm_head.bias.float())

    def init_cache(self, batch: int, max_len: Optional[int] = None
                   ) -> List[dict]:
        """Zeroed per-layer KV cache on the model's device: ``{"k", "v"}``
        of ``(batch, L, KH, Dh)``, or ``(batch, KH, L, Dh)`` under
        ``decode_attention="fused"``; int8 caches add fp32
        ``{"k_scale", "v_scale"}`` of the shape without ``Dh``."""
        L = max_len or self.max_len
        if self.decode_attention == "fused":
            shape = (batch, self.kv_heads, L, self.head_dim)
        else:
            shape = (batch, L, self.kv_heads, self.head_dim)
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
      rolling: the ring-buffer cache is not ported yet and raises.

    Returns ``(B, n_new)`` int32 tokens on the model's device.
    """
    if rolling:
        raise NotImplementedError(
            "rolling (ring-buffer) decode is not ported yet (ROADMAP "
            "Queue 1, decode item)"
        )
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.long)
    B, P = prompt.shape
    if n_new < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    total = check_generation_length(model, P, n_new)
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires generator")
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

    cache = model.init_cache(B, total)
    logits, cache = model(prompt, cache=cache, decode_pos=0)
    if lengths is None:
        tok = pick(logits[:, -1])
    else:
        tok = pick(logits[torch.arange(B, device=dev), lengths - 1])
    out = [tok]
    for i in range(n_new - 1):
        step_pos = (P + i) if lengths is None else (lengths + i)
        logits, cache = model(tok[:, None], cache=cache, decode_pos=step_pos)
        tok = pick(logits[:, 0])
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)
