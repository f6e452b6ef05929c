"""Seq2seq NMT in PyTorch: the LSTM encoder-decoder and the Transformer
encoder-decoder, their masked loss and the greedy and beam decoders.

The counterpart of ``chainermn_tpu/models/seq2seq.py``, with its
parameter layout and arithmetic:

* :class:`Seq2Seq`, the reference-parity LSTM pair.  The encoder runs over
  the whole padded source, PAD positions included, and its final carry
  seeds the decoder (no packed sequences: the JAX ``nn.RNN`` scans every
  position).  Each LSTM follows ``flax.linen.OptimizedLSTMCell``: gates
  ``i, f, g, o`` from an input product without bias and a recurrent
  product with bias, in fp32 whatever the compute dtype (Flax promotes
  the cell to its fp32 parameters).  The recurrence is a loop of per-step
  products (the JAX ``lax.scan``), so the captured train step records it
  whole; the input product of every step is one product.
* :class:`TransformerSeq2Seq`: pre-norm encoder blocks (segment-masked
  non-causal self-attention), decoder blocks (causal self-attention, then
  cross-attention over the encoder output with separate query and key
  segment ids), learned positions, an fp32 vocab head named ``proj``.
  Unpacked rows take ``src_seg = (src != PAD)`` and all-ones query
  segments, so pads are masked in the kernel; packed rows
  (:func:`~chainermn_tpu_torch.datasets.pack_pairs`) isolate every pair on
  every path and restart positions per pair.  A query that matches no key
  (a packed pad query with no source pad tail) gets zeros and a zero
  gradient, the flash kernels' dead-row contract.

Attention goes through :func:`~chainermn_tpu_torch.ops.flash_attention`
(K1-K3 on the card, their plain versions on the CPU) or the eager
materialized-score :func:`~chainermn_tpu_torch.ops.reference_attention`
(``"xla"``), chosen per block by :func:`_use_flash` exactly as the JAX
model chooses: ``"auto"`` asks ``resolve_attention(impl, *lengths)`` with
its default ``causal=True`` (the encoder too), an explicit ``"flash"``
also needs each length's largest power-of-two factor (capped at 128) to be
at least 8, else the eager path.  The JAX ``block_q``/``block_k`` tile
sizes are TPU tiling and are not taken: the kernels accept any length.

:func:`greedy_decode` and :func:`beam_decode` re-apply the whole model at
every position, as the JAX utilities do (eval utilities, not a serving
path); ``beam_decode`` ranks with the port's
:func:`~chainermn_tpu_torch.models.decoding.beam_step`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.datasets.seq import BOS, PAD
from chainermn_tpu_torch.models.decoding import (
    NEG,
    beam_step,
    penalized_scores,
)
from chainermn_tpu_torch.models.transformer import (
    LN_EPS,
    _dense,
    _layer_norm,
    segment_positions,
)
from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
    resolve_attention,
)
from chainermn_tpu_torch.utils.device import resolve_device

#: Flax ``lecun_normal``'s truncated-normal correction (std of a standard
#: normal truncated at +-2).
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class _LSTM(nn.Module):
    """``flax.linen.RNN(OptimizedLSTMCell(hidden))``: ``weight_ih`` (4H,
    E) stacks the input kernels ``ii, if, ig, io`` (no bias), ``weight_hh``
    (4H, H) the recurrent kernels ``hi, hf, hg, ho`` and ``bias`` (4H,)
    their biases, each gate's rows transposed from Flax's ``(in, out)``."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        fk = dict(device=device, dtype=torch.float32)
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, d_in, **fk))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden, **fk))
        self.bias = nn.Parameter(torch.empty(4 * hidden, **fk))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Flax's cell initializers: LeCun-normal input kernels,
        orthogonal recurrent kernels (each gate's own), zero biases."""
        H = self.hidden
        _lecun_normal_(self.weight_ih, self.weight_ih.shape[1], g)
        for k in range(4):
            w = torch.empty(H, H, device=self.weight_hh.device)
            nn.init.orthogonal_(w, generator=g)
            self.weight_hh[k * H:(k + 1) * H] = w.T
        self.bias.zero_()

    def forward(self, x, carry):
        """``x`` (B, T, E) fp32, ``carry = (c, h)`` each (B, H) fp32 ->
        ``((c, h), hs)`` with ``hs`` (B, T, H)."""
        c, h = carry
        xi = F.linear(x, self.weight_ih)
        outs = []
        for t in range(x.shape[1]):
            z = F.linear(h, self.weight_hh, self.bias) + xi[:, t]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return (c, h), torch.stack(outs, dim=1)


class Seq2Seq(nn.Module):
    """LSTM encoder-decoder with teacher forcing: ``forward(src, tgt_in)``
    with ``src`` (B, Ts) PAD-padded tokens and ``tgt_in`` (B, Tt) the
    BOS-shifted decoder inputs -> (B, Tt, vocab_tgt) logits in ``dtype``.

    Parameters (``embed_src``, ``encoder``, ``embed_tgt``, ``decoder``,
    ``proj``) are fp32 and initialized from ``seed`` as Flax initializes
    them (embeddings normal with std 1/sqrt(embed), the head LeCun
    normal).  ``device`` None means the current CUDA device (raises where
    there is none)."""

    def __init__(self, vocab_src: int, vocab_tgt: int, embed: int = 128,
                 hidden: int = 256, dtype=torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device, "Seq2Seq")
        fk = dict(device=device, dtype=torch.float32)
        self.vocab_src, self.vocab_tgt = vocab_src, vocab_tgt
        self.embed, self.hidden, self.dtype = embed, hidden, dtype
        self.embed_src = nn.Embedding(vocab_src, embed, **fk)
        self.encoder = _LSTM(embed, hidden, device)
        self.embed_tgt = nn.Embedding(vocab_tgt, embed, **fk)
        self.decoder = _LSTM(embed, hidden, device)
        self.proj = nn.Linear(hidden, vocab_tgt, **fk)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for emb in (self.embed_src, self.embed_tgt):
            emb.weight.normal_(0.0, 1.0 / math.sqrt(self.embed), generator=g)
        self.encoder.init_weights(g)
        self.decoder.init_weights(g)
        _lecun_normal_(self.proj.weight, self.hidden, g)
        self.proj.bias.zero_()

    def forward(self, src, tgt_in):
        dev = self.device
        src = torch.as_tensor(src, device=dev).long()
        tgt_in = torch.as_tensor(tgt_in, device=dev).long()
        # The cell promotes to its fp32 parameters whatever ``dtype`` is.
        emb_s = F.embedding(src, self.embed_src.weight).to(self.dtype).float()
        zeros = torch.zeros((src.shape[0], self.hidden), device=dev)
        carry, _ = self.encoder(emb_s, (zeros, zeros))
        emb_t = F.embedding(tgt_in, self.embed_tgt.weight).to(self.dtype) \
            .float()
        _, hs = self.decoder(emb_t, carry)
        return _dense(hs, self.proj, self.dtype)


def _pow2_block(n: int, cap: int = 128) -> int:
    """The largest power of two <= ``cap`` dividing ``n``."""
    b = cap
    while b > 1 and n % b:
        b //= 2
    return b


def _use_flash(impl: str, *lengths: int, device=None) -> bool:
    """Whether a block runs the flash kernels: the JAX model's rule (see
    the module docstring), with the port's crossover behind ``"auto"``."""
    if impl == "auto":
        return resolve_attention(impl, *lengths, device=device) == "flash"
    return impl == "flash" and all(_pow2_block(n) >= 8 for n in lengths)


def _check_impl(name: str, impl, allow_none: bool = False) -> None:
    if impl is None and allow_none:
        return
    if impl not in ("flash", "xla", "auto"):
        raise ValueError(
            f"{name}={impl!r}: expected 'flash', 'xla' or 'auto'"
            + (" or None" if allow_none else ""))


def _ffn(blk, x):
    """A block's FFN: ``ff2(gelu(ff1(x)))``, tanh-approximate GELU."""
    y = F.gelu(_dense(x, blk.ff1, blk.dtype), approximate="tanh")
    return _dense(y, blk.ff2, blk.dtype)


class _EncBlock(nn.Module):
    """Pre-norm encoder block: segment-masked non-causal self-attention
    (``qkv`` (3·H·Dh, D), ``proj`` (D, H·Dh)) and the FFN."""

    def __init__(self, d_model, n_heads, d_ff, dtype, attention, fk):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, d_model // n_heads
        self.dtype, self.attention = dtype, attention
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.qkv = nn.Linear(d_model, 3 * d_model, **fk)
        self.proj = nn.Linear(d_model, d_model, **fk)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.ff1 = nn.Linear(d_model, d_ff, **fk)
        self.ff2 = nn.Linear(d_ff, d_model, **fk)

    def forward(self, h, seg):
        B, T = h.shape[:2]
        H, Dh, dt = self.n_heads, self.head_dim, self.dtype
        x = _layer_norm(h, self.ln1, dt)
        q, k, v = _dense(x, self.qkv, dt).view(B, T, 3, H, Dh).unbind(2)
        if _use_flash(self.attention, T, device=h.device):
            a = flash_attention(q, k, v, segment_ids=seg)
        else:
            a = reference_attention(q, k, v, False, segment_ids=seg)
        h = h + _dense(a.reshape(B, T, H * Dh), self.proj, dt)
        return h + _ffn(self, _layer_norm(h, self.ln2, dt))


class _DecBlock(nn.Module):
    """Pre-norm decoder block: causal self-attention (``qkv``,
    ``self_proj``; segment-masked on packed rows), cross-attention
    (``cross_q`` (H·Dh, D), ``cross_kv`` (2·H·Dh, D), ``cross_proj``) over
    the encoder output, and the FFN."""

    def __init__(self, d_model, n_heads, d_ff, dtype, attention, fk):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, d_model // n_heads
        self.dtype, self.attention = dtype, attention
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.qkv = nn.Linear(d_model, 3 * d_model, **fk)
        self.self_proj = nn.Linear(d_model, d_model, **fk)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.cross_q = nn.Linear(d_model, d_model, **fk)
        self.cross_kv = nn.Linear(d_model, 2 * d_model, **fk)
        self.cross_proj = nn.Linear(d_model, d_model, **fk)
        self.ln3 = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.ff1 = nn.Linear(d_model, d_ff, **fk)
        self.ff2 = nn.Linear(d_ff, d_model, **fk)

    def forward(self, h, enc, src_seg, tgt_seg=None):
        B, Tt = h.shape[:2]
        S = enc.shape[1]
        H, Dh, dt = self.n_heads, self.head_dim, self.dtype
        dev = h.device
        x = _layer_norm(h, self.ln1, dt)
        q, k, v = _dense(x, self.qkv, dt).view(B, Tt, 3, H, Dh).unbind(2)
        if _use_flash(self.attention, Tt, device=dev):
            a = flash_attention(q, k, v, causal=True, segment_ids=tgt_seg)
        else:
            a = reference_attention(q, k, v, True, segment_ids=tgt_seg)
        h = h + _dense(a.reshape(B, Tt, H * Dh), self.self_proj, dt)
        x = _layer_norm(h, self.ln2, dt)
        cq = _dense(x, self.cross_q, dt).view(B, Tt, H, Dh)
        ck, cv = _dense(enc, self.cross_kv, dt).view(B, S, 2, H, Dh) \
            .unbind(2)
        q_seg = tgt_seg if tgt_seg is not None else torch.ones(
            (B, Tt), dtype=torch.int32, device=dev)
        if _use_flash(self.attention, Tt, S, device=dev):
            a = flash_attention(cq, ck, cv, segment_ids=q_seg,
                                kv_segment_ids=src_seg)
        else:
            a = reference_attention(cq, ck, cv, False, segment_ids=q_seg,
                                    kv_segment_ids=src_seg)
        h = h + _dense(a.reshape(B, Tt, H * Dh), self.cross_proj, dt)
        return h + _ffn(self, _layer_norm(h, self.ln3, dt))


class TransformerSeq2Seq(nn.Module):
    """Transformer encoder-decoder on the flash kernels, with the
    ``(src, tgt_in)`` contract of :class:`Seq2Seq` (so
    :func:`seq2seq_loss`, :func:`greedy_decode` and :func:`beam_decode`
    take either).

    ``attention`` is ``"flash"``, ``"xla"`` or ``"auto"``;
    ``enc_attention`` overrides it for the encoder alone (None: follow
    ``attention``).  Compute in ``dtype`` over fp32 parameters (LayerNorm
    statistics and the vocab head in fp32).  Parameters:
    ``embed_src``, ``embed_tgt``, ``pos`` (max_len, D), ``enc.{i}``,
    ``ln_enc``, ``dec.{i}``, ``ln_dec``, ``proj``; initialized from
    ``seed`` (dense kernels normal with std 1/sqrt(fan_in), zero biases,
    unit LayerNorm scales, embeddings std 1/sqrt(d_model), positions std
    0.02).  ``device`` None means the current CUDA device (raises where
    there is none)."""

    def __init__(self, vocab_src: int, vocab_tgt: int, d_model: int = 128,
                 n_heads: int = 4, d_ff: int = 256, n_enc: int = 2,
                 n_dec: int = 2, max_len: int = 128, dtype=torch.float32,
                 attention: str = "auto",
                 enc_attention: Optional[str] = None, device=None,
                 seed: int = 0):
        super().__init__()
        _check_impl("attention", attention)
        _check_impl("enc_attention", enc_attention, allow_none=True)
        if d_model % n_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by n_heads {n_heads}")
        device = resolve_device(device, "TransformerSeq2Seq")
        fk = dict(device=device, dtype=torch.float32)
        self.vocab_src, self.vocab_tgt = vocab_src, vocab_tgt
        self.d_model, self.n_heads, self.d_ff = d_model, n_heads, d_ff
        self.n_enc, self.n_dec, self.max_len = n_enc, n_dec, max_len
        self.dtype = dtype
        self.attention, self.enc_attention = attention, enc_attention
        self.embed_src = nn.Embedding(vocab_src, d_model, **fk)
        self.pos = nn.Parameter(torch.empty(max_len, d_model, **fk))
        self.enc = nn.ModuleList([
            _EncBlock(d_model, n_heads, d_ff, dtype,
                      enc_attention or attention, fk)
            for _ in range(n_enc)])
        self.ln_enc = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.embed_tgt = nn.Embedding(vocab_tgt, d_model, **fk)
        self.dec = nn.ModuleList([
            _DecBlock(d_model, n_heads, d_ff, dtype, attention, fk)
            for _ in range(n_dec)])
        self.ln_dec = nn.LayerNorm(d_model, eps=LN_EPS, **fk)
        self.proj = nn.Linear(d_model, vocab_tgt, **fk)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=g)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for emb in (self.embed_src, self.embed_tgt):
            emb.weight.normal_(0.0, 1.0 / math.sqrt(self.d_model),
                               generator=g)
        self.pos.normal_(0.0, 0.02, generator=g)

    def _embed(self, emb, tokens, seg):
        dt = self.dtype
        h = F.embedding(tokens, emb.weight).to(dt)
        if seg is not None:
            return h + self.pos[segment_positions(seg)].to(dt)
        return h + self.pos[:tokens.shape[1]][None].to(dt)

    def forward(self, src, tgt_in, src_seg=None, tgt_seg=None):
        """Unpacked (default): one pair per row, ``src_seg`` derived from
        PAD, positions ``0..T``.  Packed (pass both ``src_seg`` and
        ``tgt_seg``): several pairs per row, attention isolated per pair
        on every path and positions restarting per pair."""
        if (src_seg is None) != (tgt_seg is None):
            raise ValueError(
                "packed rows need BOTH src_seg and tgt_seg (got one)")
        dev = self.device
        src = torch.as_tensor(src, device=dev).long()
        tgt_in = torch.as_tensor(tgt_in, device=dev).long()
        Ts, Tt = src.shape[1], tgt_in.shape[1]
        if max(Ts, Tt) > self.max_len:
            raise ValueError(
                f"sequence length {max(Ts, Tt)} exceeds max_len "
                f"{self.max_len} (raise max_len)")
        packed = src_seg is not None
        if packed:
            src_seg = torch.as_tensor(src_seg, device=dev).to(torch.int32)
            tgt_seg = torch.as_tensor(tgt_seg, device=dev).to(torch.int32)
        else:
            src_seg = (src != PAD).to(torch.int32)  # real 1, pad 0
        h = self._embed(self.embed_src, src, src_seg if packed else None)
        for blk in self.enc:
            h = blk(h, src_seg)
        enc = _layer_norm(h, self.ln_enc, self.dtype)
        t = self._embed(self.embed_tgt, tgt_in, tgt_seg)
        for blk in self.dec:
            t = blk(t, enc, src_seg, tgt_seg)
        t = _layer_norm(t, self.ln_dec, self.dtype)
        return F.linear(t.float(), self.proj.weight.float(),
                        self.proj.bias.float())


def seq2seq_loss(model: nn.Module):
    """Masked token-level cross entropy: ``loss_fn(model, batch) -> (loss,
    {"token_accuracy": ...})``.  ``batch = (src, tgt)``, both PAD-padded;
    the decoder input is BOS + tgt[:-1].  A 4-tuple batch ``(src, tgt,
    src_seg, tgt_seg)`` (from :func:`~chainermn_tpu_torch.datasets.
    pack_pairs`) trains packed rows: each pair's first decoder input is
    BOS, and the mask is segment-derived.  Batches may be numpy arrays or
    tensors; they move to the model's device."""

    def loss_fn(m, batch):
        src, tgt, *segs = batch
        dev = m.device
        tgt = torch.as_tensor(tgt, device=dev).long()
        B = tgt.shape[0]
        bos = torch.full((B, 1), BOS, dtype=torch.long, device=dev)
        shifted = torch.cat([bos, tgt[:, :-1]], dim=1)
        if segs:
            src_seg, tgt_seg = (torch.as_tensor(s, device=dev)
                                .to(torch.int32) for s in segs)
            is_start = torch.ones(tgt.shape, dtype=torch.bool, device=dev)
            is_start[:, 1:] = tgt_seg[:, 1:] != tgt_seg[:, :-1]
            tgt_in = torch.where(is_start, torch.full_like(shifted, BOS),
                                 shifted)
            logits = m(src, tgt_in, src_seg, tgt_seg)
            mask = (tgt_seg != 0).float()
        else:
            logits = m(src, shifted)
            mask = (tgt != PAD).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                             tgt.reshape(-1), reduction="none") \
            .view_as(mask)
        denom = mask.sum().clamp_min(1.0)
        loss = (ce * mask).sum() / denom
        correct = ((logits.argmax(-1) == tgt).float() * mask).sum()
        return loss, {"token_accuracy": (correct / denom).detach()}

    return loss_fn


@torch.no_grad()
def greedy_decode(model: nn.Module, src, max_len: int = 32) -> torch.Tensor:
    """Greedy decoding with static shapes, the whole model re-applied per
    position.  Returns ``(B, max_len)`` int32: position ``i`` holds the
    prediction after consuming BOS and the ``i`` tokens before it."""
    dev = model.device
    src = torch.as_tensor(src, device=dev).long()
    B = src.shape[0]
    tgt_in = torch.full((B, max_len), PAD, dtype=torch.long, device=dev)
    tgt_in[:, 0] = BOS
    for i in range(max_len - 1):
        tgt_in[:, i + 1] = model(src, tgt_in)[:, i].argmax(-1)
    return model(src, tgt_in).argmax(-1).to(torch.int32)


@torch.no_grad()
def beam_decode(model: nn.Module, src, max_len: int = 32, beam: int = 4,
                length_penalty: float = 0.0,
                eos_id: Optional[int] = None) -> torch.Tensor:
    """Beam-search decoding with static shapes (the whole model re-applied
    per position, as :func:`greedy_decode`).  Beams fold into the batch
    (row ``b * beam + k``); scores start at ``[0, NEG, ...]`` so the first
    step seeds ``beam`` distinct tokens.  With ``eos_id`` a beam that
    emits it freezes (PAD at log-probability 0, its length stops) and the
    ranking uses ``sum_logprob / length ** length_penalty``.  Returns
    ``(B, max_len)`` int32 in :func:`greedy_decode`'s contract; ``beam=1``
    with ``eos_id=None`` is greedy."""
    if beam < 1:
        raise ValueError(f"beam must be >= 1, got {beam}")
    dev = model.device
    src = torch.as_tensor(src, device=dev).long()
    B, K = src.shape[0], beam
    srcK = src.repeat_interleave(K, dim=0)  # row order b*K + k
    tgt = torch.full((B * K, max_len), PAD, dtype=torch.long, device=dev)
    tgt[:, 0] = BOS
    scores = torch.full((B, K), NEG, device=dev)
    scores[:, 0] = 0.0
    alive = torch.ones((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev) * K)[:, None]
    for i in range(max_len - 1):
        logits = model(srcK, tgt)
        logp = torch.log_softmax(logits[:, i].float(), dim=-1) \
            .reshape(B, K, -1)
        parent, nxt, scores, alive, lengths = beam_step(
            scores, alive, lengths, logp, length_penalty, eos_id, PAD)
        tgt = tgt[(base + parent).reshape(B * K)]
        tgt[:, i + 1] = nxt.reshape(B * K)
    best = penalized_scores(scores, lengths, length_penalty).argmax(-1)
    best_tgt = tgt[torch.arange(B, device=dev) * K + best]
    final = model(src, best_tgt)[:, -1].argmax(-1)
    return torch.cat([best_tgt[:, 1:], final[:, None]], dim=1) \
        .to(torch.int32)
