"""Flash attention: the training path's attention, forward and backward.

The counterpart of ``chainermn_tpu/ops/flash_attention.py``: exact softmax
attention over ``(B, T, H, D)`` inputs whose ``(T, S)`` score matrix never
reaches device memory, differentiable in both of its outputs, the
attention ``o`` and the per-row logsumexp ``lse`` ``(B, H, T)``.

Three kernels, written by hand for Hopper in CUDA C++
(``chainermn_tpu_torch/csrc/flash_attention.cu``; its header says what
bounds them and how the design answers that):

* :func:`flash_attention_fwd` (K1) -- ``(o, lse)``;
* :func:`flash_attention_bwd_dkv` (K2) -- ``(dk, dv)``, the GQA group sum
  taken in fp32 inside the kernel and rounded once;
* :func:`flash_attention_bwd_dq` (K3) -- ``dq``.

Beside each, a plain fp32 PyTorch version (``*_reference``) that follows
the reference's arithmetic, masks and edge cases included: a row with no
admitted key gives ``o = 0`` and ``lse = NEG_INF``, and the backward gives
it ``p = 0``.  The three plain versions share one mask definition
(:func:`_allowed`), as the three kernels share one ``__device__`` helper.

Each wrapper validates its inputs, then runs the plain version for tensors
on the CPU or launches its kernel for tensors on a CUDA device.  There is
no fallback: a CUDA tensor the kernel does not take raises.  Each counts
its launches in a plain integer attribute (``flash_attention_fwd.launches``
and so on).  Inputs are read through their strides when the head dim is
contiguous and every other stride and the base are positive multiples of
16 bytes (the bf16 forward and dK/dV kernels load through TMA tensor maps
built from those strides; a map the driver refuses raises); otherwise the
wrapper makes a contiguous copy (the model's fused ``qkv`` views need
none).

:class:`FlashAttentionFunction` ties them together with the reference's
custom VJP: ``delta = rowsum(dO * O) - dlse`` in PyTorch, then K2 and K3.
The TPU tiling knobs of the JAX package (``block_q``, ``block_k``,
``interpret``, ``max_stage_rows``) change no result and are not taken;
the kernels accept any ``T`` and ``S``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

#: finite stand-in for -inf, as in the Pallas kernels.
NEG_INF = -1e30

#: head dims the CUDA kernels are instantiated for.
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DKV, _DQ = 0, 1, 2

_lib_cache = {}


def _lib():
    lib = _lib_cache.get("lib")
    if lib is None:
        from chainermn_tpu_torch.ops import _kernels

        lib = _kernels.load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cmn_flash_attention.argtypes = (
            [i32] + [ptr] * 11 + [i64] * 12 + [i32] * 8
            + [ctypes.c_float, i32, ptr]
        )
        lib.cmn_flash_attention.restype = i32
        lib.cmn_flash_error_string.argtypes = [i32]
        lib.cmn_flash_error_string.restype = ctypes.c_char_p
        _lib_cache["lib"] = lib
    return lib


# ---------------------------------------------------------------- masks
def _allowed(T, S, causal, window, seg_q, seg_kv, device):
    """The one mask of the three plain versions: ``(B or 1, 1, T, S)``
    bool, True where query ``t`` may attend key ``s`` (causal ``t >= s``,
    window ``|t - s| < window``, equal segment ids)."""
    qi = torch.arange(T, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    m = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window:
        m &= (qi - ki < window) & (ki - qi < window)
    m = m[None, None]
    if seg_q is not None:
        m = m & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return m


def _expand_kv(x, H):
    """``(B, S, KH, D)`` -> ``(B, S, H, D)`` in fp32: query head ``h``
    reads kv head ``h // (H // KH)`` (plain versions only; the kernels
    index the shared head instead)."""
    KH = x.shape[2]
    x = x.float()
    return x if KH == H else x.repeat_interleave(H // KH, dim=2)


# ---------------------------------------------------------------- plain
def flash_attention_fwd_reference(q, k, v, seg_q=None, seg_kv=None,
                                  causal=False, window=None):
    """Plain fp32 version of K1: ``(o, lse)`` with ``o`` in ``q``'s dtype
    ``(B, T, H, D)`` and ``lse`` fp32 ``(B, H, T)``."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    kf, vf = _expand_kv(k, H), _expand_kv(v, H)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, kf)
    ok = _allowed(T, S, causal, window, seg_q, seg_kv, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    alive = m > NEG_INF * 0.5
    p = torch.exp(s - m[..., None]) * ok
    l_safe = torch.clamp_min(p.sum(dim=-1), 1e-30)
    o = torch.einsum("bhts,bshd->bthd", p, vf) \
        / l_safe.transpose(1, 2)[..., None]
    o = torch.where(alive.transpose(1, 2)[..., None], o, torch.zeros_like(o))
    lse = torch.where(alive, m + torch.log(l_safe), torch.full_like(m,
                                                                    NEG_INF))
    return o.to(q.dtype), lse


def _probs_and_dscores(q, k, v, do, lse, delta, seg_q, seg_kv, causal,
                       window):
    """Shared by the plain K2 and K3: ``P = exp(S - lse)`` (0 on masked
    pairs and on rows whose lse is NEG_INF) and ``dS = P * (dO V^T -
    delta)``, both fp32 ``(B, H, T, S)``."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bthd,bshd->bhts", q.float() * scale, _expand_kv(k, H))
    ok = _allowed(T, S, causal, window, seg_q, seg_kv, q.device)
    live = (lse > NEG_INF * 0.5)[..., None]
    p = torch.where(ok & live, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bthd,bshd->bhts", do.float(), _expand_kv(v, H))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, seg_q=None,
                                      seg_kv=None, causal=False,
                                      window=None):
    """Plain fp32 version of K2: ``(dk, dv)`` in ``k``'s shape and dtype,
    the GQA group sum taken in fp32 and rounded once."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, seg_q, seg_kv,
                               causal, window)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * (1.0 / math.sqrt(D))
    if KH != H:
        dk = dk.reshape(B, S, KH, H // KH, D).sum(dim=3)
        dv = dv.reshape(B, S, KH, H // KH, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, seg_q=None,
                                     seg_kv=None, causal=False, window=None):
    """Plain fp32 version of K3: ``dq`` in ``q``'s shape and dtype."""
    D = q.shape[-1]
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, seg_q, seg_kv,
                               causal, window)
    dq = torch.einsum("bhts,bshd->bthd", ds, _expand_kv(k, q.shape[2])) \
        * (1.0 / math.sqrt(D))
    return dq.to(q.dtype)


# ------------------------------------------------------------- checks
def _kernel_view(t):
    """``t`` as the kernels read it -- head dim contiguous, the base and
    every other stride a positive multiple of 16 bytes (the rule of the TMA
    tensor maps through which the bf16 kernels load, and of the fp32
    kernels' 16-byte loads) -- else an aligned contiguous copy."""
    per = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s <= 0 or s % per for s in t.stride()[:-1]):
        # A fresh allocation: ``contiguous()`` would keep a contiguous
        # tensor whose base is off by a few bytes.
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check_cuda(q, tensors, segs):
    dev = q.device
    if q.dtype not in _CODES:
        raise TypeError(f"q dtype {q.dtype} not supported by the CUDA "
                        f"kernels (one of {list(_CODES)})")
    D = q.shape[-1]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the CUDA kernels "
                         f"(one of {SUPPORTED_HEAD_DIMS})")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}: all "
                             "inputs must be on one device")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
    for name, t in segs.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}")


def _check_cpu(tensors):
    for name, t in tensors.items():
        if t is not None and t.device.type != "cpu":
            raise ValueError(f"q is on the CPU but {name} is on {t.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc:
        msg = _lib().cmn_flash_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _launch(which, q, k, v, do, lse, delta, seg_q, seg_kv, out, out2,
            lse_out, causal, window):
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    dos = do.stride() if do is not None else (0, 0, 0)

    def p(t):
        return None if t is None else t.data_ptr()

    rc = _lib().cmn_flash_attention(
        which, p(q), p(k), p(v), p(do), p(lse), p(delta), p(seg_q),
        p(seg_kv), p(out), p(out2), p(lse_out),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        dos[0], dos[1], dos[2],
        B, T, S, H, KH, D, int(bool(causal)), int(window or 0),
        1.0 / math.sqrt(D), _CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, ("flash attention forward", "flash attention dK/dV",
                   "flash attention dQ")[which])


# ------------------------------------------------------------ wrappers
def flash_attention_fwd(q, k, v, seg_q=None, seg_kv=None, causal=False,
                        window=None):
    """K1: ``(o, lse)`` of ``q`` ``(B, T, H, D)`` against ``k``/``v``
    ``(B, S, KH, D)`` with optional int32 segment ids ``(B, T)``/``(B,
    S)`` (both or neither).  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        _check_cpu({"k": k, "v": v, "seg_q": seg_q, "seg_kv": seg_kv})
        return flash_attention_fwd_reference(q, k, v, seg_q, seg_kv, causal,
                                             window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, {"k": k, "v": v}, {"seg_q": seg_q, "seg_kv": seg_kv})
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch(_FWD, q, k, v, None, None, None, seg_q, seg_kv, o, None, lse,
            causal, window)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _check_bwd(q, do, lse, delta):
    B, T, H, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, T):
            raise ValueError(f"{name} must be {(B, H, T)}, got "
                             f"{tuple(t.shape)}")


def _bwd_cuda_inputs(q, k, v, do, lse, delta, seg_q, seg_kv):
    _check_cuda(q, {"k": k, "v": v, "do": do},
                {"seg_q": seg_q, "seg_kv": seg_kv})
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {q.device}")
    return (*(_kernel_view(t) for t in (q, k, v, do)), lse.contiguous(),
            delta.contiguous())


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, seg_q=None,
                            seg_kv=None, causal=False, window=None):
    """K2: ``(dk, dv)`` in ``k``'s shape and dtype, given the forward's
    ``lse`` and ``delta = rowsum(dO * O) - dlse``, both fp32 ``(B, H,
    T)``."""
    _check_bwd(q, do, lse, delta)
    if q.device.type == "cpu":
        _check_cpu({"k": k, "v": v, "do": do, "lse": lse, "delta": delta,
                    "seg_q": seg_q, "seg_kv": seg_kv})
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 seg_q, seg_kv, causal,
                                                 window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v, do, lse, delta = _bwd_cuda_inputs(q, k, v, do, lse, delta,
                                               seg_q, seg_kv)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(_DKV, q, k, v, do, lse, delta, seg_q, seg_kv, dk, dv, None,
            causal, window)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, delta, seg_q=None, seg_kv=None,
                           causal=False, window=None):
    """K3: ``dq`` in ``q``'s shape and dtype (inputs as for
    :func:`flash_attention_bwd_dkv`)."""
    _check_bwd(q, do, lse, delta)
    if q.device.type == "cpu":
        _check_cpu({"k": k, "v": v, "do": do, "lse": lse, "delta": delta,
                    "seg_q": seg_q, "seg_kv": seg_kv})
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                seg_q, seg_kv, causal,
                                                window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v, do, lse, delta = _bwd_cuda_inputs(q, k, v, do, lse, delta,
                                               seg_q, seg_kv)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(_DQ, q, k, v, do, lse, delta, seg_q, seg_kv, dq, None, None,
            causal, window)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``(o, lse)`` with the reference's custom VJP
    (``flash_attention.py:707-736``): the lse cotangent folds into the
    per-row ``delta``, since ``d lse_i / d s_ij = p_ij``."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, window):
        o, lse = flash_attention_fwd(q, k, v, seg_q, seg_kv, causal, window)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.causal, ctx.window = causal, window
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        # Gradients of unused outputs arrive as zeros (autograd
        # materializes them), so dlse is always a tensor.
        delta = ((do.float() * o.float()).sum(dim=-1).transpose(1, 2)
                 - dlse.float()).contiguous()
        args = (q, k, v, do, lse, delta, seg_q, seg_kv, ctx.causal,
                ctx.window)
        dk, dv = flash_attention_bwd_dkv(*args)
        dq = flash_attention_bwd_dq(*args)
        return dq, dk, dv, None, None, None, None


# -------------------------------------------------------------- public
def _validate(q, k, v, causal, segment_ids, kv_segment_ids, window):
    """The JAX package's contracts and ``ValueError``s; returns the
    normalized int32 ``(seg_q, seg_kv)`` (both None when unsegmented)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    KH = k.shape[2] if k.dim() == 4 else H
    if tuple(k.shape) != (B, S, KH, D) or tuple(v.shape) != (B, S, KH, D):
        raise ValueError(
            f"k/v must be (B, S, kv_heads, D) = ({B}, S, *, {D}); got "
            f"{tuple(k.shape)} / {tuple(v.shape)}"
        )
    if KH != H and (KH == 0 or H % KH):
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KH} "
                         "(grouped-query attention)")
    if causal and S != T:
        raise ValueError(
            f"causal attention needs equal q/kv lengths, got {T} vs {S}")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if S != T:
            raise ValueError(
                f"sliding-window attention needs equal q/kv lengths, got "
                f"{T} vs {S}")
    if segment_ids is None and kv_segment_ids is None:
        return None, None
    dev = q.device
    if segment_ids is None:
        segment_ids = torch.zeros((B, T), dtype=torch.int32, device=dev)
    segment_ids = torch.as_tensor(segment_ids, device=dev)
    if kv_segment_ids is None:
        if S != T:
            raise ValueError(
                "cross-attention with segment_ids needs explicit "
                "kv_segment_ids (kv length differs from q)")
        kv_segment_ids = segment_ids
    kv_segment_ids = torch.as_tensor(kv_segment_ids, device=dev)
    if tuple(segment_ids.shape) != (B, T):
        raise ValueError(f"segment_ids must be (batch, q_len) = {(B, T)}, "
                         f"got {tuple(segment_ids.shape)}")
    if tuple(kv_segment_ids.shape) != (B, S):
        raise ValueError(f"kv_segment_ids must be (batch, kv_len) = "
                         f"{(B, S)}, got {tuple(kv_segment_ids.shape)}")
    return (segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous())


def flash_attention_lse(q, k, v, causal: bool = False, segment_ids=None,
                        kv_segment_ids=None, window: Optional[int] = None):
    """Exact attention over ``(B, T, H, D)`` inputs and the per-row
    logsumexp ``(B, H, T)`` (the merge state of blockwise and ring
    composition), differentiable in both outputs.

    ``k``/``v`` are ``(B, S, KH, D)``: ``S != T`` is cross-attention
    (non-causal), ``KH < H`` grouped-query (``H % KH == 0``; query head
    ``h`` reads kv head ``h // (H // KH)``).  ``segment_ids`` ``(B, T)``
    masks attention to same-segment pairs; ``kv_segment_ids`` ``(B, S)``
    masks the key side independently (defaults to ``segment_ids``).
    ``window`` keeps ``|q - k| < window``.  A query with no admitted key
    gives zeros and ``lse = NEG_INF``."""
    seg_q, seg_kv = _validate(q, k, v, causal, segment_ids, kv_segment_ids,
                              window)
    return FlashAttentionFunction.apply(q, k, v, seg_q, seg_kv, bool(causal),
                                        window)


def flash_attention(q, k, v, causal: bool = False, segment_ids=None,
                    kv_segment_ids=None, window: Optional[int] = None):
    """:func:`flash_attention_lse` without the logsumexp; the dropped lse
    reaches the backward as a zero cotangent."""
    return flash_attention_lse(q, k, v, causal=causal,
                               segment_ids=segment_ids,
                               kv_segment_ids=kv_segment_ids,
                               window=window)[0]


def reference_attention(q, k, v, causal: bool = False, segment_ids=None,
                        kv_segment_ids=None, window: Optional[int] = None):
    """Plain softmax attention over ``(B, T, H, D)`` in fp32, cast back to
    ``q``'s dtype: the one oracle of the flash path and the eager
    ``attention="xla"`` path of the model (the JAX package's
    ``reference_attention``), differentiable by autograd."""
    return _reference_attention_lse(q, k, v, causal, segment_ids,
                                    kv_segment_ids, window)[0]


def _reference_attention_lse(q, k, v, causal=False, segment_ids=None,
                             kv_segment_ids=None, window=None):
    """:func:`reference_attention` and the per-row logsumexp ``(B, H,
    T)``, with the flash path's contracts and fully-masked-row result."""
    seg_q, seg_kv = _validate(q, k, v, causal, segment_ids, kv_segment_ids,
                              window)
    return flash_attention_fwd_reference(q, k, v, seg_q, seg_kv, causal,
                                         window)


def resolve_attention(impl: str, device=None) -> str:
    """``"flash"``/``"xla"`` pass through; ``"auto"`` is ``"flash"`` on a
    CUDA device and ``"xla"`` (the eager materialized-score path) on the
    CPU, as the reference picks ``"xla"`` off-TPU.  The TPU's measured
    crossover lengths do not carry over, and an H100 crossover is not
    measured yet, so the sequence length does not enter the choice."""
    if impl not in ("flash", "xla", "auto"):
        raise ValueError(
            f"attention={impl!r}: expected 'flash', 'xla' or 'auto'")
    if impl != "auto":
        return impl
    if device is None:
        on_cuda = torch.cuda.is_available()
    else:
        on_cuda = torch.device(device).type == "cuda"
    return "flash" if on_cuda else "xla"
