"""Decode attention: the paged kernel of the serving engine and the fused
kernel of :func:`~chainermn_tpu_torch.models.lm_generate`.

Both are single-position (or, for the paged kernel, few-position)
attention against a KV cache, bound by the bytes of K and V they read.
Each has three parts:

* a kernel written by hand for Hopper in CUDA C++
  (``chainermn_tpu_torch/csrc/decode_attention.cu``; its header says what
  bounds it and how its design answers that);
* a plain PyTorch version (``*_reference``) that follows the Pallas
  kernel's arithmetic step by step, edge cases included;
* a wrapper that validates its inputs and then runs the plain version for
  tensors on the CPU, or launches the kernel for tensors on a CUDA device.
  There is no fallback: a CUDA tensor the kernel does not take raises.
  The launch's plan (:func:`_plan`: how many CTAs of one thread-block
  cluster split each row's positions, and how many positions each bulk
  copy moves) is a pure function of static shapes and the card's SM
  count; the wrapper never reads ``valid_len`` or the block tables on the
  host, so a launch can be captured in a CUDA graph and replayed after
  they change in place.
  Each wrapper counts the launches it makes in a plain integer attribute,
  ``paged_decode_attention.launches`` and ``fused_decode_attention.launches``;
  a launch it records into a CUDA graph under capture counts in
  ``.captured`` instead.  A replay of that graph runs the kernel without
  the wrapper, so the kernels also count their runs on the card:
  :func:`kernel_runs` reads, and :func:`zero_kernel_runs` clears, a
  per-device counter that every launch adds one to when it runs, eager
  or replayed.

Layouts and semantics are the JAX package's
(``chainermn_tpu/ops/decode_attention.py``):

* :func:`fused_decode_attention` — queries ``(B, H, Dh)`` against a
  kv-head-major cache ``(B, KH, L, Dh)``; position ``p`` of row ``b`` is
  attendable iff ``p < valid_len[b]``.  The kernel splits the panel over
  the CTAs of a cluster, each folding its range into an online-softmax
  state, and merges the states, which equals the Pallas one-shot softmax
  up to fp32 rounding.  ``valid_len <=
  0`` reproduces the Pallas result over an all-masked row: the mean of V
  over the whole panel.
* :func:`paged_decode_attention` — S slots read one block pool
  ``(KH, num_blocks, block_len, Dh)`` through per-slot block tables
  ``(S, max_blocks)``.  A 4-D query ``(S, T, H, Dh)`` is the speculative
  verify chunk: offset ``t`` attends positions ``< valid_len[s] + t``.  A
  fully masked row (``valid_len == 0``) gives zeros.

int8 caches carry fp32 scales per (kv head, position): the k scale
multiplies the scores, the v scale the probabilities after the normalizer
is summed, as in the Pallas kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from chainermn_tpu_torch.ops import _kernels

#: longest fused-kernel cache the model dispatches to the kernel (the JAX
#: package's VMEM budget; the CUDA kernel streams tiles and has no such
#: limit, but the model keeps the same dispatch so both packages take the
#: same branch).
MAX_FUSED_LEN = 16384

#: most query positions per slot in the paged kernel's verify mode.
MAX_VERIFY_T = 16

#: finite stand-in for -inf, as in the Pallas kernels.
NEG_INF = -1e30

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)

#: the portable thread-block cluster size: at most this many CTAs split one
#: (slot, kv head) row's positions.
MAX_SPLITS = 8
#: CTAs per SM the split plan aims at.  On an H100, 3 measured faster than
#: 6 at every row timed (main-path, int8-GQA and long-context; longer
#: ranges per CTA amortize its setup and merge) and than 2 at all but one.
CTAS_PER_SM = 3
#: the most bytes of K (and of V) one bulk copy moves.
CHUNK_BYTES = 2048
#: query rows (T * G) one CTA holds when there is more than one (the
#: kernel's row block, ``RB`` in ``csrc/decode_attention.cu``); more rows
#: take more CTAs.
ROWS_PER_CTA = 4
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib_cache = {}


def _lib():
    lib = _lib_cache.get("lib")
    if lib is None:
        lib = _kernels.load("decode_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cmn_paged_decode_attention.argtypes = (
            [ptr] * 9 + [i32] * 13 + [ptr]
        )
        lib.cmn_paged_decode_attention.restype = i32
        lib.cmn_fused_decode_attention.argtypes = (
            [ptr] * 8 + [i32] * 10 + [ptr]
        )
        lib.cmn_fused_decode_attention.restype = i32
        lib.cmn_cuda_error_string.argtypes = [i32]
        lib.cmn_cuda_error_string.restype = ctypes.c_char_p
        _lib_cache["lib"] = lib
    return lib


# ---------------------------------------------------------------- plain
def fused_decode_attention_reference(q, kc, vc, valid_len, k_scale=None,
                                     v_scale=None):
    """Plain PyTorch version of the fused kernel: the Pallas one-shot
    softmax over the whole panel (``_decode_kernel``)."""
    B, H, Dh = q.shape
    _, KH, L, _ = kc.shape
    G = H // KH
    qg = q.reshape(B, KH, G, Dh).float() * (1.0 / math.sqrt(Dh))
    s = torch.einsum("bkgd,bkld->bkgl", qg, kc.float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    pos = torch.arange(L, device=q.device)
    valid = valid_len.to(device=q.device, dtype=torch.int64)
    s = torch.where(pos[None, None, None, :] < valid[:, None, None, None],
                    s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    o = torch.einsum("bkgl,bkld->bkgd", p, vc.float())
    o = o / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(B, H, Dh).to(q.dtype)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     valid_len, k_scale=None, v_scale=None):
    """Plain PyTorch version of the paged kernel: the Pallas online-softmax
    recurrence over logical blocks (``_paged_kernel``), blocks wholly past
    the last query row's bound skipped, masked probabilities zeroed."""
    multi = q.dim() == 4
    if multi:
        S, T, H, Dh = q.shape
    else:
        S, H, Dh = q.shape
        T = 1
    KH, NB, BL, _ = k_pool.shape
    G = H // KH
    R = T * G
    MB = block_tables.shape[1]
    dev = q.device
    qg = q.reshape(S, T, KH, G, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(S, KH, R, Dh).float() * (1.0 / math.sqrt(Dh))
    tbl = block_tables.to(device=dev, dtype=torch.int64)
    valid = valid_len.to(device=dev, dtype=torch.int64)
    toff = torch.arange(R, device=dev) // G
    m = torch.full((S, KH, R), NEG_INF, device=dev)
    l = torch.zeros((S, KH, R), device=dev)
    acc = torch.zeros((S, KH, R, Dh), device=dev)
    for mi in range(MB):
        base = mi * BL
        live = (base < valid + (T - 1))[:, None, None]  # (S, 1, 1)
        blk = tbl[:, mi]
        k = k_pool[:, blk].float().transpose(0, 1)  # (S, KH, BL, Dh)
        v = v_pool[:, blk].float().transpose(0, 1)
        s = torch.einsum("skrd,skjd->skrj", qg, k)
        if k_scale is not None:
            s = s * k_scale[:, blk].transpose(0, 1)[:, :, None, :]
        pos = base + torch.arange(BL, device=dev)
        mask = pos[None, None, None, :] < (
            valid[:, None, None, None] + toff[None, None, :, None]
        )
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * mask.float()
        l_new = alpha * l + p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale[:, blk].transpose(0, 1)[:, :, None, :]
        acc_new = alpha[..., None] * acc + torch.einsum(
            "skrj,skjd->skrd", p, v
        )
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
    out = out.reshape(S, KH, T, G, Dh).permute(0, 2, 1, 3, 4) \
        .reshape(S, T, H, Dh)
    return out if multi else out[:, 0]


# ---------------------------------------------------------------- plan
def _split_plan(n_max, pairs, sms, align):
    """``(splits, positions_per_split)`` for rows of at most ``n_max``
    positions, ``pairs`` of them (slot or batch row x kv head x row block),
    on a card of ``sms`` SMs: about :data:`CTAS_PER_SM` CTAs per SM, at
    most :data:`MAX_SPLITS` per row, each split a whole number of
    ``align``-position units.  The splits cover ``[0, n_max)`` exactly
    once and none starts past it."""
    units = max(1, -(-n_max // align))
    want = -(-CTAS_PER_SM * sms // max(1, pairs))
    splits = max(1, min(MAX_SPLITS, want, units))
    per_units = -(-units // splits)
    return -(-units // per_units), per_units * align


def _chunk(row_bytes, block_len=None):
    """Positions per bulk copy: as many as fit :data:`CHUNK_BYTES` (at
    least one); a paged copy stays inside one block, so its size divides
    ``block_len``."""
    most = max(1, CHUNK_BYTES // row_bytes)
    if block_len is None:
        return most
    return max(c for c in range(1, min(most, block_len) + 1)
               if block_len % c == 0)


@functools.lru_cache(maxsize=256)
def _plan(n_max, rows_of, KH, R, row_bytes, sms, block_len=None):
    """The launch's ``(splits, positions_per_split, chunk)``, from static
    shapes only: ``n_max`` positions a row can hold (paged ``MB * BL``,
    fused ``L``), ``rows_of`` slots or batch rows, ``KH`` kv heads, ``R =
    T * G`` query rows per kv head, ``row_bytes`` of one cached position
    and the card's ``sms``.  Paged splits start on block boundaries
    (``block_len``), fused ones on chunk boundaries."""
    chunk = _chunk(row_bytes, block_len)
    row_blocks = 1 if R == 1 else -(-R // ROWS_PER_CTA)
    splits, per = _split_plan(n_max, rows_of * KH * row_blocks, sms,
                              block_len or chunk)
    return splits, per, chunk


_sm_counts = {}


def _sm_count(dev):
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sm_counts:
        _sm_counts[i] = torch.cuda.get_device_properties(i) \
            .multi_processor_count
    return _sm_counts[i]


def _check_bulk_copy(name, addr, row_bytes):
    """The kernel moves whole cached positions (``row_bytes`` each,
    contiguous from ``addr``) with 1-D bulk copies, which take 16-byte
    aligned addresses and sizes in multiples of 16 bytes.  Every supported
    head dim and dtype gives such rows; a cache whose base is not aligned
    raises."""
    if row_bytes % 16:
        raise ValueError(
            f"{name} rows are {row_bytes} bytes: the kernel's bulk copies "
            "take multiples of 16 bytes"
        )
    if addr % 16:
        raise ValueError(
            f"{name} cache must be 16-byte aligned (the kernel reads it "
            "with bulk copies)"
        )


# ------------------------------------------------------------- checks
def _check_quant(kv_dtype, k_scale, v_scale, scale_shape):
    quant = kv_dtype == torch.int8
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 cache needs k_scale and v_scale")
    if not quant and (k_scale is not None or v_scale is not None):
        raise ValueError(
            f"k_scale/v_scale given for a {kv_dtype} cache (scales belong "
            "to int8 caches only)"
        )
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != tuple(scale_shape):
                raise ValueError(
                    f"{name} must be {tuple(scale_shape)}, got "
                    f"{tuple(sc.shape)}"
                )
    return quant


def _check_cuda(tensors, q, kv_dtype, Dh):
    """The kernel's own contract, checked before any pointer leaves
    Python."""
    dev = q.device
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, q on {dev}: all inputs must be "
                "on one device"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _Q_CODES:
        raise TypeError(
            f"q dtype {q.dtype} not supported by the CUDA kernel "
            f"(one of {list(_Q_CODES)})"
        )
    if kv_dtype not in _KV_CODES:
        raise TypeError(
            f"cache dtype {kv_dtype} not supported by the CUDA kernel "
            f"(one of {list(_KV_CODES)})"
        )
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {Dh} not supported by the CUDA kernel (one of "
            f"{SUPPORTED_HEAD_DIMS})"
        )
    for name in ("k", "v"):
        t = tensors[name]
        _check_bulk_copy(name, t.data_ptr(), Dh * t.element_size())
    for name in ("k_scale", "v_scale"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _raise_on(rc: int, what: str) -> None:
    if rc:
        msg = _lib().cmn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------ launch counters
#: slot of each kernel in a device's run counter.
_RUN_SLOTS = {"paged_decode_attention": 0, "fused_decode_attention": 1}
_runs_cache = {}


def _dev_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _runs(dev: torch.device, slot: int) -> int:
    """The address of ``slot`` of ``dev``'s run counter, made on the
    first launch.  It must exist before a capture: made under one, it
    would live in the graph's memory pool and its zeroing would be part
    of the graph."""
    dev = _dev_key(dev)
    buf = _runs_cache.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode attention: launch the kernel once outside a CUDA "
                "graph capture before capturing it (its run counter is "
                "made on the first launch)"
            )
        buf = torch.zeros((len(_RUN_SLOTS),), dtype=torch.int64, device=dev)
        _runs_cache[dev] = buf
    return buf.data_ptr() + slot * buf.element_size()


def kernel_runs(device) -> dict:
    """Runs of each kernel on ``device`` since :func:`zero_kernel_runs`
    (or the first launch), counted by the kernels themselves: eager
    launches and launches replayed from a CUDA graph alike.  Waits for
    the current stream."""
    buf = _runs_cache.get(_dev_key(device))
    counts = buf.tolist() if buf is not None else [0] * len(_RUN_SLOTS)
    return {name: int(counts[i]) for name, i in _RUN_SLOTS.items()}


def zero_kernel_runs(device) -> None:
    """Zero ``device``'s run counter (in stream order)."""
    buf = _runs_cache.get(_dev_key(device))
    if buf is not None:
        buf.zero_()


# ------------------------------------------------------------ wrappers
def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``launches`` counts launches
    that run now; ``captured`` counts launches recorded into a CUDA graph
    being captured, which run only when the graph is replayed (and are
    then counted by :func:`kernel_runs` alone)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def fused_decode_attention(q, kc, vc, valid_len, k_scale=None,
                           v_scale=None):
    """Single-position attention against a kv-head-major cache.

    Args:
      q: ``(B, H, Dh)`` queries of the current position.
      kc/vc: ``(B, KH, L, Dh)`` cache panels (float, or int8 with scales).
      valid_len: ``(B,)`` int32; positions ``< valid_len[b]`` attendable.
      k_scale/v_scale: ``(B, KH, L)`` float32, exactly when the cache is
        int8.

    Returns ``(B, H, Dh)`` in ``q``'s dtype.  CPU tensors run the plain
    version; CUDA tensors launch the kernel.
    """
    _kernels.refuse_export("fused_decode_attention")
    if q.dim() != 3 or kc.dim() != 4:
        raise ValueError(
            f"q must be (B, H, Dh) and the cache (B, KH, L, Dh), got "
            f"{tuple(q.shape)} and {tuple(kc.shape)}"
        )
    B, H, Dh = q.shape
    _, KH, L, _ = kc.shape
    if tuple(kc.shape) != (B, KH, L, Dh) or vc.shape != kc.shape:
        raise ValueError(
            f"cache shapes {tuple(kc.shape)}/{tuple(vc.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if H % KH:
        raise ValueError(f"H ({H}) must be a multiple of KH ({KH})")
    if vc.dtype != kc.dtype:
        raise TypeError(f"k/v cache dtypes differ: {kc.dtype} vs {vc.dtype}")
    if tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be ({B},), got "
                         f"{tuple(valid_len.shape)}")
    quant = _check_quant(kc.dtype, k_scale, v_scale, (B, KH, L))
    if q.device.type == "cpu":
        tensors = (kc, vc, valid_len, k_scale, v_scale)
        if any(t is not None and t.device.type != "cpu" for t in tensors):
            raise ValueError("q is on the CPU but other inputs are not")
        return fused_decode_attention_reference(
            q, kc, vc, valid_len, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda({"q": q, "k": kc, "v": vc, "valid_len": valid_len,
                 "k_scale": k_scale, "v_scale": v_scale}, q, kc.dtype, Dh)
    if valid_len.dtype != torch.int32:
        raise TypeError(f"valid_len must be int32, got {valid_len.dtype}")
    splits, per, chunk = _plan(L, B, KH, H // KH, Dh * kc.element_size(),
                               _sm_count(q.device))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().cmn_fused_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        _ptr(k_scale) if quant else None, _ptr(v_scale) if quant else None,
        valid_len.data_ptr(), out.data_ptr(),
        _runs(q.device, _RUN_SLOTS["fused_decode_attention"]),
        B, H, KH, L, Dh, _Q_CODES[q.dtype], _KV_CODES[kc.dtype],
        splits, per, chunk, stream,
    )
    _raise_on(rc, "fused decode attention")
    _count(fused_decode_attention)
    return out


fused_decode_attention.launches = 0
fused_decode_attention.captured = 0


def paged_decode_attention(q, k_pool, v_pool, block_tables, valid_len,
                           k_scale=None, v_scale=None):
    """Attention of S decode slots against a block-pooled (paged) cache.

    Args:
      q: ``(S, H, Dh)``, or ``(S, T, H, Dh)`` for a T-position speculative
        verify chunk (``T <= MAX_VERIFY_T``): offset ``t`` of slot ``s``
        attends positions ``< valid_len[s] + t``.
      k_pool/v_pool: ``(KH, num_blocks, block_len, Dh)`` pools (float, or
        int8 with scales).
      block_tables: ``(S, max_blocks)`` int32 logical -> physical block
        map; every entry the slot's bound reaches must be a valid block id.
      valid_len: ``(S,)`` int32, the first query position's bound; ``0``
        marks an idle slot (its offset-0 rows are all masked: zeros).
      k_scale/v_scale: ``(KH, num_blocks, block_len)`` float32, exactly
        when the pool is int8.

    Returns ``q``'s shape and dtype.  CPU tensors run the plain version;
    CUDA tensors launch the kernel.
    """
    _kernels.refuse_export("paged_decode_attention")
    if q.dim() == 4:
        S, T, H, Dh = q.shape
    elif q.dim() == 3:
        S, H, Dh = q.shape
        T = 1
    else:
        raise ValueError(f"q must be (S, H, Dh) or (S, T, H, Dh), got "
                         f"{tuple(q.shape)}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"pools must be (KH, num_blocks, block_len, Dh) and equal, got "
            f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}"
        )
    KH, NB, BL, pdh = k_pool.shape
    if pdh != Dh:
        raise ValueError(f"pool head dim {pdh} != q head dim {Dh}")
    if H % KH:
        raise ValueError(f"H ({H}) must be a multiple of KH ({KH})")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"k/v pool dtypes differ: {k_pool.dtype} vs {v_pool.dtype}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(
            f"block_tables must be (S={S}, max_blocks), got "
            f"{tuple(block_tables.shape)}"
        )
    if tuple(valid_len.shape) != (S,):
        raise ValueError(f"valid_len must be ({S},), got "
                         f"{tuple(valid_len.shape)}")
    if T > MAX_VERIFY_T:
        raise ValueError(f"T ({T}) exceeds MAX_VERIFY_T ({MAX_VERIFY_T})")
    quant = _check_quant(k_pool.dtype, k_scale, v_scale, (KH, NB, BL))
    MB = block_tables.shape[1]
    if q.device.type == "cpu":
        tensors = (k_pool, v_pool, block_tables, valid_len, k_scale,
                   v_scale)
        if any(t is not None and t.device.type != "cpu" for t in tensors):
            raise ValueError("q is on the CPU but other inputs are not")
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, valid_len, k_scale, v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda({"q": q, "k": k_pool, "v": v_pool,
                 "block_tables": block_tables, "valid_len": valid_len,
                 "k_scale": k_scale, "v_scale": v_scale},
                q, k_pool.dtype, Dh)
    for name, t in (("block_tables", block_tables),
                    ("valid_len", valid_len)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    splits, per, chunk = _plan(MB * BL, S, KH, T * (H // KH),
                               Dh * k_pool.element_size(),
                               _sm_count(q.device), block_len=BL)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().cmn_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _ptr(k_scale) if quant else None, _ptr(v_scale) if quant else None,
        block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        _runs(q.device, _RUN_SLOTS["paged_decode_attention"]),
        S, T, H, KH, Dh, NB, BL, MB,
        _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], splits, per, chunk,
        stream,
    )
    _raise_on(rc, "paged decode attention")
    _count(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.captured = 0


# ------------------------------------------------------ tensor parallel
# The JAX package runs the Pallas kernels per shard under ``shard_map`` on
# a 1-D ``model`` mesh (``chainermn_tpu/ops/decode_attention.py``
# ``sharded_*``): queries cut on the head axis, pools and caches on the
# KV-head axis.  Here each rank of the tensor-parallel engine is a
# process holding exactly that shard, so the sharded entry points take
# the rank's own slices and launch the same kernels on them.  Attention
# never crosses KV heads: no collective is added (the row-parallel
# ``proj`` all-reduce that follows completes the layer).


def _check_local_heads(H: int, KH: int, n: int, what: str) -> None:
    if KH < 1 or H % KH:
        raise ValueError(
            f"{what}: this rank's {H} query heads must be a whole multiple "
            f"of its {KH} KV heads (the KV-head cut over {n} model ranks "
            "keeps every query group with its KV head)")


def sharded_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                   valid_len, k_scale=None, v_scale=None,
                                   *, mesh):
    """:func:`paged_decode_attention` on one rank of a tensor-parallel
    engine: ``q`` is this rank's ``H / M`` query heads (``(S, H/M, Dh)``
    or the verify chunk's ``(S, T, H/M, Dh)``), the pools (and int8
    scales) its ``KH / M`` KV heads, the block tables and lengths the
    same on every rank.  The output is this rank's heads of the unsharded
    call, bit for bit.  ``mesh`` is the communicator over the model
    ranks (:func:`~chainermn_tpu_torch.serving.sharding.serving_mesh`)."""
    H = q.shape[-2]
    _check_local_heads(H, k_pool.shape[0], mesh.size,
                       "sharded_paged_decode_attention")
    return paged_decode_attention(q, k_pool, v_pool, block_tables,
                                  valid_len, k_scale, v_scale)


def sharded_fused_decode_attention(q, kc, vc, valid_len, k_scale=None,
                                   v_scale=None, *, mesh):
    """:func:`fused_decode_attention` on one rank of a tensor-parallel
    model: ``q`` ``(B, H/M, Dh)`` and the kv-major cache ``(B, KH/M, L,
    Dh)`` (int8 scales ``(B, KH/M, L)``) are this rank's heads; lengths
    the same on every rank."""
    _check_local_heads(q.shape[1], kc.shape[1], mesh.size,
                       "sharded_fused_decode_attention")
    return fused_decode_attention(q, kc, vc, valid_len, k_scale, v_scale)
