#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name, PyTorch and CUDA versions, and the card's
   name and power limit as ``nvidia-smi`` reports them.
2. ``build``: ``nvcc`` compiles every source under
   ``chainermn_tpu_torch/csrc/`` for sm_90a, all at once (the ptxas
   report of registers, shared memory and spills goes to stderr).
3. ``parity``: each hand-written kernel against its plain PyTorch version
   on the same inputs at the serving model's shapes: fp32 (atol 1e-4:
   sums in another order), bf16 (atol 2e-2: one bf16 rounding of O(1)
   outputs) and int8 pools with grouped-query heads (atol 2e-2), with
   speculative verify chunks (T = 4), idle slots (valid_len = 0) and every
   supported head dim.
4. ``timing``: device times (CUDA-graph replay, CUDA events) of each
   kernel, its plain version and one PyTorch library call computing the
   same function, at the main path's shapes with the L2 cache cold,
   beside the least time the card could take (the larger of bytes over
   3.35 TB/s and operations over the peak rate of the input type), and
   the kernel wrapper's eager per-call time.
5. ``serving``: the full-width model of the serving benchmark (12 layers,
   d_model 768, 12 heads, d_ff 3072, vocab 32768, RoPE, seeded random
   weights, bf16 compute) through ``DecodeEngine`` + ``Scheduler.run`` on
   16 requests; then the same model with 4 kv heads and an int8 cache.
6. ``generation``: ``lm_generate`` at batch 8, prompt 128, 64 new tokens.
7. ``agreement``: the engine and ``lm_generate`` on the same requests with
   the model in fp32, so that bf16 near-ties cannot flip tokens.
8. ``flash_parity``: the flash-attention kernels (forward, dK/dV, dQ)
   through their autograd Function, ``(o, lse)`` forward and ``(dq, dk,
   dv)`` backward with a nonzero lse cotangent, against their plain
   versions: causal, non-causal, window, packed segments with fully masked
   rows, cross-attention with kv segments, GQA 12->4, MQA, ragged T = 1000,
   head dims 32/64/128, fp32 and bf16; then each kernel alone at the
   training path's shapes.  Each element is held to |err| <= rtol |ref| +
   atol rms(its reference row over the head dim): fp32 rtol 1e-5, atol
   1e-4 (sums in another order); bf16 rtol 2^-7 (each side rounds its
   output to bf16), atol 3e-2 (P and dS rounded to bf16 as tensor-core
   operands); lse |err| <= 1e-5 |ref| + 1e-5.  The line shows each
   reading before any check.
9. ``flash_timing``: as phase 4, for each flash kernel at the training
   path's shapes (batch 8, 12 heads, T 2048, Dh 64, bf16, causal); the
   library yardstick is ``F.scaled_dot_product_attention(is_causal=True)``:
   its forward for the forward kernel, its backward (forward + backward
   minus forward) for the two backward kernels together.
10. ``training``: the LM benchmark's default model (benchmarks/lm.py: batch
   8, seq 2048, 12 layers, d_model 768, 12 heads, d_ff 3072, vocab 32768,
   learned positions, bf16 compute over fp32 params, AdamW 3e-4, remat
   on, a bf16 gradient wire) through the training entry path
   (``create_communicator`` -> ``create_multi_node_optimizer(adamw)`` ->
   ``make_train_step(lm_loss(model))``) on a fixed seeded batch (targets =
   tokens): 2 warm-up and 5 timed steps with ``attention="flash"``, then
   the same with the eager ``attention="xla"``; then the ``train_lm``
   example for 3 steps.  One more step of each arm runs under
   ``torch.profiler`` (``training_trace``: device time by kernel, busy
   share).
11. ``training_agreement``: a 2-layer fp32 model (d_model 128, 4 heads,
   T 256, packed rows) trained 3 steps with the flash kernels and 3 with
   the plain path from the same weights: losses within rtol 1e-5,
   parameters within atol 1e-4 (fp32 sums in another order, through
   three Adam steps of lr 1e-3).

The launch counters are set to 0 just before each drive of the main path
(phases 5, 6 and the timed steps of 10) and read just after it.  Then
come the ``kernels`` line,
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  A
failed check raises and exits non-zero before the last line; without a
CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: the serving benchmark's default model (benchmarks/serving.py).
FULL = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
            pos_enc="rope", decode_attention="fused")
ENGINE = dict(capacity=8, block_len=16, prefill_chunk=32)

#: H100 SXM data-sheet rates (dense): device memory, and peak operations
#: per second by input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 1979e12}

#: the LM benchmark's default model (benchmarks/lm.py:39-46).
LM = dict(vocab=32768, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
          max_len=2048)
LM_BATCH = 8

#: each kernel of the port, the TPU kernel it replaces, and its source.
KERNELS = {
    "flash_attention_fwd": "chainermn_tpu/ops/flash_attention.py:191",
    "flash_attention_bwd_dkv": "chainermn_tpu/ops/flash_attention.py:427",
    "flash_attention_bwd_dq": "chainermn_tpu/ops/flash_attention.py:493",
    "paged_decode_attention": "chainermn_tpu/ops/decode_attention.py:196",
    "fused_decode_attention": "chainermn_tpu/ops/decode_attention.py:101",
}
SOURCES = {k: "chainermn_tpu_torch/csrc/flash_attention.cu"
           for k in list(KERNELS)[:3]}
SOURCES.update({k: "chainermn_tpu_torch/csrc/decode_attention.cu"
                for k in list(KERNELS)[3:]})
FLASH = list(KERNELS)[:3]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ inputs
def quantize(x):
    """Symmetric absmax int8 over the last axis, as the model writes."""
    scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.float().contiguous()


def paged_inputs(g, dev, S, T, H, KH, Dh, BL, MB, valid, dtype, quant,
                 spare=8):
    """Inputs of the paged kernel as the engine lays them out: each slot
    owns distinct shuffled blocks covering its last row's bound, the rest
    of its table parks on block 0."""
    need = [math.ceil(min(max(v + T - 1, 0), MB * BL) / BL) for v in valid]
    NB = 1 + sum(need) + spare
    perm = (torch.randperm(NB - 1, generator=g) + 1).tolist()
    tables = torch.zeros((S, MB), dtype=torch.int32)
    for s, n in enumerate(need):
        tables[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    qshape = (S, T, H, Dh) if T > 1 else (S, H, Dh)
    q = torch.randn(qshape, generator=g)
    kp = torch.randn((KH, NB, BL, Dh), generator=g)
    vp = torch.randn((KH, NB, BL, Dh), generator=g)
    ks = vs = None
    if quant:
        kp, ks = quantize(kp)
        vp, vs = quantize(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    to = dict(device=dev)
    return dict(
        q=q.to(dtype=dtype, **to), k=kp.to(**to), v=vp.to(**to),
        tables=tables.to(**to),
        valid=torch.tensor(valid, dtype=torch.int32, **to),
        ks=None if ks is None else ks.to(**to),
        vs=None if vs is None else vs.to(**to),
    )


def fused_inputs(g, dev, B, H, KH, L, Dh, valid, dtype, quant):
    q = torch.randn((B, H, Dh), generator=g)
    kc = torch.randn((B, KH, L, Dh), generator=g)
    vc = torch.randn((B, KH, L, Dh), generator=g)
    ks = vs = None
    if quant:
        kc, ks = quantize(kc)
        vc, vs = quantize(vc)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    to = dict(device=dev)
    return dict(
        q=q.to(dtype=dtype, **to), k=kc.to(**to), v=vc.to(**to),
        valid=torch.tensor(valid, dtype=torch.int32, **to),
        ks=None if ks is None else ks.to(**to),
        vs=None if vs is None else vs.to(**to),
    )


def run_paged(ops, a, plain=False):
    fn = ops.paged_decode_attention_reference if plain \
        else ops.paged_decode_attention
    return fn(a["q"], a["k"], a["v"], a["tables"], a["valid"], a["ks"],
              a["vs"])


def run_fused(ops, a, plain=False):
    fn = ops.fused_decode_attention_reference if plain \
        else ops.fused_decode_attention
    return fn(a["q"], a["k"], a["v"], a["valid"], a["ks"], a["vs"])


# ------------------------------------------------------------------ parity
PAGED_CASES = [
    # name, T, KH, Dh, q/kv dtype, int8 pools, atol
    ("bf16", 1, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32", 1, 12, 64, torch.float32, False, 1e-4),
    ("bf16_verify4", 4, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32_gqa_verify4", 4, 4, 64, torch.float32, False, 1e-4),
    ("int8_gqa", 1, 4, 64, torch.bfloat16, True, 2e-2),
    ("int8_gqa_verify4", 4, 4, 64, torch.bfloat16, True, 2e-2),
    ("fp32_dh16", 1, 6, 16, torch.float32, False, 1e-4),
    ("int8_dh16", 2, 6, 16, torch.float32, True, 1e-4),
    ("fp32_dh32", 3, 4, 32, torch.float32, False, 1e-4),
    ("bf16_dh128", 1, 12, 128, torch.bfloat16, False, 2e-2),
]
FUSED_CASES = [
    # name, L, KH, Dh, dtype, int8 cache, atol
    ("bf16", 192, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32", 192, 12, 64, torch.float32, False, 1e-4),
    ("int8_gqa", 192, 4, 64, torch.bfloat16, True, 2e-2),
    ("fp32_gqa_long", 4096, 4, 64, torch.float32, False, 1e-4),
    ("bf16_max_len", 16384, 12, 64, torch.bfloat16, False, 2e-2),
    ("fp32_dh16", 100, 6, 16, torch.float32, False, 1e-4),
    ("int8_dh32", 100, 4, 32, torch.float32, True, 1e-4),
    ("bf16_dh128", 300, 12, 128, torch.bfloat16, False, 2e-2),
]


def phase_parity(ops, dev, seed, mb):
    """Every case against the plain version; returns the largest error of
    each kernel over its main-path (bf16, 12 kv heads) case."""
    g = torch.Generator().manual_seed(seed)
    S, H = ENGINE["capacity"], FULL["n_heads"]
    BL = ENGINE["block_len"]
    rows, main_err = [], {}
    for name, T, KH, Dh, dt, quant, tol in PAGED_CASES:
        hi = mb * BL - (T - 1)
        valid = [0, 1, BL - 1, BL, BL + 1, 100, 192, hi][:S]
        a = paged_inputs(g, dev, S, T, H, KH, Dh, BL, mb, valid, dt, quant)
        got = run_paged(ops, a)
        want = run_paged(ops, a, plain=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rows.append(("paged_decode_attention", name, err, tol))
        check(err <= tol, f"paged kernel case {name}: max |err| {err} > "
              f"{tol}")
        check(torch.isfinite(got.float()).all().item(),
              f"paged kernel case {name}: non-finite output")
        if T == 1:
            # Idle slot 0 (valid 0): every row fully masked, exactly 0.
            check(bool((got[0] == 0).all()),
                  f"paged kernel case {name}: fully masked row is not "
                  "exactly 0 (exp(NEG_INF - NEG_INF) leaked)")
        if name == "bf16":
            main_err["paged_decode_attention"] = err
    for name, L, KH, Dh, dt, quant, tol in FUSED_CASES:
        valid = [0, 1, 31, 32, 33, L // 2 + 1, L - 1, L][:S]
        a = fused_inputs(g, dev, S, H, KH, L, Dh, valid, dt, quant)
        got = run_fused(ops, a)
        want = run_fused(ops, a, plain=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rows.append(("fused_decode_attention", name, err, tol))
        check(err <= tol, f"fused kernel case {name}: max |err| {err} > "
              f"{tol}")
        if name == "bf16":
            main_err["fused_decode_attention"] = err
    emit({"phase": "parity", "cases": [
        {"kernel": k, "case": n, "max_abs_err": e, "atol": t}
        for k, n, e, t in rows]})
    return main_err


# ------------------------------------------------------------------ timing
def _warm(fn, args_list):
    # On a side stream, as CUDA-graph capture wants its libraries warmed.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args_list[:3]:
            fn(a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def time_ms(fn, args_list, iters):
    """Device ms per call: ``iters`` calls cycling through ``args_list``
    (copies of the inputs, together larger than the L2 cache, so that each
    call finds its inputs cold) captured into one CUDA graph, and the
    graph's replay timed with CUDA events.  The host's cost of issuing the
    calls is not in the number."""
    _warm(fn, args_list)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, args_list, iters):
    """Ms per call issued eagerly, back to back: the device time or the
    host's cost of issuing the call, whichever is longer."""
    _warm(fn, args_list)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(a, min_bytes=128 << 20, cap=64):
    nbytes = sum(t.numel() * t.element_size() for t in a.values()
                 if isinstance(t, torch.Tensor))
    n = min(cap, max(2, math.ceil(min_bytes / max(nbytes, 1))))
    return [a] + [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in a.items()} for _ in range(n - 1)]


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_bound(a, T):
    """Bytes: the K/V rows (and int8 scales) of the positions the slots'
    last rows can attend, the table entries that reach them, q, valid_len
    and the output.  Operations: 4 * Dh per (query row, attended
    position)."""
    k, q = a["k"], a["q"]
    KH, _, BL, Dh = k.shape
    H = q.shape[-2]
    G = H // KH
    MB = a["tables"].shape[1]
    valid = a["valid"].tolist()
    pos = sum(min(max(v + T - 1, 0), MB * BL) for v in valid)
    row_bytes = Dh * k.element_size() + (4 if a["ks"] is not None else 0)
    nbytes = 2 * KH * pos * row_bytes
    nbytes += 4 * sum(math.ceil(min(max(v + T - 1, 0), MB * BL) / BL)
                      for v in valid)
    nbytes += 2 * q.numel() * q.element_size() + 4 * len(valid)
    ops = sum(4 * Dh * G * KH * min(max(v + t, 0), MB * BL)
              for v in valid for t in range(T))
    return bound(nbytes, ops, k.dtype)


def fused_bound(a):
    """As :func:`paged_bound`; a row with valid_len <= 0 reads its whole
    panel (the uniform mean)."""
    k, q = a["k"], a["q"]
    _, KH, L, Dh = k.shape
    G = q.shape[1] // KH
    pos = [L if v <= 0 else min(v, L) for v in a["valid"].tolist()]
    row_bytes = Dh * k.element_size() + (4 if a["ks"] is not None else 0)
    nbytes = 2 * KH * sum(pos) * row_bytes
    nbytes += 2 * q.numel() * q.element_size() + 4 * len(pos)
    ops = sum(4 * Dh * G * KH * p for p in pos)
    return bound(nbytes, ops, k.dtype)


def phase_timing(ops, dev, seed, mb):
    """The kernels at the main path's shapes and dtypes: the engine's
    decode step (8 slots, bf16 pools, 12 kv heads, Dh 64, block 16, valid
    lengths drawn like the serving phase's requests) and lm_generate's
    step (batch 8, cache 192 = prompt 128 + 64 new)."""
    g = torch.Generator().manual_seed(seed + 1)
    rng = np.random.RandomState(seed + 1)
    S, H, Dh = ENGINE["capacity"], FULL["n_heads"], 64
    BL = ENGINE["block_len"]
    out = {}

    valid = rng.randint(17, 16 + 128 + 64 + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, H, Dh, BL, mb, valid,
                     torch.bfloat16, False)
    nblk = math.ceil(max(valid) / BL)
    idx = a["tables"][:, :nblk].long()
    Lg = nblk * BL

    def gathered(pool):
        return pool[:, idx].permute(1, 0, 2, 3, 4) \
            .reshape(S, H, Lg, Dh).contiguous()

    lib = dict(q=a["q"].view(S, H, 1, Dh), k=gathered(a["k"]),
               v=gathered(a["v"]),
               mask=(torch.arange(Lg, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["paged_decode_attention"] = timing_row(
        a, lib, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=H, Dh=Dh, block_len=BL, max_blocks=mb,
             valid=valid))

    L = 128 + 64
    valid = rng.randint(129, L + 1, size=S).tolist()
    a = fused_inputs(g, dev, S, H, H, L, Dh, valid, torch.bfloat16, False)
    lib = dict(q=a["q"].view(S, H, 1, Dh), k=a["k"], v=a["v"],
               mask=(torch.arange(L, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["fused_decode_attention"] = timing_row(
        a, lib, lambda x: run_fused(ops, x),
        lambda x: run_fused(ops, x, plain=True), fused_bound(a),
        dict(B=S, H=H, KH=H, L=L, Dh=Dh, valid=valid))
    return out


def sdpa(x):
    return F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                          attn_mask=x["mask"])


def timing_row(a, lib, kernel, plain, bnd, shape):
    bound_ms, bound_by = bnd
    copies = copies_for(a)
    lib_copies = copies_for(lib)
    # Turns: plain, kernel, library, kernel, plain.
    p1 = time_ms(plain, copies, 10)
    k1 = time_ms(kernel, copies, 200)
    lib_ms = time_ms(sdpa, lib_copies, 200)
    k2 = time_ms(kernel, copies, 200)
    p2 = time_ms(plain, copies, 10)
    k_eager = eager_ms(kernel, copies, 200)
    # The yardstick must compute the same function.
    want = plain(a).float().reshape(-1)
    lib_err = (sdpa(lib).float().reshape(-1) - want).abs().max().item()
    check(lib_err <= 2e-2, f"library yardstick disagrees: {lib_err}")
    row = dict(kernel_ms=min(k1, k2), kernel_ms_runs=[k1, k2],
               kernel_eager_ms=k_eager, plain_ms=min(p1, p2),
               plain_ms_runs=[p1, p2], library_ms=lib_ms,
               library_max_abs_err=lib_err, bound_ms=bound_ms,
               bound_by=bound_by, shape=shape, copies=len(copies))
    emit({"phase": "timing", **row})
    return row


# ---------------------------------------------------------------- serving
def draw_requests(rng, n, vocab, plen=(16, 128), new=(16, 64)):
    from chainermn_tpu_torch.serving import Request

    plens = rng.randint(plen[0], plen[1] + 1, size=n)
    news = rng.randint(new[0], new[1] + 1, size=n)
    return [Request(id=i, prompt=rng.randint(1, vocab, size=int(p)).tolist(),
                    max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(plens, news))]


def engine_geometry(reqs):
    """The serving benchmark's sizing: tables cover the longest request
    (padded to a prefill chunk), the pool the 85th-percentile one per
    slot (tail requests may evict)."""
    from chainermn_tpu_torch.serving import blocks_for

    BL, chunk = ENGINE["block_len"], ENGINE["prefill_chunk"]
    lens = np.asarray([len(r.prompt) + r.max_new_tokens for r in reqs])
    longest = int(lens.max()) + chunk
    max_blocks = blocks_for(longest, BL)
    p85 = float(np.percentile(lens, 85))
    num_blocks = 1 + ENGINE["capacity"] * (1 + int(p85) // BL + 1)
    return num_blocks, max_blocks


def drive_serving(ops, dev, card, seed, label, n_requests, **model_kw):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler

    rng = np.random.RandomState(seed)
    reqs = draw_requests(rng, n_requests, FULL["vocab"])
    num_blocks, max_blocks = engine_geometry(reqs)
    model = TransformerLM(**{**FULL, **model_kw}, device=dev, seed=seed)
    eng = DecodeEngine(model, num_blocks=num_blocks,
                       max_blocks_per_slot=max_blocks, device=dev, **ENGINE)
    # Warm-up: one short request (allocator, cuBLAS and kernel library
    # first-use costs stay out of the measured run).
    Scheduler(eng).run(draw_requests(rng, 1, FULL["vocab"], new=(4, 4)))
    eng.drop_prefix_cache()

    reg = MetricsRegistry()
    sched = Scheduler(eng, registry=reg)
    torch.cuda.synchronize()
    ops.paged_decode_attention.launches = 0
    ops.fused_decode_attention.launches = 0
    t0 = time.perf_counter()
    comps = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": ops.paged_decode_attention.launches,
                "fused_decode_attention": ops.fused_decode_attention.launches}

    byid = {c.id: c for c in comps}
    check(sorted(byid) == [r.id for r in reqs],
          f"{label}: not every request completed")
    for r in reqs:
        c = byid[r.id]
        check(c.status == "ok" and len(c.tokens) == r.max_new_tokens,
              f"{label}: request {r.id} ended {c.status} with "
              f"{len(c.tokens)}/{r.max_new_tokens} tokens")
        check(all(0 <= t < FULL["vocab"] for t in c.tokens),
              f"{label}: request {r.id} emitted a token outside the vocab")
    check(eng.decode_compiles == 1,
          f"{label}: decode step saw {eng.decode_compiles} signatures")
    n_layers = FULL["n_layers"]
    check(launches["paged_decode_attention"]
          == sched.decode_iterations * n_layers,
          f"{label}: paged kernel launched "
          f"{launches['paged_decode_attention']} times, expected "
          f"{sched.decode_iterations} decode steps x {n_layers} layers")
    check(launches["fused_decode_attention"] == 0,
          f"{label}: the engine launched the fused kernel")
    eng.drop_prefix_cache()
    check(eng.free_blocks() == num_blocks - 1,
          f"{label}: {num_blocks - 1 - eng.free_blocks()} blocks leaked")
    snap = reg.snapshot()
    clean = snap["serve.decode_ms"]
    tokens = sum(len(c.tokens) for c in comps)
    row = dict(
        phase="serving", label=label, card=card, requests=len(reqs),
        tokens=tokens,
        wall_s=wall, tokens_per_s=tokens / wall,
        decode_steps=sched.decode_iterations,
        decode_step_ms_mean=sched.decode_ms_total
        / max(sched.decode_iterations, 1),
        clean_decode_step_ms_mean=(clean["sum"] / clean["count"]
                                   if clean["count"] else None),
        clean_decode_steps=clean["count"],
        evictions=sum(c.evictions for c in comps),
        decode_compiles=eng.decode_compiles,
        prefill_compiles=eng.prefill_compiles,
        num_blocks=num_blocks, max_blocks=max_blocks,
        launches=launches,
        kv_dtype=str(model.kv_dtype or model.dtype).replace("torch.", ""),
        n_kv_heads=model.kv_heads,
    )
    emit(row)
    return row


# -------------------------------------------------------------- generation
def phase_generation(ops, dev, card, seed):
    from chainermn_tpu_torch.models import TransformerLM, lm_generate

    rng = np.random.RandomState(seed + 2)
    B, P, N = 8, 128, 64
    model = TransformerLM(**FULL, device=dev, seed=seed)
    prompt = torch.from_numpy(
        rng.randint(1, FULL["vocab"], size=(B, P))).to(dev)
    lm_generate(model, prompt[:, :16], 2)  # warm-up
    with torch.no_grad():
        logits = model(prompt[:, :32])
    check(tuple(logits.shape) == (B, 32, FULL["vocab"])
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "full forward: logits not finite fp32 of the expected shape")
    torch.cuda.synchronize()
    ops.paged_decode_attention.launches = 0
    ops.fused_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = lm_generate(model, prompt, N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": ops.paged_decode_attention.launches,
                "fused_decode_attention": ops.fused_decode_attention.launches}
    check(tuple(out.shape) == (B, N), f"lm_generate shape {out.shape}")
    check(bool(((out >= 0) & (out < FULL["vocab"])).all()),
          "lm_generate emitted a token outside the vocab")
    want = (N - 1) * FULL["n_layers"]
    check(launches["fused_decode_attention"] == want,
          f"fused kernel launched {launches['fused_decode_attention']} "
          f"times, expected {N - 1} steps x {FULL['n_layers']} layers")
    check(launches["paged_decode_attention"] == 0,
          "lm_generate launched the paged kernel")
    row = dict(phase="generation", card=card, batch=B, prompt=P,
               new_tokens=N,
               wall_s=wall, tokens_per_s=B * N / wall,
               ms_per_token_step=wall * 1e3 / N, launches=launches)
    emit(row)
    return row


def phase_agreement(dev, seed):
    """Engine vs lm_generate, full width in fp32, ragged prompts.  Exact
    equality is not the claim: two attention paths sum in different
    orders, and a random-weight model has near-tied logits, so the check
    is the divergence structure (a logic bug diverges at the first tokens
    of every request)."""
    from chainermn_tpu_torch.models import TransformerLM, lm_generate
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler

    rng = np.random.RandomState(seed + 3)
    reqs = draw_requests(rng, 8, FULL["vocab"], new=(32, 32))
    num_blocks, max_blocks = engine_geometry(reqs)
    model = TransformerLM(**FULL, dtype=torch.float32, device=dev,
                          seed=seed)
    eng = DecodeEngine(model, num_blocks=num_blocks,
                       max_blocks_per_slot=max_blocks, device=dev, **ENGINE)
    got = {c.id: c.tokens for c in Scheduler(eng).run(reqs)}
    lens = [len(r.prompt) for r in reqs]
    prompt = np.zeros((len(reqs), max(lens)), np.int64)
    for i, r in enumerate(reqs):
        prompt[i, :lens[i]] = r.prompt
    want = lm_generate(model, torch.from_numpy(prompt).to(dev), 32,
                       prompt_lengths=torch.tensor(lens)).cpu().tolist()
    first_div = []
    for i, r in enumerate(reqs):
        d = next((j for j, (x, y) in enumerate(zip(got[r.id], want[i]))
                  if x != y), None)
        first_div.append(d)
    exact = sum(d is None for d in first_div)
    diverged = [d for d in first_div if d is not None]
    row = dict(phase="agreement", dtype="float32", requests=len(reqs),
               exact=exact, first_divergence=first_div)
    emit(row)
    check(exact * 2 >= len(reqs) and all(d >= 8 for d in diverged),
          f"engine vs lm_generate (fp32): {exact}/{len(reqs)} exact, first "
          f"divergences {first_div}; a near-tie flips late, a bug early")
    return row


# ------------------------------------------------------------ flash parity
#: Tolerances of the flash kernels against their plain versions, element by
#: element: |got - want| <= rtol * |want| + atol * rms(row of want), the row
#: being the head-dim vector (of o, dq, dk or dv) that holds the element.
#: rtol covers each side's rounding of its output to the input dtype (bf16:
#: two roundings, 2^-7); atol covers the error inside the sums, which scales
#: with the row, not with the element (fp32: sums in another order; bf16: P
#: and dS rounded to bf16 as tensor-core operands, unit roundoff 2^-8).
#: lse is fp32 on both sides: |got - want| <= rtol * |want| + atol.
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=3e-2),
             "lse": dict(rtol=1e-5, atol=1e-5)}


def excess(got, want, rtol, rows=True):
    """The least atol with which every element meets its tolerance
    (``FLASH_TOL``): max of (|got - want| - rtol |want|) over the RMS of
    the reference's row (``rows``) or over 1.  A row whose reference is
    all zero must match exactly."""
    got, want = got.float(), want.float()
    slack = (got - want).abs() - rtol * want.abs()
    if rows:
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        slack = torch.where(slack > 0, slack / rms, torch.zeros_like(slack))
    return max(slack.max().item(), 0.0)


def seg_runs(rows, T):
    """Segment ids ``(len(rows), T)`` from per-row (id, length) runs."""
    out = torch.zeros((len(rows), T), dtype=torch.int32)
    for r, runs in enumerate(rows):
        at = 0
        for sid, n in runs:
            out[r, at:at + n] = sid
            at += n
    return out


# name -> (B, T, S, H, KH, kwargs of flash_attention_lse)
FLASH_CASES = {
    "causal": (2, 256, 256, 4, 4, dict(causal=True)),
    "noncausal": (2, 192, 192, 4, 4, dict()),
    "window": (2, 256, 256, 4, 4, dict(causal=True, window=48)),
    "packed_fully_masked": (2, 200, 200, 4, 4, dict(
        segment_ids=seg_runs([[(1, 70), (9, 60), (2, 70)], [(3, 200)]], 200),
        kv_segment_ids=seg_runs([[(1, 100), (2, 100)],
                                 [(3, 150), (0, 50)]], 200))),
    "cross_kv_segments": (2, 96, 160, 4, 4, dict(
        segment_ids=seg_runs([[(1, 50), (2, 46)], [(1, 96)]], 96),
        kv_segment_ids=seg_runs([[(1, 80), (2, 70), (0, 10)],
                                 [(1, 150), (0, 10)]], 160))),
    "gqa_12_4": (1, 256, 256, 12, 4, dict(causal=True)),
    "mqa": (1, 192, 192, 4, 1, dict(causal=True, window=40)),
    "ragged_1000": (1, 1000, 1000, 2, 2, dict(causal=True)),
}


def flash_case(fa, g, dev, name, D, dtype):
    """Kernels through the autograd Function vs the plain versions: the
    ``excess`` of each output, and whether fully masked rows are exact."""
    B, T, S, H, KH, kw = FLASH_CASES[name]
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, D)))
    do = torch.randn((B, T, H, D), generator=g).to(dev, dtype)
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    kw = {key: (val.to(dev) if isinstance(val, torch.Tensor) else val)
          for key, val in kw.items()}
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_lse(*qkv, **kw)
    dq, dk, dv = torch.autograd.grad((o, lse), qkv, (do, dlse))
    seg_q, seg_kv = fa._validate(q, k, v, kw.get("causal", False),
                                 kw.get("segment_ids"),
                                 kw.get("kv_segment_ids"), kw.get("window"))
    args = (seg_q, seg_kv, kw.get("causal", False), kw.get("window"))
    o_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, *args)
    # The plain backward takes what K2 and K3 took: the kernel's lse, and
    # delta formed from the kernel's o as the autograd Function forms it.
    # (From the plain o, delta would differ by the two sides' bf16
    # roundings of o, which moves dq by up to ~0.2 of its row's RMS on
    # rows of few keys -- no fault of K2 or K3.)
    delta = ((do.float() * o.detach().float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    lse_k = lse.detach()
    dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_k,
                                                      delta, *args)
    dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_k, delta,
                                               *args)
    torch.cuda.synchronize()
    live = lse_r > -1e29
    rtol = FLASH_TOL[dtype]["rtol"]
    out = {"o": excess(o, o_r, rtol),
           "lse": excess(lse[live], lse_r[live], FLASH_TOL["lse"]["rtol"],
                         rows=False),
           "dq": excess(dq, dq_r, rtol), "dk": excess(dk, dk_r, rtol),
           "dv": excess(dv, dv_r, rtol)}
    dead = ~live
    out["dead_rows_exact"] = bool(
        (lse[dead] == -1e30).all() and (o.transpose(1, 2)[dead] == 0).all()
        and (dq.transpose(1, 2)[dead] == 0).all())
    return out


def flash_main_shape():
    """(B, T, H, D) of the training path's attention."""
    return (LM_BATCH, LM["max_len"], LM["n_heads"],
            LM["d_model"] // LM["n_heads"])


def flash_main_inputs(g, dev):
    """The training path's shapes: q/k/v as views of one fused qkv
    projection output (the layout the model hands the kernels), and
    dO."""
    B, T, H, D = flash_main_shape()
    qkv = torch.randn((B, T, 3, H, D), generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn((B, T, H, D), generator=g).to(dev, torch.bfloat16)
    return dict(q=q, k=k, v=v, do=do)


def flash_main_check(fa, g, dev):
    """Each kernel alone at the training path's shapes, the backward
    kernels fed the plain forward's lse and delta (the same on both sides,
    so each kernel is held alone; delta takes a random lse cotangent, as
    the autograd Function forms it)."""
    a = flash_main_inputs(g, dev)
    q, k, v, do = a["q"], a["k"], a["v"], a["do"]
    B, T, H, _ = q.shape
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    o_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, None, None, True)
    delta = ((do.float() * o_r.float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v, None, None, True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, None,
                                        None, True)
    dk_r, dv_r = fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_r,
                                                      delta, None, None,
                                                      True)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, None, None,
                                   True)
    dq_r = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_r, delta,
                                               None, None, True)
    torch.cuda.synchronize()
    rtol = FLASH_TOL[torch.bfloat16]["rtol"]
    out = {}
    for kname, pairs in (
            ("flash_attention_fwd", (("o", o, o_r), ("lse", lse, lse_r))),
            ("flash_attention_bwd_dkv", (("dk", dk, dk_r), ("dv", dv, dv_r))),
            ("flash_attention_bwd_dq", (("dq", dq, dq_r),))):
        for out_name, got, want in pairs:
            lse_out = out_name == "lse"
            out[out_name] = dict(
                kernel=kname,
                excess=excess(got, want, FLASH_TOL["lse"]["rtol"] if lse_out
                              else rtol, rows=not lse_out),
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ref_max_abs=want.float().abs().max().item(),
                ref_rms=want.float().pow(2).mean().sqrt().item())
    return out


def phase_flash_parity(fa, dev, seed):
    """Every case, then the training path's shapes; the line is printed
    before any check, so a failing run still shows every reading."""
    g = torch.Generator().manual_seed(seed + 4)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128):
            for name in FLASH_CASES:
                rows.append({"case": name, "D": D, "dtype": dtype,
                             **flash_case(fa, g, dev, name, D, dtype)})
    main = flash_main_check(fa, g, dev)
    emit({"phase": "flash_parity",
          "cases": [{**r, "dtype": str(r["dtype"]).replace("torch.", "")}
                    for r in rows],
          "tolerance": {"fp32": FLASH_TOL[torch.float32],
                        "bf16": FLASH_TOL[torch.bfloat16],
                        "lse": FLASH_TOL["lse"],
                        "measure": "excess = max over elements of (|err| - "
                                   "rtol |ref|) / rms(ref row); <= atol"},
          "main_shape": main})
    for r in rows:
        tol = FLASH_TOL[r["dtype"]]
        for key in ("o", "dq", "dk", "dv", "lse"):
            t = FLASH_TOL["lse"]["atol"] if key == "lse" else tol["atol"]
            check(r[key] <= t, f"flash case {r['case']} D{r['D']} "
                  f"{r['dtype']}: {key} excess {r[key]} > {t}")
        check(r["dead_rows_exact"], f"flash case {r['case']}: a fully "
              "masked row is not o = 0, lse = -1e30, dq = 0")
    worst = {}
    for out_name, m in main.items():
        t = FLASH_TOL["lse" if out_name == "lse" else torch.bfloat16]["atol"]
        check(m["excess"] <= t, f"{m['kernel']} at the training shapes: "
              f"{out_name} excess {m['excess']} > {t}")
        worst[m["kernel"]] = max(worst.get(m["kernel"], 0.0),
                                 m["max_abs_err"])
    return worst


# ------------------------------------------------------------ flash timing
def flash_bounds(B, T, H, D, itemsize=2):
    """Bytes and operations of each kernel at causal (B, T, H, D): each
    input read once and each output written once; 2 operations per
    multiply-add over the admitted (q, k) pairs -- two products in the
    forward, four in dK/dV, three in dQ (the score product recomputed)."""
    pairs = B * H * T * (T + 1) // 2
    x = B * T * H * D * itemsize  # one of q, k, v, dO, o, dq, dk, dv
    row = B * H * T * 4           # one fp32 per-row vector (lse, delta)
    return {
        "flash_attention_fwd": bound(4 * x + row, 4 * D * pairs,
                                     torch.bfloat16),
        "flash_attention_bwd_dkv": bound(6 * x + 2 * row, 8 * D * pairs,
                                         torch.bfloat16),
        "flash_attention_bwd_dq": bound(5 * x + 2 * row, 6 * D * pairs,
                                        torch.bfloat16),
    }


def sdpa_times(a):
    """SDPA forward, and forward + backward, on the kernels' inputs in
    SDPA's (B, H, T, D) layout.  Graph replay like the kernels; the
    backward is captured through autograd."""
    lib = {n: a[n].transpose(1, 2).contiguous().requires_grad_(True)
           for n in ("q", "k", "v")}
    lib["do"] = a["do"].transpose(1, 2).contiguous()
    copies = copies_for(lib)
    for c in copies[1:]:
        for n in ("q", "k", "v"):
            c[n] = c[n].detach().requires_grad_(True)

    def fwd(x):
        with torch.no_grad():
            return F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                                  is_causal=True)

    def fwd_bwd(x):
        out = F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                             is_causal=True)
        return torch.autograd.grad(out, (x["q"], x["k"], x["v"]), x["do"])

    return time_ms(fwd, copies, 50), time_ms(fwd_bwd, copies, 20), fwd(lib)


def phase_flash_timing(fa, dev, seed):
    B, T, H, D = flash_main_shape()
    g = torch.Generator().manual_seed(seed + 6)
    m = flash_main_inputs(g, dev)
    a = {n: m[n].contiguous() for n in ("q", "k", "v", "do")}
    o_r, lse = fa.flash_attention_fwd_reference(a["q"], a["k"], a["v"],
                                                None, None, True)
    a["lse"] = lse
    a["delta"] = (a["do"].float() * o_r.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    del o_r
    bounds = flash_bounds(B, T, H, D)
    f_ms, fb_ms, lib_o = sdpa_times(a)
    want = fa.flash_attention_fwd_reference(a["q"], a["k"], a["v"], None,
                                            None, True)[0]
    lib_err = (lib_o.transpose(1, 2).float() - want.float()).abs().max() \
        .item()
    check(lib_err <= 2e-2, f"SDPA yardstick disagrees: {lib_err}")
    del want, lib_o
    fwd_in = {n: a[n] for n in ("q", "k", "v")}
    calls = {
        "flash_attention_fwd": (
            fwd_in,
            lambda x: fa.flash_attention_fwd(x["q"], x["k"], x["v"], None,
                                             None, True),
            lambda x: fa.flash_attention_fwd_reference(
                x["q"], x["k"], x["v"], None, None, True)),
        "flash_attention_bwd_dkv": (
            a,
            lambda x: fa.flash_attention_bwd_dkv(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True),
            lambda x: fa.flash_attention_bwd_dkv_reference(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True)),
        "flash_attention_bwd_dq": (
            a,
            lambda x: fa.flash_attention_bwd_dq(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True),
            lambda x: fa.flash_attention_bwd_dq_reference(
                x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                None, None, True)),
    }
    out = {}
    for name, (inp, kernel, plain) in calls.items():
        copies = copies_for(inp)
        # Turns: plain, kernel, kernel, plain.
        p1 = time_ms(plain, copies, 3)
        k1 = time_ms(kernel, copies, 20)
        k2 = time_ms(kernel, copies, 20)
        p2 = time_ms(plain, copies, 3)
        k_eager = eager_ms(kernel, copies, 20)
        bound_ms, bound_by = bounds[name]
        lib_ms = f_ms if name == "flash_attention_fwd" else fb_ms - f_ms
        row = dict(kernel=name, kernel_ms=min(k1, k2),
                   kernel_ms_runs=[k1, k2], kernel_eager_ms=k_eager,
                   plain_ms=min(p1, p2), plain_ms_runs=[p1, p2],
                   library_ms=lib_ms,
                   library=("sdpa forward" if name == "flash_attention_fwd"
                            else "sdpa backward (fwd+bwd - fwd), covers "
                                 "dK/dV and dQ together"),
                   library_max_abs_err=lib_err,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_fraction=bound_ms / min(k1, k2),
                   shape=dict(B=B, T=T, H=H, KH=H, D=D, dtype="bfloat16",
                              causal=True),
                   copies=len(copies))
        emit({"phase": "flash_timing", **row})
        out[name] = row
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- training
def flash_launches(fa):
    return {k: getattr(fa, k).launches for k in FLASH}


def reset_flash(fa):
    for k in FLASH:
        getattr(fa, k).launches = 0


def trace_step(step, state, batch):
    """One more training step under ``torch.profiler``: device time by
    kernel (self time, summed over launches), grouped into the flash
    kernels, matrix products and the rest, and the device's busy share of
    the step's wall time (one stream, so kernel times do not overlap).
    The profiler's own host cost stretches the wall time a little."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        # Device-side events only: a host op's entry repeats the time of
        # the kernels it launched.
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)

    def group(name):
        n = name.lower()
        if "flash_" in n:
            return "flash_kernels"
        if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
            return "matrix_products"
        return "other"

    groups = {}
    for name, ms, _ in kernels:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                groups_ms=groups,
                top=[dict(name=n[:90], ms=ms, launches=c)
                     for n, ms, c in kernels[:15]])


def train_arm(fa, dev, card, seed, impl, comm, batch, warmup=2, timed=5):
    import gc

    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(**LM, attention=impl, remat=True, device=dev,
                          seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = create_multi_node_optimizer(adamw(3e-4), comm)
    state = opt.init(model)
    step = opt.make_train_step(lm_loss(model), has_aux=True)
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    reset_flash(fa)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # syncs: the step is done
        times.append(time.perf_counter() - t0)
    launches = flash_launches(fa)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "training_trace", "attention": impl, "card": card,
          **trace_step(step, state, batch)})
    check(all(math.isfinite(x) for x in losses),
          f"training {impl}: non-finite loss {losses}")
    tokens = batch[0].numel()
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = dict(phase="training", attention=impl, card=card,
               params=n_params, batch=list(batch[0].shape),
               warmup_steps=warmup, timed_steps=timed, losses=losses,
               step_ms_median=step_ms,
               step_ms_runs=[t * 1e3 for t in times],
               tokens_per_s=tokens / (step_ms / 1e3),
               peak_memory_gb=peak / 1e9, launches=launches,
               launches_per_step={k: v / timed for k, v in launches.items()})
    emit(row)
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_training(fa, dev, card, seed):
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(
        0, LM["vocab"], size=(LM_BATCH, LM["max_len"]))).to(dev)
    batch = (toks, toks)  # benchmarks/lm.py: targets = tokens
    flash = train_arm(fa, dev, card, seed, "flash", comm, batch)
    L = LM["n_layers"]  # remat: the forward runs twice per layer
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L,
            "flash_attention_bwd_dq": L}
    for k, n in want.items():
        check(flash["launches_per_step"][k] == n,
              f"training: {k} launched {flash['launches_per_step'][k]} "
              f"times per step, expected {n} ({L} layers, remat)")
    check(flash["losses"][-1] < flash["losses"][0],
          f"training: flash loss did not fall: {flash['losses']}")
    eager = train_arm(fa, dev, card, seed, "xla", comm, batch)
    check(all(v == 0 for v in eager["launches"].values()),
          "training: the eager arm launched a flash kernel")
    ratio = flash["step_ms_median"] / eager["step_ms_median"]
    emit({"phase": "training_summary", "card": card,
          "flash_step_ms": flash["step_ms_median"],
          "eager_step_ms": eager["step_ms_median"],
          "flash_over_eager_step_ratio": ratio,
          "flash_tokens_per_s": flash["tokens_per_s"],
          "eager_tokens_per_s": eager["tokens_per_s"],
          "flash_peak_memory_gb": flash["peak_memory_gb"],
          "eager_peak_memory_gb": eager["peak_memory_gb"]})

    # The example entry point itself, at its own small defaults.
    from chainermn_tpu_torch.examples import train_lm

    t0 = time.perf_counter()
    loss = train_lm.main(["--steps", "3"])
    check(math.isfinite(loss), f"train_lm example: loss {loss}")
    emit({"phase": "train_lm_example", "steps": 3, "final_loss": loss,
          "wall_s": time.perf_counter() - t0})
    return flash


def phase_training_agreement(fa, dev, seed):
    """The flash kernels (fp32 instantiations) against the plain path,
    both on the card, through three optimizer steps from the same
    weights."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    cfg = dict(vocab=1024, n_layers=2, d_model=128, n_heads=4, d_ff=512,
               max_len=256, pos_enc="rope")
    rng = np.random.RandomState(seed + 5)
    batches = []
    for _ in range(3):
        tok = rng.randint(0, 1024, size=(4, 256))
        tgt = rng.randint(0, 1024, size=(4, 256))
        seg = np.ones((4, 256), np.int32)
        seg[:, 100:] = 2  # two packed documents per row
        batches.append(tuple(torch.from_numpy(x).to(dev)
                             for x in (tok, tgt, seg)))
    comm = create_communicator("xla", device=dev)
    runs = {}
    for impl in ("flash", "xla"):
        model = TransformerLM(**cfg, dtype=torch.float32, attention=impl,
                              device=dev, seed=seed)
        opt = create_multi_node_optimizer(
            adamw(1e-3, eps=1e-6, weight_decay=0.01), comm)
        state = opt.init(model)
        step = opt.make_train_step(lm_loss(model), has_aux=True)
        before = flash_launches(fa)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        used = {k: flash_launches(fa)[k] - before[k] for k in FLASH}
        runs[impl] = (losses, {n: p.detach().clone()
                               for n, p in model.named_parameters()}, used)
    check(all(v == 3 * cfg["n_layers"] for v in runs["flash"][2].values()),
          f"training_agreement: flash arm launches {runs['flash'][2]}")
    check(all(v == 0 for v in runs["xla"][2].values()),
          "training_agreement: the plain arm launched a kernel")
    lf, lx = runs["flash"][0], runs["xla"][0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
    param_err = max((runs["flash"][1][n] - runs["xla"][1][n]).abs().max()
                    .item() for n in runs["xla"][1])
    emit({"phase": "training_agreement", "dtype": "float32",
          "losses_flash": lf, "losses_plain": lx,
          "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err,
          "tolerance": {"loss_rtol": 1e-5, "param_atol": 1e-4}})
    check(loss_rel <= 1e-5 and param_err <= 1e-4,
          f"training_agreement: losses {lf} vs {lx}, parameters differ "
          f"by {param_err}")


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2

    import importlib

    from chainermn_tpu_torch.ops import _kernels
    from chainermn_tpu_torch.ops import decode_attention as ops

    # The module (``chainermn_tpu_torch.ops`` re-exports a function of the
    # same name).
    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # Full fp32 products wherever fp32 is asked for (the agreement phase).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _kernels.CSRC_DIR.glob("*.cu"))
    _kernels.build(sources)
    for n in sources:
        print(f"--- nvcc csrc/{n}.cu\n{_kernels.build_logs.get(n, '')}",
              file=sys.stderr)
    emit({"phase": "build", "sources": sources,
          "seconds": time.perf_counter() - t0})

    # The block-table width the serving phase's engine will have.
    _, mb = engine_geometry(draw_requests(
        np.random.RandomState(args.seed), 16, FULL["vocab"]))
    errs = phase_parity(ops, dev, args.seed, mb)
    errs.update(phase_flash_parity(fa, dev, args.seed))
    timing = phase_timing(ops, dev, args.seed, mb)
    timing.update(phase_flash_timing(fa, dev, args.seed))

    serve = drive_serving(ops, dev, smi, args.seed, "bf16_mha", 16)
    drive_serving(ops, dev, smi, args.seed + 10, "int8_gqa", 6,
                  n_kv_heads=4, kv_dtype=torch.int8)
    gen = phase_generation(ops, dev, smi, args.seed)
    phase_agreement(dev, args.seed)
    train = phase_training(fa, dev, smi, args.seed)
    phase_training_agreement(fa, dev, args.seed)

    launches = {"paged_decode_attention":
                serve["launches"]["paged_decode_attention"],
                "fused_decode_attention":
                gen["launches"]["fused_decode_attention"],
                **train["launches"]}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": KERNELS[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k]["kernel_ms"],
         "plain_ms": timing[k]["plain_ms"],
         "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k]["library_ms"]}
        for k in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
