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

The launch counters are set to 0 just before each drive of the main path
(phases 5 and 6) and read just after it.  Then come the ``kernels`` line,
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

#: each kernel of the slice, and the TPU kernel it replaces.
KERNELS = {
    "paged_decode_attention": "chainermn_tpu/ops/decode_attention.py:196",
    "fused_decode_attention": "chainermn_tpu/ops/decode_attention.py:101",
}
SOURCE = "chainermn_tpu_torch/csrc/decode_attention.cu"


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


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2

    from chainermn_tpu_torch.ops import _kernels
    from chainermn_tpu_torch.ops import decode_attention as ops

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
    timing = phase_timing(ops, dev, args.seed, mb)

    serve = drive_serving(ops, dev, smi, args.seed, "bf16_mha", 16)
    drive_serving(ops, dev, smi, args.seed + 10, "int8_gqa", 6,
                  n_kv_heads=4, kv_dtype=torch.int8)
    gen = phase_generation(ops, dev, smi, args.seed)
    phase_agreement(dev, args.seed)

    launches = {"paged_decode_attention":
                serve["launches"]["paged_decode_attention"],
                "fused_decode_attention":
                gen["launches"]["fused_decode_attention"]}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
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
