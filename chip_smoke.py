#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name, PyTorch and CUDA versions, and the card's
   name and power limit as ``nvidia-smi`` reports them.
2. ``build``: ``nvcc`` compiles every source under
   ``chainermn_tpu_torch/csrc/`` for sm_90a, all at once (the ptxas
   report of registers, shared memory and spills goes to stderr); then
   ``flash_sass`` and ``conv_sass``: the count of ``HGMMA`` (wgmma),
   ``HMMA`` (mma.sync) and ``UTMALDG`` (TMA loads) in each bf16 flash
   function and each bf16 fused-conv function of ``cuobjdump -sass``, and
   the functions whose wgmmas ptxas serialized (from the library's build
   log), printed before the check that every one of them has wgmma and
   TMA, no mma.sync and no serialized wgmma; and ``decode_sass``: the
   count of ``UBLKCP`` (1-D bulk copies) and ``LDGSTS`` (``cp.async``) in
   each decode-attention function with ptxas's registers, stack frame and
   spill bytes for it, printed before the check that every bf16-cache
   function (K4 and K5) copies asynchronously and spills nothing.
3. ``parity``: each hand-written kernel against its plain PyTorch version
   on the same inputs at the serving model's shapes: fp32 (atol 1e-4:
   sums in another order), bf16 (atol 2e-2: one bf16 rounding of O(1)
   outputs) and int8 pools with grouped-query heads (atol 2e-2), with
   speculative verify chunks (T = 4), idle slots (valid_len = 0) and every
   supported head dim; each case twice, the second time with lengths that
   end exactly on, just before and just past the launch's split
   boundaries, straddle one with a verify chunk's rows, and leave whole
   splits empty.
4. ``timing``: device times (CUDA-graph replay, CUDA events) of each
   kernel, its plain version and one PyTorch library call computing the
   same function, at the main path's shapes with the L2 cache cold,
   beside the least time the card could take (the larger of bytes over
   3.35 TB/s and operations over the peak rate of the input type), and
   the kernel wrapper's eager per-call time; then one long-context row
   per decode kernel (``timing`` lines with ``"row": "long"``): the paged
   kernel at 8 slots of ~4096 positions (256 blocks of 16), the fused one
   at batch 8, L = 16384, both bf16 with 12 kv heads and Dh 64.
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
12. ``conv_parity``: the fused 1x1-conv kernel (K6) against its plain
   version at every (N, Cin, Cout) a ResNet-50 training step gives it
   (batch 256, 224 px) and at ragged shapes, ReLU on and off, bf16 and
   fp32, each output element held to |err| <= rtol |ref| + atol rms(its
   reference row) (``K6_TOL``).  The line shows each reading before any
   check.
13. ``conv_timing``: as phase 4, for K6 at each of those shapes; the
   library yardstick is ``torch.matmul(x, w)`` alone (cuBLAS: the product
   without the epilogue, so it bounds any library route from below); then
   the sums over the 36 launches of one training step.
14. ``resnet``: ResNet-50 data-parallel training at full width (the
   bench's configuration, ``bench.py:1077``, ``:1154-1169``, ``:1226``:
   batch 256 per card, 224 px, 1000 classes, bf16 compute over fp32
   parameters, SGD 0.1 with momentum 0.9, a bf16 gradient wire) through
   ``create_communicator`` -> ``create_multi_node_optimizer(sgd)`` ->
   ``make_train_step(resnet_loss(model), stateful=True)`` on one seeded
   batch, three arms of 2 warm-up and 5 timed steps: ``sync/none`` (the
   headline: sync-BN, cuDNN convolutions, no K6; its loss must fall over
   its first two steps, and it runs on untimed to the bench's 25 steps,
   whose losses must stay finite), ``frozen/pallas`` (K6, 36 launches per
   step) and
   ``frozen/xla`` (its plain twin).  cuDNN
   autotuning (``cudnn.benchmark``) is on; the warm-up steps cover it.
   The frozen arms start their residual branches' last affine scales at
   ``FROZEN_BRANCH_SCALE`` (stored-statistics BN does not normalize, so
   from random weights at unit scales the residual stream grows block by
   block and the loss overflows).  One more step of each arm runs under
   ``torch.profiler`` (``resnet_trace``).
15. ``resnet_agreement``: ``ResNetTiny`` in fp32 (width 16, 32 px, 10
   classes, ``bn="frozen"``) trained 3 SGD steps with ``conv1="pallas"``
   (K6's fp32 instantiation) and 3 with ``conv1="xla"`` from the same
   weights, TF32 off and cuDNN deterministic: losses within rtol 1e-5,
   parameters within atol 1e-4.
16. ``train_imagenet_example``: the ``train_imagenet`` example at its
   defaults for 3 steps.

The launch counters are set to 0 just before each drive of the main path
(phases 5, 6 and the timed steps of 10 and 14) and read just after it.
Then come the ``kernels`` line,
the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  A
failed check raises and exits non-zero before the last line; without a
CUDA device the script exits 2 at once.

    python3 chip_smoke.py --compare-with DIR

runs none of the above: it times the decode kernels (phase 4 with its
long rows) and the bf16 serving drive (phase 5's first), the flash
kernels (phase 9), the LM flash-arm step (phase 10's first arm), the fused
1x1-conv kernel (phase 13) and the ``frozen/pallas`` ResNet step (an arm
of phase 14) of the checkout DIR and of this one in turns, DIR, this,
this, DIR, each in a process of its own, and prints every line with its
tree; ``--compare-phases decode,conv`` (say) times only those.  The
decode phase runs this script's timing code on each tree's own kernels.
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
    "matmul_affine_fwd": "chainermn_tpu/ops/conv_fused.py:42",
}
SOURCES = {k: "chainermn_tpu_torch/csrc/flash_attention.cu"
           for k in list(KERNELS)[:3]}
SOURCES.update({k: "chainermn_tpu_torch/csrc/decode_attention.cu"
                for k in list(KERNELS)[3:5]})
SOURCES["matmul_affine_fwd"] = "chainermn_tpu_torch/csrc/conv_fused.cu"
FLASH = list(KERNELS)[:3]

#: the bench's ResNet-50 configuration (bench.py:1002, :1068, :1154).
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 256, 224, 1000
#: the bench's step count on its fixed batch (5 warm-up + 20 timed).
RESNET_BENCH_STEPS = 25
#: the frozen arms' starting scale of each residual branch's last affine
#: (``ResNet.scale_residual_branches``).
FROZEN_BRANCH_SCALE = 0.1
#: K6 against its plain version, element by element: |err| <= rtol |ref| +
#: atol rms(ref row over Cout).  rtol: each side rounds its fp32 result to
#: the output dtype once (bf16: one ulp is at most 2^-8 of the value);
#: atol: the fp32 sums taken in another order.
#: The sound kernel read at most 7.9e-6 (fp32) and 4.7e-6 (bf16) over these
#: cases on an H100 80GB HBM3 at 700 W; atol sits 12x and 21x above.
K6_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4)}
K6_RAGGED = [(1000, 24, 40), (37, 8, 16), (77, 20, 13)]


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


def split_lengths(per, n_max, T=1):
    """Eight valid lengths against a launch whose splits hold ``per``
    positions of ``n_max``: an idle row; bounds that end exactly on the
    first split boundary, just before it and just past it (for a verify
    chunk of T positions the last row's bound, valid + T - 1); a verify
    chunk's rows straddling the second boundary; a row that leaves every
    split but the first empty; one that leaves the last split empty; and
    a full row."""
    out = [0, per - (T - 1), per - T, per - (T - 1) + 1,
           2 * per - T // 2, max(per // 2, 1), n_max - per - (T - 1),
           n_max - (T - 1)]
    return [min(max(v, 0), n_max - (T - 1)) for v in out]


def phase_parity(ops, dev, seed, mb):
    """Every case against the plain version, at the original lengths and
    at the launch's split boundaries (:func:`split_lengths`); returns the
    largest error of each kernel over its main-path (bf16, 12 kv heads)
    case."""
    g = torch.Generator().manual_seed(seed)
    S, H = ENGINE["capacity"], FULL["n_heads"]
    BL = ENGINE["block_len"]
    sms = ops._sm_count(dev)
    rows, main_err = [], {}
    for name, T, KH, Dh, dt, quant, tol in PAGED_CASES:
        hi = mb * BL - (T - 1)
        elt = 1 if quant else torch.tensor([], dtype=dt).element_size()
        splits, per, _ = ops._plan(mb * BL, S, KH, T * (H // KH), Dh * elt,
                                   sms, block_len=BL)
        for lens, valid in (
                ("", [0, 1, BL - 1, BL, BL + 1, 100, 192, hi][:S]),
                ("_splits", split_lengths(per, mb * BL, T))):
            a = paged_inputs(g, dev, S, T, H, KH, Dh, BL, mb, valid, dt,
                             quant)
            got = run_paged(ops, a)
            want = run_paged(ops, a, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rows.append(("paged_decode_attention", name + lens, err, tol,
                         valid, splits))
            check(err <= tol, f"paged kernel case {name}{lens} (valid "
                  f"{valid}): max |err| {err} > {tol}")
            check(torch.isfinite(got.float()).all().item(),
                  f"paged kernel case {name}{lens}: non-finite output")
            if T == 1:
                # Idle slot 0 (valid 0): every row fully masked, exactly 0.
                check(bool((got[0] == 0).all()),
                      f"paged kernel case {name}{lens}: fully masked row "
                      "is not exactly 0 (exp(NEG_INF - NEG_INF) leaked)")
            if name == "bf16":
                main_err["paged_decode_attention"] = max(
                    err, main_err.get("paged_decode_attention", 0.0))
    for name, L, KH, Dh, dt, quant, tol in FUSED_CASES:
        elt = 1 if quant else torch.tensor([], dtype=dt).element_size()
        splits, per, _ = ops._plan(L, S, KH, H // KH, Dh * elt, sms)
        for lens, valid in (("", [0, 1, 31, 32, 33, L // 2 + 1, L - 1,
                                  L][:S]),
                            ("_splits", split_lengths(per, L))):
            a = fused_inputs(g, dev, S, H, KH, L, Dh, valid, dt, quant)
            got = run_fused(ops, a)
            want = run_fused(ops, a, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rows.append(("fused_decode_attention", name + lens, err, tol,
                         valid, splits))
            check(err <= tol, f"fused kernel case {name}{lens} (valid "
                  f"{valid}): max |err| {err} > {tol}")
            if name == "bf16":
                main_err["fused_decode_attention"] = max(
                    err, main_err.get("fused_decode_attention", 0.0))
    emit({"phase": "parity", "cases": [
        {"kernel": k, "case": n, "max_abs_err": e, "atol": t,
         "valid": v, "splits": sp}
        for k, n, e, t, v, sp in rows]})
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
        "paged_decode_attention", a, lib, lambda x: run_paged(ops, x),
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
        "fused_decode_attention", a, lib, lambda x: run_fused(ops, x),
        lambda x: run_fused(ops, x, plain=True), fused_bound(a),
        dict(B=S, H=H, KH=H, L=L, Dh=Dh, valid=valid))

    # The int8-GQA serving arm's step (4 kv heads, int8 pools with fp32
    # scales, its engine's table width).  No one PyTorch call takes int8
    # K/V with scales: the row has no library time.
    _, mb8 = engine_geometry(draw_requests(np.random.RandomState(seed + 10),
                                           6, FULL["vocab"]))
    valid = rng.randint(17, 16 + 128 + 64 + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, 4, Dh, BL, mb8, valid,
                     torch.bfloat16, True)
    out["paged_decode_attention_int8_gqa"] = timing_row(
        "paged_decode_attention", a, None, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=4, Dh=Dh, block_len=BL, max_blocks=mb8,
             valid=valid, kv_dtype="int8"), row="int8_gqa")
    return out


#: the long-context rows: the paged kernel at 8 slots of ~4096 positions
#: (max_blocks 256 at block 16), the fused one at lm_generate's limit
#: (``MAX_FUSED_LEN``); bf16, 12 kv heads, Dh 64.
LONG_PAGED_BLOCKS, LONG_FUSED_LEN = 256, 16384


def phase_long_timing(ops, dev, seed):
    """One long-context ``timing`` row per decode kernel, valid lengths
    drawn near the row's capacity."""
    g = torch.Generator().manual_seed(seed + 9)
    rng = np.random.RandomState(seed + 9)
    S, H, Dh = ENGINE["capacity"], FULL["n_heads"], 64
    BL, mb = ENGINE["block_len"], LONG_PAGED_BLOCKS
    out = {}
    valid = rng.randint(mb * BL - 192, mb * BL + 1, size=S).tolist()
    a = paged_inputs(g, dev, S, 1, H, H, Dh, BL, mb, valid,
                     torch.bfloat16, False, spare=0)
    idx = a["tables"].long()
    Lg = mb * BL
    lib = dict(q=a["q"].view(S, H, 1, Dh),
               k=a["k"][:, idx].permute(1, 0, 2, 3, 4)
               .reshape(S, H, Lg, Dh).contiguous(),
               v=a["v"][:, idx].permute(1, 0, 2, 3, 4)
               .reshape(S, H, Lg, Dh).contiguous(),
               mask=(torch.arange(Lg, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["paged_decode_attention"] = timing_row(
        "paged_decode_attention", a, lib, lambda x: run_paged(ops, x),
        lambda x: run_paged(ops, x, plain=True), paged_bound(a, 1),
        dict(S=S, H=H, KH=H, Dh=Dh, block_len=BL, max_blocks=mb,
             valid=valid), row="long", plain_iters=2, kernel_iters=50)
    del a, lib
    L = LONG_FUSED_LEN
    valid = rng.randint(L - 256, L + 1, size=S).tolist()
    a = fused_inputs(g, dev, S, H, H, L, Dh, valid, torch.bfloat16, False)
    lib = dict(q=a["q"].view(S, H, 1, Dh), k=a["k"], v=a["v"],
               mask=(torch.arange(L, device=dev)[None, :]
                     < a["valid"][:, None])[:, None, None, :])
    out["fused_decode_attention"] = timing_row(
        "fused_decode_attention", a, lib, lambda x: run_fused(ops, x),
        lambda x: run_fused(ops, x, plain=True), fused_bound(a),
        dict(B=S, H=H, KH=H, L=L, Dh=Dh, valid=valid), row="long",
        plain_iters=2, kernel_iters=50)
    del a, lib
    torch.cuda.empty_cache()
    return out


def sdpa(x):
    return F.scaled_dot_product_attention(x["q"], x["k"], x["v"],
                                          attn_mask=x["mask"])


def timing_row(name, a, lib, kernel, plain, bnd, shape, row="main",
               plain_iters=10, kernel_iters=200):
    bound_ms, bound_by = bnd
    copies = copies_for(a)
    # Turns: plain, kernel, library, kernel, plain.
    p1 = time_ms(plain, copies, plain_iters)
    k1 = time_ms(kernel, copies, kernel_iters)
    lib_ms = lib_err = None
    if lib is not None:
        lib_ms = time_ms(sdpa, copies_for(lib), kernel_iters)
    k2 = time_ms(kernel, copies, kernel_iters)
    p2 = time_ms(plain, copies, plain_iters)
    k_eager = eager_ms(kernel, copies, kernel_iters)
    if lib is not None:
        # The yardstick must compute the same function.
        want = plain(a).float().reshape(-1)
        lib_err = (sdpa(lib).float().reshape(-1) - want).abs().max().item()
        check(lib_err <= 2e-2, f"library yardstick disagrees: {lib_err}")
    row = dict(kernel=name, row=row, kernel_ms=min(k1, k2),
               kernel_ms_runs=[k1, k2],
               kernel_eager_ms=k_eager, plain_ms=min(p1, p2),
               plain_ms_runs=[p1, p2], library_ms=lib_ms,
               library_max_abs_err=lib_err, bound_ms=bound_ms,
               bound_by=bound_by, bound_fraction=bound_ms / min(k1, k2),
               shape=shape, copies=len(copies))
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
    # The wgmma kernels' tile edges (q tiles of 128 and 64, kv tiles of
    # 128): lengths just under, at and over a tile, S != T both ways, a
    # window and segment boundaries inside a tile, GQA and MQA.
    "tile_127": (2, 127, 127, 4, 4, dict(causal=True)),
    "tile_128": (1, 128, 128, 4, 2, dict(causal=True)),
    "tile_129": (2, 129, 129, 4, 4, dict()),
    "cross_s_over_t": (2, 129, 300, 4, 4, dict()),
    "cross_t_over_s": (2, 300, 127, 4, 4, dict()),
    "window_straddles_tile": (1, 384, 384, 4, 4, dict(causal=True,
                                                       window=100)),
    "window_two_sided": (1, 320, 320, 2, 2, dict(window=70)),
    "gqa_12_4_ragged": (1, 200, 200, 12, 4, dict(causal=True)),
    "mqa_noncausal": (1, 129, 129, 6, 1, dict()),
    "packed_in_tile": (2, 300, 300, 4, 4, dict(
        causal=True, segment_ids=seg_runs(
            [[(1, 100), (2, 90), (3, 110)], [(5, 37), (6, 263)]], 300))),
    # T a multiple of no q tile (128) and S of no kv tile (128, or 64 in
    # dQ at D = 128), with segments on both sides and GQA.
    "ragged_both_segments": (2, 200, 333, 4, 2, dict(
        segment_ids=seg_runs([[(1, 90), (2, 110)], [(4, 200)]], 200),
        kv_segment_ids=seg_runs([[(1, 150), (2, 183)],
                                 [(4, 300), (0, 33)]], 333))),
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


def lm_group(name):
    """Kernel groups of the LM training trace."""
    n = name.lower()
    if "flash_" in n:
        return "flash_kernels"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "matrix_products"
    return "other"


def trace_step(step, state, batch, group=lm_group, top=15):
    """One more training step under ``torch.profiler``: its loss, device
    time by kernel (self time, summed over launches), summed by ``group``
    of the kernel's name, and the device's busy share of the step's wall
    time (one stream, so kernel times do not overlap).  The profiler's own
    host cost stretches the wall time a little."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
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
    groups = {}
    for name, ms, _ in kernels:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    return dict(loss=loss, wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms if wall_ms else None,
                groups_ms=groups, kernel_launches=sum(k[2] for k in kernels),
                top=[dict(name=n[:100], ms=ms, launches=c, group=group(n))
                     for n, ms, c in kernels[:top]])


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


# -------------------------------------------------------------- conv K6
def k6_launches(batch=RESNET_BATCH, size=RESNET_SIZE,
                stages=(3, 4, 6, 3), width=64):
    """(N, Cin, Cout) of every K6 launch of one ResNet-50 training step
    with ``conv1="pallas"``, in forward order: each bottleneck block's fc1
    (before its strided 3x3), fc3 and, where the shape changes, proj_f
    (after its stride-2 subsample).  The stem and the max-pool take 224 px
    to 56."""
    h = -(-(-(-size // 2)) // 2)
    cin, out = width, []
    for i, n in enumerate(stages):
        for j in range(n):
            feats, s = width * 2 ** i, 2 if i > 0 and j == 0 else 1
            out.append((batch * h * h, cin, feats))
            h = -(-h // s)
            out.append((batch * h * h, feats, 4 * feats))
            if s != 1 or cin != 4 * feats:
                out.append((batch * h * h, cin, 4 * feats))
            cin = 4 * feats
    return out


def k6_shapes():
    """The distinct main-path shapes, each with its launches per step."""
    counts = {}
    for shp in k6_launches():
        counts[shp] = counts.get(shp, 0) + 1
    return counts


def k6_inputs(dev, N, K, C, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, C), generator=g, device=dev) / K ** 0.5).to(dtype)
    s = torch.rand((C,), generator=g, device=dev) + 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    return dict(x=x, w=w, s=s, b=b)


def phase_conv_parity(cf, dev, seed):
    """K6 at every main-path shape and the ragged ones, ReLU on and off,
    bf16 and fp32, against the plain version on the same inputs; returns
    the largest |err| over the main-path bf16 cases."""
    rows = []
    shapes = list(k6_shapes()) + K6_RAGGED
    for i, (N, K, C) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            a = k6_inputs(dev, N, K, C, dtype, seed + i)
            for relu in (True, False):
                got = cf.matmul_affine_fwd(a["x"], a["w"], a["s"], a["b"],
                                           relu)
                want = cf.matmul_affine_reference(a["x"], a["w"], a["s"],
                                                  a["b"], relu)
                torch.cuda.synchronize()
                rows.append(dict(
                    N=N, K=K, C=C, relu=relu,
                    dtype=str(dtype).replace("torch.", ""),
                    main_path=(N, K, C) not in K6_RAGGED,
                    excess=excess(got, want, K6_TOL[dtype]["rtol"]),
                    max_abs_err=(got.float() - want.float()).abs().max()
                    .item(),
                    ref_rms=want.float().pow(2).mean().sqrt().item(),
                    finite=bool(torch.isfinite(got.float()).all()),
                    relu_nonneg=(not relu) or float(got.float().min()) >= 0))
                del got, want
            del a
    torch.cuda.empty_cache()
    emit({"phase": "conv_parity", "cases": rows,
          "tolerance": {"fp32": K6_TOL[torch.float32],
                        "bf16": K6_TOL[torch.bfloat16],
                        "measure": "excess = max over elements of (|err| - "
                                   "rtol |ref|) / rms(ref row); <= atol"}})
    for r in rows:
        tol = K6_TOL[getattr(torch, r["dtype"])]["atol"]
        check(r["excess"] <= tol and r["finite"] and r["relu_nonneg"],
              f"K6 {r['dtype']} relu={r['relu']} at ({r['N']}, {r['K']}, "
              f"{r['C']}): excess {r['excess']} > {tol}, or not finite, or "
              "a negative ReLU output")
    return max(r["max_abs_err"] for r in rows
               if r["main_path"] and r["dtype"] == "bfloat16")


def phase_conv_timing(cf, dev, seed):
    """Device ms per launch at each main-path shape (bf16): K6, the plain
    version and ``torch.matmul(x, w)``, beside the bound; then the sums
    over one training step's 36 launches."""
    rows = []
    for i, ((N, K, C), n) in enumerate(k6_shapes().items()):
        a = k6_inputs(dev, N, K, C, torch.bfloat16, seed + 100 + i)
        nbytes = 2 * (N * K + K * C + N * C) + 8 * C
        bound_ms, bound_by = bound(nbytes, 2 * N * K * C, torch.bfloat16)
        copies = copies_for(a)

        def kernel(t):
            return cf.matmul_affine_fwd(t["x"], t["w"], t["s"], t["b"], True)

        def plain(t):
            return cf.matmul_affine_reference(t["x"], t["w"], t["s"],
                                              t["b"], True)

        def library(t):
            return torch.matmul(t["x"], t["w"])

        # Turns: plain, kernel, library, kernel, plain.
        p1 = time_ms(plain, copies, 3)
        k1 = time_ms(kernel, copies, 30)
        lib_ms = time_ms(library, copies, 30)
        k2 = time_ms(kernel, copies, 30)
        p2 = time_ms(plain, copies, 3)
        k_eager = eager_ms(kernel, copies, 30)
        row = dict(N=N, K=K, C=C, launches_per_step=n,
                   kernel_ms=min(k1, k2), kernel_ms_runs=[k1, k2],
                   kernel_eager_ms=k_eager, plain_ms=min(p1, p2),
                   plain_ms_runs=[p1, p2], library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_fraction=bound_ms / min(k1, k2),
                   copies=len(copies))
        emit({"phase": "conv_timing", **row})
        rows.append(row)
        del a, copies
        torch.cuda.empty_cache()
    step = {key: sum(r[key] * r["launches_per_step"] for r in rows)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["launches_per_step"] for r in rows
                 if r["bound_by"] == "operations")
    step["bound_by"] = ("operations" if by_ops * 2 > step["bound_ms"]
                        else "bytes")
    step["launches"] = sum(r["launches_per_step"] for r in rows)
    step["distinct_shapes"] = len(rows)
    emit({"phase": "conv_timing_step", **step})
    return step


# ------------------------------------------------------------------ resnet
def resnet_group(name):
    n = name.lower()
    if "matmul_affine" in n:
        return "k6"
    if any(t in n for t in ("fprop", "dgrad", "wgrad", "conv", "implicit")):
        return "convolutions"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "matrix_products"
    if "reduce" in n:
        return "reductions"
    if "nccl" in n:
        return "collectives"
    if any(t in n for t in ("elementwise", "vectorized", "copy", "fill")):
        return "elementwise_and_copies"
    return "other"


def resnet_arm(cf, dev, card, seed, bn, conv1, comm, batch, warmup=2,
               timed=5, total=0):
    """``warmup`` + ``timed`` steps, one traced step, then untimed steps
    up to ``total`` (the losses of every step are kept)."""
    import gc

    from chainermn_tpu_torch.models import FusedConv1x1, ResNet50, resnet_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = ResNet50(num_classes=RESNET_CLASSES, axis_name=comm.axis_name,
                     bn=bn, conv1=conv1, device=dev, seed=seed)
    if bn == "frozen":
        model.scale_residual_branches(FROZEN_BRANCH_SCALE)
    opt = create_multi_node_optimizer(sgd(0.1, 0.9), comm)
    state = opt.init(model)
    step = opt.make_train_step(resnet_loss(model), stateful=True)
    # The first warm-up step records the (N, Cin, Cout) of every fused 1x1
    # conv, to hold the parity and timing phases' shapes to the model's.
    seen = []

    def record(mod, inp, out):
        seen.append((out.shape[0] * out.shape[2] * out.shape[3],
                     inp[0].shape[1], out.shape[1]))

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, FusedConv1x1)]
    losses = []
    for i in range(warmup):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            for h in hooks:
                h.remove()
    torch.cuda.synchronize()
    cf.matmul_affine_fwd.launches = 0
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # syncs: the step is done
        times.append(time.perf_counter() - t0)
    launches = cf.matmul_affine_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    arm = f"{bn}/{conv1}"
    trace = trace_step(step, state, batch, group=resnet_group, top=20)
    emit({"phase": "resnet_trace", "arm": arm, "card": card, **trace})
    losses.append(trace["loss"])
    while len(losses) < total:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    step_ms = sorted(times)[len(times) // 2] * 1e3
    row = dict(phase="resnet", arm=arm, card=card,
               params=sum(p.numel() for p in model.parameters()),
               batch=RESNET_BATCH, image_size=RESNET_SIZE,
               cudnn_benchmark=torch.backends.cudnn.benchmark,
               warmup_steps=warmup, timed_steps=timed, losses=losses,
               step_ms_median=step_ms, step_ms_runs=[t * 1e3 for t in times],
               images_per_s=RESNET_BATCH / (step_ms / 1e3),
               peak_memory_gb=peak / 1e9,
               launches={"matmul_affine_fwd": launches},
               launches_per_step=launches / timed,
               k6_device_ms_per_step=trace["groups_ms"].get("k6", 0.0),
               fused_conv_shapes_seen=len(seen))
    emit(row)
    check(all(math.isfinite(x) for x in losses),
          f"resnet {arm}: non-finite loss {losses}")
    if conv1 != "none":
        check(sorted(seen) == sorted(k6_launches()),
              f"resnet {arm}: the fused convs ran at {sorted(set(seen))}, "
              "not at the shapes the parity and timing phases used")
    del model, opt, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_resnet(cf, dev, card, seed):
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("xla", device=dev,
                               allreduce_grad_dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = (torch.randn((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                         generator=g, device=dev),
             torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,), generator=g,
                           device=dev))
    torch.backends.cudnn.benchmark = True
    try:
        arms = {}
        for bn, conv1 in (("sync", "none"), ("frozen", "pallas"),
                          ("frozen", "xla")):
            # The headline runs on to the bench's 25 steps (5 warm-up +
            # 20 timed, bench.py:1069) on its one fixed batch.  At lr 0.1
            # and momentum 0.9 its loss falls over the first two steps
            # (7.397 -> 6.43 -> 6.07-6.10 on an H100, every run) and then
            # wanders: from step 5 on, runs of one tree part ways through
            # cuDNN's nondeterministic sums, and the loss at step 25 read
            # 5.43-7.96 over seven runs of two trees, above the first
            # step's in two of them.  So the check is on the first two
            # steps; the 25 steps must stay finite.
            arms[f"{bn}/{conv1}"] = resnet_arm(
                cf, dev, card, seed, bn, conv1, comm, batch,
                total=RESNET_BENCH_STEPS if bn == "sync" else 0)
    finally:
        torch.backends.cudnn.benchmark = False
    sync, fused, plain = (arms["sync/none"], arms["frozen/pallas"],
                          arms["frozen/xla"])
    emit({"phase": "resnet_summary", "card": card,
          "step_ms": {k: a["step_ms_median"] for k, a in arms.items()},
          "images_per_s": {k: a["images_per_s"] for k, a in arms.items()},
          "peak_memory_gb": {k: a["peak_memory_gb"] for k, a in arms.items()},
          "pallas_over_xla_step_ratio": fused["step_ms_median"]
          / plain["step_ms_median"]})
    n = len(k6_launches())
    check(fused["launches_per_step"] == n,
          f"resnet frozen/pallas: K6 launched {fused['launches_per_step']} "
          f"times per step, expected {n}")
    check(sync["launches"]["matmul_affine_fwd"] == 0
          and plain["launches"]["matmul_affine_fwd"] == 0,
          "resnet: the sync or frozen/xla arm launched K6")
    first = sync["losses"][:3]
    check(first[0] > first[1] > first[2],
          f"resnet sync/none: loss did not fall over its first two steps: "
          f"{sync['losses']}")
    return fused


def phase_resnet_agreement(cf, dev, seed):
    """K6's fp32 instantiation against the plain twin inside the model,
    both on the card, through three SGD steps from the same weights."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import ResNetTiny, resnet_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    rng = np.random.RandomState(seed + 8)
    batches = [(torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
                .to(dev), torch.from_numpy(rng.randint(0, 10, size=8)).to(dev))
               for _ in range(3)]
    comm = create_communicator("xla", device=dev)
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for impl in ("pallas", "xla"):
            model = ResNetTiny(num_classes=10, width=16, dtype=torch.float32,
                               bn="frozen", conv1=impl, device=dev, seed=seed)
            model.scale_residual_branches(FROZEN_BRANCH_SCALE)
            opt = create_multi_node_optimizer(sgd(0.1, 0.9), comm)
            state = opt.init(model)
            step = opt.make_train_step(resnet_loss(model), stateful=True)
            before = cf.matmul_affine_fwd.launches
            losses = [float(step(state, b)[1]["loss"]) for b in batches]
            runs[impl] = (losses, {n: p.detach().clone()
                                   for n, p in model.named_parameters()},
                          cf.matmul_affine_fwd.launches - before)
    finally:
        torch.backends.cudnn.deterministic = False
    lf, lx = runs["pallas"][0], runs["xla"][0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lx))
    param_err = max((runs["pallas"][1][n] - runs["xla"][1][n]).abs().max()
                    .item() for n in runs["xla"][1])
    emit({"phase": "resnet_agreement", "dtype": "float32",
          "losses_pallas": lf, "losses_plain": lx,
          "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err,
          "launches": {k: v[2] for k, v in runs.items()},
          "tolerance": {"loss_rtol": 1e-5, "param_atol": 1e-4}})
    check(runs["pallas"][2] == 3 * 12 and runs["xla"][2] == 0,
          f"resnet_agreement: K6 launches {runs['pallas'][2]} / "
          f"{runs['xla'][2]}, expected 36 / 0 (4 blocks x fc1, fc3, proj_f "
          "x 3 steps)")
    check(all(math.isfinite(x) for x in lf + lx),
          f"resnet_agreement: non-finite losses {lf} {lx}")
    check(loss_rel <= 1e-5 and param_err <= 1e-4,
          f"resnet_agreement: losses {lf} vs {lx}, parameters differ by "
          f"{param_err}")


def phase_train_imagenet_example():
    from chainermn_tpu_torch.examples import train_imagenet

    t0 = time.perf_counter()
    loss = train_imagenet.main(["--steps", "3"])
    check(math.isfinite(loss), f"train_imagenet example: loss {loss}")
    emit({"phase": "train_imagenet_example", "steps": 3, "final_loss": loss,
          "wall_s": time.perf_counter() - t0})


# ------------------------------------------------------------------ SASS
#: the bf16 flash kernels (K1, K2, K3) by the name of their function, each
#: instantiated at head dims 32, 64 and 128, and the bf16 fused 1x1-conv
#: kernel (K6), instantiated at column tiles 64 and 128: every one must be
#: built on Hopper's wgmma and TMA.
FLASH_SASS = ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")
CONV_SASS = ("matmul_affine_bf16",)
CONV_TILES = (64, 128)


def _sass_rows(counts, kernels):
    """``{"<kernel><N>": value}`` of the functions among ``counts``'s
    (mangled) names that instantiate one of ``kernels`` with the integer
    template argument N."""
    import re

    rows = {}
    for fn, c in counts.items():
        for kernel in kernels:
            m = re.search(rf"{kernel}ILi(\d+)E", fn)
            if m:
                rows[f"{kernel}<{m.group(1)}>"] = c
    return rows


def flash_sass_rows(counts):
    """``{"<kernel><D>": counts}`` of the bf16 flash functions among
    ``_kernels.sass_counts``'s (mangled) names."""
    return _sass_rows(counts, FLASH_SASS)


def conv_sass_rows(counts):
    """``{"matmul_affine_bf16<BN>": counts}`` of the bf16 fused-conv
    functions among ``_kernels.sass_counts``'s (mangled) names."""
    return _sass_rows(counts, CONV_SASS)


def _phase_sass(kernels, phase, source, rows_of, expected):
    """Counts of HGMMA (wgmma), HMMA (mma.sync) and UTMALDG (TMA loads) in
    each bf16 function of ``source``'s library, and the functions whose
    wgmmas ptxas serialized (its C75xx warnings in the library's build
    log; null when no log can be read), printed before the check that each
    of the ``expected`` functions is there, uses wgmma and TMA and no
    mma.sync, and keeps its wgmmas asynchronous.  A library without its
    log fails the check."""
    rows = rows_of(kernels.sass_counts(kernels.sass(source)))
    log = kernels.build_log(source)
    serialized = None if log is None else sorted(rows_of(
        dict.fromkeys(kernels.serialized_wgmma(log), 0)))
    emit({"phase": phase, "functions": rows,
          "serialized_wgmma": serialized})
    check(sorted(rows) == sorted(expected),
          f"{phase}: expected the bf16 functions {sorted(expected)}, found "
          f"{sorted(rows)}")
    check(serialized is not None,
          f"{phase}: no build log of the {source} library to read ptxas's "
          "serialization warnings from")
    for name, c in rows.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0,
              f"{phase}: {name} is not built on wgmma and TMA: {c}")
        check(name not in serialized,
              f"{phase}: ptxas serialized the wgmmas of {name}")


def phase_flash_sass(kernels):
    """``_phase_sass`` over the flash library: K1, K2 and K3 at head dims
    32, 64 and 128."""
    _phase_sass(kernels, "flash_sass", "flash_attention", flash_sass_rows,
                [f"{k}<{d}>" for k in FLASH_SASS for d in (32, 64, 128)])


def phase_conv_sass(kernels):
    """``_phase_sass`` over the fused-conv library: K6 at each column
    tile."""
    _phase_sass(kernels, "conv_sass", "conv_fused", conv_sass_rows,
                [f"{k}<{n}>" for k in CONV_SASS for n in CONV_TILES])


#: the decode-attention functions (K4 ``paged``, K5 ``fused``), named
#: ``decode_<kind>_q<type>_kv<type>_rb<rows per CTA>``; those of bf16
#: caches, the main path's, must copy K/V asynchronously and spill nothing.
DECODE_SASS = r"decode_(paged|fused)_q(f32|bf16)_kv(f32|bf16|i8)_rb(\d+)"
DECODE_BF16 = [f"decode_{k}_q{q}_kvbf16_rb{rb}" for k in ("paged", "fused")
               for q in ("f32", "bf16") for rb in (1, 4)]


def decode_sass_rows(counts, resources):
    """``{"decode_<...>": counts and ptxas resources}`` of the decode
    functions among ``_kernels.sass_counts``'s (mangled) names; a function
    ptxas did not report has no resource keys."""
    import re

    rows = {}
    for fn, c in counts.items():
        m = re.search(DECODE_SASS, fn)
        if m:
            rows[m.group(0)] = {**c, **resources.get(fn, {})}
    return rows


def phase_decode_sass(kernels):
    """The asynchronous copies (``UBLKCP``, ``LDGSTS``) of every
    decode-attention function, with ptxas's registers, stack frame and
    spill bytes from the library's build log, printed before the check
    that each bf16-cache function is there, copies asynchronously and
    spills nothing.  A library without its log fails the check."""
    log = kernels.build_log("decode_attention")
    rows = decode_sass_rows(
        kernels.sass_counts(kernels.sass("decode_attention")),
        kernels.ptxas_resources(log) if log is not None else {})
    emit({"phase": "decode_sass", "functions": rows})
    check(log is not None, "decode_sass: no build log of the "
          "decode_attention library to read ptxas's spills from")
    missing = sorted(set(DECODE_BF16) - set(rows))
    check(not missing, f"decode_sass: bf16 functions missing: {missing}")
    for name in DECODE_BF16:
        c = rows[name]
        check(c["UBLKCP"] + c["LDGSTS"] > 0,
              f"decode_sass: {name} has no asynchronous copy: {c}")
        check(c.get("spill_stores") == 0,
              f"decode_sass: {name} spills (or ptxas reported no spill "
              f"line): {c}")


# ------------------------------------------------------- tree comparison
#: what ``--compare-with`` times in each tree: the decode kernels (phase 4
#: with its long rows) and the bf16 serving drive (phase 5's first), the
#: flash kernels (phase 9), the LM flash-arm step (phase 10's first arm),
#: the fused-conv kernel (phase 13) and the ``frozen/pallas`` ResNet step
#: (an arm of phase 14).
COMPARE_PHASES = ("decode", "flash", "lm", "conv", "resnet")

#: run in another checkout's root: the phases named in its second argument,
#: through that checkout's own chip_smoke.py, except ``decode``: this
#: script (its path is the third argument) times that checkout's own
#: decode kernels and drives its own serving engine, so that both trees
#: are measured by the same code at the same shapes.
_COMPARE_WORKER = """
import importlib, importlib.util, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.ops import conv_fused as cf
seed, phases = int(sys.argv[1]), sys.argv[2].split(",")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = cs.nvidia_smi()
if "decode" in phases:
    spec = importlib.util.spec_from_file_location("harness", sys.argv[3])
    hs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hs)
    ops = importlib.import_module("chainermn_tpu_torch.ops.decode_attention")
    hs.emit({"phase": "decode_ops", "file": ops.__file__})
    _, mb = hs.engine_geometry(hs.draw_requests(
        np.random.RandomState(seed), 16, hs.FULL["vocab"]))
    hs.phase_timing(ops, dev, seed, mb)
    hs.phase_long_timing(ops, dev, seed)
    hs.drive_serving(ops, dev, card, seed, "bf16_mha", 16)
fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
comm = create_communicator("xla", device=dev,
                           allreduce_grad_dtype=torch.bfloat16)
if "flash" in phases:
    cs.phase_flash_timing(fa, dev, seed)
if "lm" in phases:
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cs.LM["vocab"], size=(cs.LM_BATCH, cs.LM["max_len"]))).to(dev)
    cs.train_arm(fa, dev, card, seed, "flash", comm, (toks, toks))
if "conv" in phases:
    cs.phase_conv_timing(cf, dev, seed)
if "resnet" in phases:
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = (torch.randn((cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_SIZE,
                          3), generator=g, device=dev),
             torch.randint(0, cs.RESNET_CLASSES, (cs.RESNET_BATCH,),
                           generator=g, device=dev))
    torch.backends.cudnn.benchmark = True
    cs.resnet_arm(cf, dev, card, seed, "frozen", "pallas", comm, batch)
"""


def compare_trees(other, seed, phases=COMPARE_PHASES):
    """``phases`` (of ``COMPARE_PHASES``) of checkout ``other`` (for
    example the parent commit, unpacked with ``git archive``, or a
    patched copy) and of this one, in turns other, this, this, other, each
    in a process of its own; every line is printed with its tree."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, "-c", _COMPARE_WORKER, str(seed),
             ",".join(phases), os.path.abspath(__file__)],
            cwd=tree, capture_output=True, text=True, timeout=1800)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit({"tree": label, "dir": tree, **json.loads(line)})
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            check(False, f"compare: the {label} tree failed "
                         f"(exit {proc.returncode})")
    return 0


# -------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-with", metavar="DIR",
                    help="only time the decode, flash and fused-conv "
                         "kernels, the bf16 serving drive, the LM flash "
                         "step and the frozen/pallas ResNet step of the "
                         "checkout DIR and of this one, in turns (see "
                         "compare_trees)")
    ap.add_argument("--compare-phases", default=",".join(COMPARE_PHASES),
                    help="with --compare-with: which of "
                         f"{','.join(COMPARE_PHASES)} to time "
                         "(comma-separated; default all)")
    args = ap.parse_args()
    phases = args.compare_phases.split(",")
    if any(ph not in COMPARE_PHASES for ph in phases):
        ap.error(f"--compare-phases takes {COMPARE_PHASES}, got {phases}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    if args.compare_with:
        return compare_trees(args.compare_with, args.seed, phases)

    import importlib

    from chainermn_tpu_torch.ops import _kernels
    from chainermn_tpu_torch.ops import conv_fused as cf
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
        print(f"--- nvcc csrc/{n}.cu\n{_kernels.build_log(n) or ''}",
              file=sys.stderr)
    emit({"phase": "build", "sources": sources,
          "seconds": time.perf_counter() - t0})
    phase_flash_sass(_kernels)
    phase_conv_sass(_kernels)
    phase_decode_sass(_kernels)

    # The block-table width the serving phase's engine will have.
    _, mb = engine_geometry(draw_requests(
        np.random.RandomState(args.seed), 16, FULL["vocab"]))
    errs = phase_parity(ops, dev, args.seed, mb)
    errs.update(phase_flash_parity(fa, dev, args.seed))
    timing = phase_timing(ops, dev, args.seed, mb)
    phase_long_timing(ops, dev, args.seed)
    timing.update(phase_flash_timing(fa, dev, args.seed))

    serve = drive_serving(ops, dev, smi, args.seed, "bf16_mha", 16)
    drive_serving(ops, dev, smi, args.seed + 10, "int8_gqa", 6,
                  n_kv_heads=4, kv_dtype=torch.int8)
    gen = phase_generation(ops, dev, smi, args.seed)
    phase_agreement(dev, args.seed)
    train = phase_training(fa, dev, smi, args.seed)
    phase_training_agreement(fa, dev, args.seed)

    errs["matmul_affine_fwd"] = phase_conv_parity(cf, dev, args.seed)
    # K6's row holds the sums over the 36 launches of one training step.
    timing["matmul_affine_fwd"] = phase_conv_timing(cf, dev, args.seed)
    resnet = phase_resnet(cf, dev, smi, args.seed)
    phase_resnet_agreement(cf, dev, args.seed)
    phase_train_imagenet_example()

    launches = {"paged_decode_attention":
                serve["launches"]["paged_decode_attention"],
                "fused_decode_attention":
                gen["launches"]["fused_decode_attention"],
                **train["launches"], **resnet["launches"]}
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
