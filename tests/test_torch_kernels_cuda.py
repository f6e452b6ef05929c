"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package, so it runs on a host that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-4 (sums over up to a few thousand positions taken in
another order); bf16 outputs 2e-2 (one bf16 rounding of O(1) values; both
sides compute in fp32 from the same bf16 inputs).  The flash kernels hold
each element to |err| <= rtol |ref| + atol rms(its reference row over the
head dim), as ``chip_smoke.py`` does: fp32 rtol 1e-5, atol 1e-4 (sums in
another order); bf16 rtol 2^-7 (each side rounds its output to bf16), atol
3e-2 (P and dS rounded to bf16 as tensor-core operands); lse |err| <=
1e-5 |ref| + 1e-5.  The fused 1x1-conv kernel (K6) uses the same measure
over its output rows, with ``chip_smoke.py``'s ``K6_TOL``.
"""

import importlib
import math

import pytest
import torch

import chip_smoke
from chainermn_tpu_torch.ops import _kernels
from chainermn_tpu_torch.ops import conv_fused as tcf
from chainermn_tpu_torch.ops import decode_attention as tda

pytestmark = pytest.mark.cuda

# The module (``chainermn_tpu_torch.ops`` re-exports a function of the
# same name).
tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module", autouse=True)
def watchdog():
    """The kernels built with their hang watchdog (``_kernels.
    WATCHDOG_ENV``): a broken pipeline fails its test instead of hanging
    the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(_kernels.WATCHDOG_ENV, "1")
        yield


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    return torch.device("cuda", 0)


def _quantize(x):
    scale = torch.clamp_min(x.abs().amax(dim=-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.contiguous()


def _paged(dev, S, T, H, KH, Dh, BL, MB, valid, dtype, quant, seed=0):
    g = torch.Generator().manual_seed(seed)
    need = [math.ceil(min(v + T - 1, MB * BL) / BL) for v in valid]
    NB = 1 + sum(need) + 3
    perm = (torch.randperm(NB - 1, generator=g) + 1).tolist()
    tables = torch.zeros((S, MB), dtype=torch.int32)
    for s, n in enumerate(need):
        tables[s, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    q = torch.randn((S, T, H, Dh) if T > 1 else (S, H, Dh), generator=g)
    k = torch.randn((KH, NB, BL, Dh), generator=g)
    v = torch.randn((KH, NB, BL, Dh), generator=g)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (q.to(dev, dtype), k.to(dev), v.to(dev), tables.to(dev),
            torch.tensor(valid, dtype=torch.int32, device=dev), ks, vs)


def _fused(dev, B, H, KH, L, Dh, valid, dtype, quant, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, Dh), generator=g)
    k = torch.randn((B, KH, L, Dh), generator=g)
    v = torch.randn((B, KH, L, Dh), generator=g)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = _quantize(k), _quantize(v)
        ks, vs = ks.to(dev), vs.to(dev)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (q.to(dev, dtype), k.to(dev), v.to(dev),
            torch.tensor(valid, dtype=torch.int32, device=dev), ks, vs)


def _err(a, b):
    torch.cuda.synchronize()
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("KH,Dh", [(12, 64), (4, 64), (6, 16), (4, 32),
                                   (12, 128)])
def test_paged_matches_plain(dev, dtype, quant, T, KH, Dh):
    args = _paged(dev, 8, T, 12, KH, Dh, 16, 12,
                  [0, 1, 15, 16, 17, 100, 150, 189], dtype, quant)
    before = tda.paged_decode_attention.launches
    runs = tda.kernel_runs(dev)["paged_decode_attention"]
    got = tda.paged_decode_attention(*args)
    assert tda.paged_decode_attention.launches == before + 1
    assert tda.kernel_runs(dev)["paged_decode_attention"] == runs + 1
    want = tda.paged_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype]
    if T == 1:
        assert bool((got[0] == 0).all()), (
            "fully masked paged row must be exactly 0: exp(NEG_INF - "
            "NEG_INF) = 1 leaked into the sum"
        )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("L,KH,Dh", [(192, 12, 64), (192, 4, 64),
                                     (4096, 4, 16), (300, 6, 32),
                                     (100, 12, 128)])
def test_fused_matches_plain(dev, dtype, quant, L, KH, Dh):
    args = _fused(dev, 8, 12, KH, L, Dh,
                  [0, 1, 31, 32, 33, L // 2, L - 1, L], dtype, quant)
    before = tda.fused_decode_attention.launches
    runs = tda.kernel_runs(dev)["fused_decode_attention"]
    got = tda.fused_decode_attention(*args)
    assert tda.fused_decode_attention.launches == before + 1
    assert tda.kernel_runs(dev)["fused_decode_attention"] == runs + 1
    want = tda.fused_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype], (
        "a row with valid_len 0 must give the mean of V over the whole "
        "panel, as the Pallas one-shot softmax does"
    )


def test_cuda_wrappers_never_run_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(tda, "paged_decode_attention_reference", boom)
    monkeypatch.setattr(tda, "fused_decode_attention_reference", boom)
    tda.paged_decode_attention(*_paged(dev, 2, 1, 4, 4, 64, 16, 2, [3, 20],
                                       torch.bfloat16, False))
    tda.fused_decode_attention(*_fused(dev, 2, 4, 4, 32, 64, [3, 20],
                                       torch.bfloat16, False))
    torch.cuda.synchronize()


def test_cuda_wrappers_reject_what_the_kernel_does_not_take(dev):
    q, k, v, valid, _, _ = _fused(dev, 2, 4, 2, 32, 64, [3, 20],
                                  torch.float32, False)
    with pytest.raises(ValueError, match="contiguous"):
        tda.fused_decode_attention(q, k.transpose(2, 3).contiguous()
                                   .transpose(2, 3), v, valid)
    with pytest.raises(ValueError, match="one device"):
        tda.fused_decode_attention(q, k, v, valid.cpu())
    with pytest.raises(TypeError, match="float16"):
        tda.fused_decode_attention(q.half(), k, v, valid)
    with pytest.raises(ValueError, match="head dim"):
        tda.fused_decode_attention(q[..., :48].contiguous(),
                                   k[..., :48].contiguous(),
                                   v[..., :48].contiguous(), valid)


# ------------------------------------------ decode: the split-KV launch
# The kernels split each row's positions over the CTAs of a cluster
# (``tda._plan``); these cases put lengths on the plan's split boundaries,
# straddle one with a verify chunk's rows, leave whole splits empty, and
# replay a captured launch after the lengths and tables change in place.

def _elt(dtype, quant):
    return 1 if quant else torch.tensor([], dtype=dtype).element_size()


@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["bf16", "fp32", "int8"])
@pytest.mark.parametrize("T,KH", [(1, 12), (4, 4)], ids=["mha", "gqa_t4"])
def test_paged_split_boundaries(dev, dtype, quant, T, KH):
    S, H, Dh, BL, MB = 8, 12, 64, 16, 15
    _, per, _ = tda._plan(MB * BL, S, KH, T * (H // KH), Dh *
                          _elt(dtype, quant), tda._sm_count(dev),
                          block_len=BL)
    valid = chip_smoke.split_lengths(per, MB * BL, T)
    args = _paged(dev, S, T, H, KH, Dh, BL, MB, valid, dtype, quant)
    got = tda.paged_decode_attention(*args)
    want = tda.paged_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype], f"valid {valid}, per {per}"
    if T == 1:
        assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["bf16", "fp32", "int8"])
@pytest.mark.parametrize("L,KH", [(192, 12), (4096, 4), (100, 6)])
def test_fused_split_boundaries(dev, dtype, quant, L, KH):
    _, per, _ = tda._plan(L, 8, KH, 12 // KH, 64 * _elt(dtype, quant),
                          tda._sm_count(dev))
    valid = chip_smoke.split_lengths(per, L)
    args = _fused(dev, 8, 12, KH, L, 64, valid, dtype, quant)
    got = tda.fused_decode_attention(*args)
    want = tda.fused_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype], f"valid {valid}, per {per}"


@pytest.mark.parametrize("dtype,quant", [(torch.float32, False),
                                         (torch.bfloat16, False),
                                         (torch.bfloat16, True),
                                         (torch.float32, True)],
                         ids=["fp32", "bf16", "int8", "int8_fp32_q"])
@pytest.mark.parametrize("KH", [4, 1], ids=["gqa", "mqa"])
def test_paged_verify16_gqa(dev, dtype, quant, KH):
    """T = MAX_VERIFY_T with G = 3 (48 rows per kv head) and G = 12 (192):
    the rows take several row blocks of CTAs."""
    S, T, H, Dh, BL, MB = 8, tda.MAX_VERIFY_T, 12, 64, 16, 12
    valid = [0, 1, 15, 16, 17, 100, 150, MB * BL - (T - 1)]
    args = _paged(dev, S, T, H, KH, Dh, BL, MB, valid, dtype, quant)
    got = tda.paged_decode_attention(*args)
    want = tda.paged_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype]
    # Idle slot 0, offset 0: every row fully masked, exactly 0.
    assert bool((got[0, 0] == 0).all())


@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, False),
                                         (torch.float32, False),
                                         (torch.bfloat16, True)],
                         ids=["bf16", "fp32", "int8"])
def test_fused_max_len(dev, dtype, quant):
    L = tda.MAX_FUSED_LEN
    valid = [0, 1, 2047, 2048, 2049, L // 2 + 1, L - 1, L]
    args = _fused(dev, 8, 12, 12, L, 64, valid, dtype, quant)
    got = tda.fused_decode_attention(*args)
    want = tda.fused_decode_attention_reference(*args)
    assert _err(got, want) <= TOL[dtype]


def test_wrappers_replay_in_a_cuda_graph(dev):
    """One capture of each wrapper, then valid_len and the block tables
    rewritten in place and the graph replayed: the launch read neither on
    the host, so the replay follows the new values.  The wrappers count
    the captured launches in ``.captured``; each replay's runs are
    counted on the card only."""
    S, H, KH, Dh, BL, MB, L = 8, 12, 4, 64, 16, 12, 300
    full = [MB * BL] * S  # every slot's table maps MB distinct blocks
    pq, pk, pv, tables, pvalid, pks, pvs = _paged(
        dev, S, 1, H, KH, Dh, BL, MB, full, torch.bfloat16, True)
    fq, fk, fv, fvalid, _, _ = _fused(dev, S, H, KH, L, Dh, [L] * S,
                                      torch.bfloat16, False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tda.paged_decode_attention(pq, pk, pv, tables, pvalid, pks, pvs)
        tda.fused_decode_attention(fq, fk, fv, fvalid)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    launched = (tda.paged_decode_attention.launches,
                tda.fused_decode_attention.launches)
    captured = (tda.paged_decode_attention.captured,
                tda.fused_decode_attention.captured)
    with torch.cuda.graph(graph):
        out_p = tda.paged_decode_attention(pq, pk, pv, tables, pvalid, pks,
                                           pvs)
        out_f = tda.fused_decode_attention(fq, fk, fv, fvalid)
    assert (tda.paged_decode_attention.captured,
            tda.fused_decode_attention.captured) == tuple(
                n + 1 for n in captured)
    tda.zero_kernel_runs(dev)
    for new_p, new_f in (([0, 1, 16, 17, 31, 100, 150, MB * BL],
                          [0, 1, 31, 32, 33, 150, L - 1, L]),
                         ([5, MB * BL, 0, 64, 65, 2, 190, 33],
                          [-2, L, 17, 1, 299, 64, 0, 128])):
        pvalid.copy_(torch.tensor(new_p, dtype=torch.int32))
        fvalid.copy_(torch.tensor(new_f, dtype=torch.int32))
        tables.copy_(tables.roll(1, dims=0))
        graph.replay()
        want_p = tda.paged_decode_attention_reference(
            pq, pk, pv, tables, pvalid, pks, pvs)
        want_f = tda.fused_decode_attention_reference(fq, fk, fv, fvalid)
        assert _err(out_p, want_p) <= TOL[torch.bfloat16]
        assert _err(out_f, want_f) <= TOL[torch.bfloat16]
        idle = [i for i, v in enumerate(new_p) if v == 0]
        assert bool((out_p[idle] == 0).all())
    assert tda.kernel_runs(dev) == {"paged_decode_attention": 2,
                                    "fused_decode_attention": 2}
    assert (tda.paged_decode_attention.launches,
            tda.fused_decode_attention.launches) == launched


# ------------------------------------------------------- flash K1-K3
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
             torch.bfloat16: dict(rtol=2 ** -7, atol=3e-2),
             "lse": dict(rtol=1e-5, atol=1e-5)}


def _excess(got, want, rtol, rows=True):
    """The least atol with which every element meets its tolerance: max of
    (|got - want| - rtol |want|) over the RMS of the reference's row
    (``rows``) or over 1.  A row whose reference is all zero must match
    exactly."""
    got, want = got.float(), want.float()
    slack = (got - want).abs() - rtol * want.abs()
    if rows:
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        slack = torch.where(slack > 0, slack / rms, torch.zeros_like(slack))
    return max(slack.max().item(), 0.0)


def _runs(rows, T):
    out = torch.zeros((len(rows), T), dtype=torch.int32)
    for r, runs in enumerate(rows):
        at = 0
        for sid, n in runs:
            out[r, at:at + n] = sid
            at += n
    return out


# name -> (B, T, S, H, KH, kwargs)
FLASH_CASES = {
    "causal": (2, 256, 256, 4, 4, dict(causal=True)),
    "noncausal": (2, 192, 192, 4, 4, dict()),
    "window": (2, 256, 256, 4, 4, dict(causal=True, window=48)),
    "packed_fully_masked": (2, 200, 200, 4, 4, dict(
        segment_ids=_runs([[(1, 70), (9, 60), (2, 70)], [(3, 200)]], 200),
        kv_segment_ids=_runs([[(1, 100), (2, 100)],
                              [(3, 150), (0, 50)]], 200))),
    "cross_kv_segments": (2, 96, 160, 4, 4, dict(
        segment_ids=_runs([[(1, 50), (2, 46)], [(1, 96)]], 96),
        kv_segment_ids=_runs([[(1, 80), (2, 70), (0, 10)],
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
        causal=True, segment_ids=_runs(
            [[(1, 100), (2, 90), (3, 110)], [(5, 37), (6, 263)]], 300))),
    # T a multiple of no q tile (128) and S of no kv tile (128, or 64 in
    # dQ at D = 128), with segments on both sides and GQA.
    "ragged_both_segments": (2, 200, 333, 4, 2, dict(
        segment_ids=_runs([[(1, 90), (2, 110)], [(4, 200)]], 200),
        kv_segment_ids=_runs([[(1, 150), (2, 183)],
                              [(4, 300), (0, 33)]], 333))),
    # The seq2seq model's cross-attention at its 8 heads: packed target
    # rows against source rows of another length, the first source row
    # with no pad tail, so its pad queries match no key (dead rows).
    "seq2seq_cross_dead_rows": (2, 448, 512, 8, 8, dict(
        segment_ids=_runs([[(1, 200), (2, 180), (0, 68)],
                           [(1, 300), (0, 148)]], 448),
        kv_segment_ids=_runs([[(1, 260), (2, 252)],
                              [(1, 400), (0, 112)]], 512))),
    # ViT-S/16 at 224 px: non-causal self-attention over 196 tokens (a
    # multiple of no tile) at its 6 heads.
    "vit_196": (2, 196, 196, 6, 6, dict()),
}


def flash_case(dev, name, D, dtype, seed=0):
    B, T, S, H, KH, kw = FLASH_CASES[name]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dtype)
               for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, D)))
    do = torch.randn((B, T, H, D), generator=g).to(dev, dtype)
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    kw = {key: (val.to(dev) if isinstance(val, torch.Tensor) else val)
          for key, val in kw.items()}
    return q, k, v, do, dlse, kw


def flash_check(q, k, v, do, dlse, kw):
    """Kernels through the autograd Function against the plain versions
    on the same inputs; returns the ``_excess`` of each output."""
    qk = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*qk, **kw)
    dq, dk, dv = torch.autograd.grad((o, lse), qk, (do, dlse))
    seg_q, seg_kv = tfa._validate(q, k, v, kw.get("causal", False),
                                  kw.get("segment_ids"),
                                  kw.get("kv_segment_ids"),
                                  kw.get("window"))
    args = (seg_q, seg_kv, kw.get("causal", False), kw.get("window"))
    o_r, lse_r = tfa.flash_attention_fwd_reference(q, k, v, *args)
    # The plain backward takes what K2 and K3 took: the kernel's lse, and
    # delta formed from the kernel's o (from the plain o it would differ by
    # the two sides' bf16 roundings of o, no fault of K2 or K3).
    delta = ((do.float() * o.detach().float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    lse_k = lse.detach()
    dk_r, dv_r = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_k,
                                                       delta, *args)
    dq_r = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse_k, delta,
                                                *args)
    torch.cuda.synchronize()
    live = lse_r > -1e29
    rtol = FLASH_TOL[q.dtype]["rtol"]
    return dict(o=_excess(o, o_r, rtol),
                lse=_excess(lse[live], lse_r[live], FLASH_TOL["lse"]["rtol"],
                            rows=False),
                dq=_excess(dq, dq_r, rtol), dk=_excess(dk, dk_r, rtol),
                dv=_excess(dv, dv_r, rtol),
                dead_exact=bool((lse[~live] == -1e30).all()
                                and (o.transpose(1, 2)[~live] == 0).all()
                                and (dq.transpose(1, 2)[~live] == 0).all()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernels_match_plain(dev, name, D, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dkv.launches,
              tfa.flash_attention_bwd_dq.launches)
    err = flash_check(*flash_case(dev, name, D, dtype))
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches) == tuple(
                b + 1 for b in before)
    assert err["lse"] <= FLASH_TOL["lse"]["atol"], err
    for key in ("o", "dq", "dk", "dv"):
        assert err[key] <= FLASH_TOL[dtype]["atol"], (key, err)
    assert err["dead_exact"], (
        "a fully masked row must give o = 0, lse = -1e30 and dq = 0")


@pytest.mark.parametrize("layout", ["fused_qkv", "heads_major", "head_0",
                                    "base_off_2"])
def test_flash_kernels_read_strided_views(dev, layout):
    """The bf16 kernels read q, k, v and dO through their strides (TMA
    tensor maps for the forward and dK/dV): the model's fused projection,
    a (B, H, T, D) tensor seen as (B, T, H, D) (the head stride above the
    sequence stride), and the two layouts the wrappers copy first -- a
    broadcast head (stride 0) and a base 2 bytes off alignment.  Each
    wrapper is called on the views themselves and held against its plain
    version."""
    B, T, H, D = 2, 200, 4, 64
    g = torch.Generator().manual_seed(5)

    def make(n):
        x = torch.randn((B, T, n, H, D), generator=g).to(dev, torch.bfloat16)
        if layout == "fused_qkv":
            return list(x.unbind(2))
        x = x.unbind(2)
        if layout == "heads_major":
            return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in x]
        if layout == "head_0":
            return [t[:, :, :1].expand(B, T, H, D) for t in x]
        out = []
        for t in x:
            flat = torch.empty(B * T * H * D + 1, device=dev,
                               dtype=torch.bfloat16)
            out.append(flat[1:].view(B, T, H, D).copy_(t))
        return out

    q, k, v = make(3)
    (do,) = make(1)
    # A random lse cotangent, as the autograd Function forms delta: without
    # it the first causal row's dq is exactly 0 and has no scale to hold
    # the kernel's rounding against.
    dlse = torch.randn((B, H, T), generator=g).to(dev)
    args = (None, None, True)
    o_r, lse_r = tfa.flash_attention_fwd_reference(q, k, v, *args)
    delta = ((do.float() * o_r.float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, *args)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, *args)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, *args)
    dk_r, dv_r = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse_r,
                                                       delta, *args)
    dq_r = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse_r, delta,
                                                *args)
    torch.cuda.synchronize()
    rtol = FLASH_TOL[torch.bfloat16]["rtol"]
    for name, got, want in (("o", o, o_r), ("dk", dk, dk_r), ("dv", dv, dv_r),
                            ("dq", dq, dq_r)):
        err = _excess(got, want, rtol)
        assert err <= FLASH_TOL[torch.bfloat16]["atol"], (name, err)
    assert _excess(lse, lse_r, FLASH_TOL["lse"]["rtol"], rows=False) \
        <= FLASH_TOL["lse"]["atol"]


def test_flash_wrappers_never_run_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    for name in ("flash_attention_fwd_reference",
                 "flash_attention_bwd_dkv_reference",
                 "flash_attention_bwd_dq_reference"):
        monkeypatch.setattr(tfa, name, boom)
    q, k, v, do, dlse, kw = flash_case(dev, "causal", 64, torch.bfloat16)
    qk = [t.requires_grad_(True) for t in (q, k, v)]
    o, lse = tfa.flash_attention_lse(*qk, **kw)
    torch.autograd.grad((o, lse), qk, (do, dlse))
    torch.cuda.synchronize()


def test_flash_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 64, 2, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(TypeError, match="differs"):
        tfa.flash_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention_fwd(q, q.cpu(), q)


# ---------------------------------------------------------- fused conv K6
#: (N, Cin, Cout) of every K6 launch of a ResNet-50 training step at batch
#: 256, 224 px; ragged shapes that divide no tile; and the persistent
#: schedule's edges: fewer tiles than SMs (300 rows: three tiles), a Cout
#: that is no multiple of the 128-column tile.  (802816, 64, 256) has far
#: more tiles than SMs.
K6_MAIN = [
    (802816, 64, 64), (802816, 64, 256), (802816, 256, 64),
    (802816, 256, 128), (200704, 128, 512), (200704, 256, 512),
    (200704, 512, 128), (200704, 512, 256), (50176, 256, 1024),
    (50176, 512, 1024), (50176, 1024, 256), (50176, 1024, 512),
    (12544, 512, 2048), (12544, 1024, 2048), (12544, 2048, 512),
]
K6_SHAPES = K6_MAIN + [
    (1000, 24, 40), (37, 8, 16), (77, 20, 13), (300, 64, 64),
    (5000, 256, 200),
]
#: as ``chip_smoke.K6_TOL``: |err| <= rtol |ref| + atol rms(its ref row).
K6_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
          torch.bfloat16: dict(rtol=2 ** -7, atol=1e-4)}


def _k6_inputs(dev, N, K, C, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((K, C), generator=g, device=dev) / K ** 0.5).to(dtype)
    s = torch.rand((C,), generator=g, device=dev) + 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    return x, w, s, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "affine"])
@pytest.mark.parametrize("shape", K6_SHAPES,
                         ids=["x".join(map(str, s)) for s in K6_SHAPES])
def test_matmul_affine_matches_plain(dev, shape, relu, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _k6_inputs(dev, *shape, dtype)
    before = tcf.matmul_affine_fwd.launches
    got = tcf.matmul_affine_fwd(*args, relu)
    assert tcf.matmul_affine_fwd.launches == before + 1
    want = tcf.matmul_affine_reference(*args, relu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert _excess(got, want, K6_TOL[dtype]["rtol"]) <= K6_TOL[dtype]["atol"]
    if relu:
        assert float(got.float().min()) >= 0.0


def test_matmul_affine_reads_strided_rows(dev):
    """A row stride larger than Cin (a column slice of a wider matrix)
    is read in place, and the strided 1x1 conv's subsample is right."""
    x, w, s, b = _k6_inputs(dev, 300, 48, 40, torch.bfloat16)
    wide = torch.zeros((300, 64), device=dev, dtype=torch.bfloat16)
    wide[:, :48] = x
    got = tcf.matmul_affine_fwd(wide[:, :48], w, s, b)
    want = tcf.matmul_affine_reference(x, w, s, b)
    assert _excess(got, want, 2 ** -7) <= K6_TOL[torch.bfloat16]["atol"]
    x4 = torch.randn((2, 48, 7, 9), device=dev).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    got = tcf.conv1x1_bn_relu(x4, w, s, b, strides=(2, 2))
    want = tcf.conv1x1_bn_relu(x4.cpu(), w.cpu(), s.cpu(), b.cpu(),
                               strides=(2, 2))
    assert got.shape == (2, 4, 5, 40)
    assert _excess(got.cpu(), want, 2 ** -7) <= K6_TOL[torch.bfloat16][
        "atol"]


def test_matmul_affine_reads_a_misaligned_base(dev):
    """A view of x starting one element in (a base 2 bytes off the 16 TMA
    needs) is copied to an aligned buffer, and the result is right."""
    x, w, s, b = _k6_inputs(dev, 1000, 64, 128, torch.bfloat16)
    flat = torch.empty(x.numel() + 1, device=dev, dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape).copy_(x)
    assert shifted.data_ptr() % 16
    got = tcf.matmul_affine_fwd(shifted, w, s, b)
    want = tcf.matmul_affine_reference(x, w, s, b)
    assert _excess(got, want, 2 ** -7) <= K6_TOL[torch.bfloat16]["atol"]


@pytest.mark.parametrize("shape", [(50176, 256, 1024), (802816, 64, 64)],
                         ids=["50176x256x1024", "802816x64x64"])
def test_matmul_affine_main_path_makes_no_copy(dev, shape):
    """At a main-path shape the bf16 operands go to the kernel as they
    are: the only allocation of the call is its (N, Cout) output."""
    x, w, s, b = _k6_inputs(dev, *shape, torch.bfloat16)
    ops = tcf._tma_operands(x, w, s, b)
    assert [t.data_ptr() for t in ops[:4]] == [t.data_ptr()
                                               for t in (x, w, s, b)]
    assert ops[4] == shape[2]
    del ops
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the output gets a segment of its own size
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = tcf.matmul_affine_fwd(x, w, s, b)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - before == \
        out.numel() * out.element_size()


def test_matmul_affine_wrapper_never_runs_the_plain_version(dev,
                                                            monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(tcf, "matmul_affine_reference", boom)
    x, w, s, b = _k6_inputs(dev, 256, 64, 64, torch.bfloat16)
    xs = x.clone().requires_grad_(True)
    tcf.matmul_affine(xs, w, s, b, True, "pallas").float().sum().backward()
    torch.cuda.synchronize()


def test_matmul_affine_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w, s, b = _k6_inputs(dev, 64, 32, 16, torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        tcf.matmul_affine_fwd(x.half(), w.half(), s, b)
    with pytest.raises(TypeError, match="differs"):
        tcf.matmul_affine_fwd(x, w.float(), s, b)
    with pytest.raises(TypeError, match="float32"):
        tcf.matmul_affine_fwd(x, w, s.bfloat16(), b)
    with pytest.raises(ValueError, match="one device"):
        tcf.matmul_affine_fwd(x, w, s.cpu(), b)
    with pytest.raises(ValueError, match="x2d"):
        tcf.matmul_affine_fwd(x, w[:16], s, b)
