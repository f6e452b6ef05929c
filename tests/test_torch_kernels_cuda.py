"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package, so it runs on a host that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-4 (sums over up to a few thousand positions taken in
another order); bf16 outputs 2e-2 (one bf16 rounding of O(1) values; both
sides compute in fp32 from the same bf16 inputs).
"""

import math

import pytest
import torch

from chainermn_tpu_torch.ops import decode_attention as tda

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
    got = tda.paged_decode_attention(*args)
    assert tda.paged_decode_attention.launches == before + 1
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
    got = tda.fused_decode_attention(*args)
    assert tda.fused_decode_attention.launches == before + 1
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
