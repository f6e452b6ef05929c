"""The port's decode-attention ops against the JAX package's Pallas
kernels.

The JAX kernels run in Pallas interpret mode, which they select
themselves off-TPU, exactly as ``tests/ops_tests/test_decode_attention.py``
runs them.  Inputs are made with numpy from a seed and handed to both
packages.  On the CPU the port's wrappers run their plain versions, so
these cases hold the plain versions to the Pallas arithmetic in fp32 at
atol 1e-5 (fp32 sums in another order; the values are O(1)).

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.ops import decode_attention as jda
from chainermn_tpu_torch.ops import decode_attention as tda

pytestmark = pytest.mark.tier1

ATOL = 1e-5  # fp32, O(1) values, different summation order


def _quantize(x):
    """Symmetric absmax int8 per (.., position) row, as the model writes."""
    scale = np.maximum(np.abs(x).max(axis=-1), 1e-6) / 127.0
    q = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_inputs(S, T, H, KH, Dh, NB, BL, MB, valid, seed, quant=False):
    rng = np.random.RandomState(seed)
    shape_q = (S, T, H, Dh) if T > 1 else (S, H, Dh)
    q = rng.randn(*shape_q).astype(np.float32)
    kp = rng.randn(KH, NB, BL, Dh).astype(np.float32)
    vp = rng.randn(KH, NB, BL, Dh).astype(np.float32)
    # Shuffled tables: each slot owns a random set of distinct blocks.
    perm = rng.permutation(np.arange(1, NB))
    tables = np.zeros((S, MB), np.int32)
    for s in range(S):
        tables[s] = perm[s * MB:(s + 1) * MB]
    args = dict(q=q, kp=kp, vp=vp, tables=tables,
                valid=np.asarray(valid, np.int32), ks=None, vs=None)
    if quant:
        args["kp"], args["ks"] = _quantize(kp)
        args["vp"], args["vs"] = _quantize(vp)
    return args


def _run_paged(a):
    want = jda.paged_decode_attention(
        jnp.asarray(a["q"]), jnp.asarray(a["kp"]), jnp.asarray(a["vp"]),
        jnp.asarray(a["tables"]), jnp.asarray(a["valid"]),
        k_scale=None if a["ks"] is None else jnp.asarray(a["ks"]),
        v_scale=None if a["vs"] is None else jnp.asarray(a["vs"]),
    )
    got = tda.paged_decode_attention(
        _t(a["q"]), _t(a["kp"]), _t(a["vp"]), _t(a["tables"]),
        _t(a["valid"]),
        k_scale=None if a["ks"] is None else _t(a["ks"]),
        v_scale=None if a["vs"] is None else _t(a["vs"]),
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("case", [
    # (S, T, H, KH, Dh, BL, MB, valid, quant)
    ("mha", 3, 1, 4, 4, 16, 8, 4, [1, 17, 32], False),
    ("gqa", 3, 1, 6, 2, 16, 8, 4, [5, 0, 30], False),
    ("int8_gqa", 2, 1, 4, 2, 16, 8, 4, [9, 25], True),
    ("verify_t3", 3, 3, 4, 2, 16, 8, 4, [4, 0, 21], False),
    ("verify_int8", 2, 3, 4, 4, 32, 4, 5, [6, 13], True),
], ids=lambda c: c[0])
def test_paged_matches_pallas(case):
    _, S, T, H, KH, Dh, BL, MB, valid, quant = case
    a = _paged_inputs(S, T, H, KH, Dh, NB=S * MB + 1, BL=BL, MB=MB,
                      valid=valid, seed=len(case[0]), quant=quant)
    want, got = _run_paged(a)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_paged_fully_masked_row_is_exactly_zero():
    """An idle slot (valid 0, T == 1) must give exactly 0: the explicit
    probability mask keeps exp(NEG_INF - NEG_INF) = 1 out of the sum."""
    a = _paged_inputs(2, 1, 4, 2, 16, NB=9, BL=8, MB=4, valid=[0, 7],
                      seed=3)
    want, got = _run_paged(a)
    assert np.all(want[0] == 0.0)
    assert np.all(got[0] == 0.0), (
        "fully masked paged row leaked exp(NEG_INF - NEG_INF) = 1: "
        f"max |out| = {np.abs(got[0]).max()}"
    )
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _fused_inputs(B, H, KH, L, Dh, valid, seed, quant=False):
    rng = np.random.RandomState(seed)
    a = dict(q=rng.randn(B, H, Dh).astype(np.float32),
             kc=rng.randn(B, KH, L, Dh).astype(np.float32),
             vc=rng.randn(B, KH, L, Dh).astype(np.float32),
             valid=np.asarray(valid, np.int32), ks=None, vs=None)
    if quant:
        a["kc"], a["ks"] = _quantize(a["kc"])
        a["vc"], a["vs"] = _quantize(a["vc"])
    return a


def _run_fused(a):
    want = jda.fused_decode_attention(
        jnp.asarray(a["q"]), jnp.asarray(a["kc"]), jnp.asarray(a["vc"]),
        jnp.asarray(a["valid"]),
        k_scale=None if a["ks"] is None else jnp.asarray(a["ks"]),
        v_scale=None if a["vs"] is None else jnp.asarray(a["vs"]),
    )
    got = tda.fused_decode_attention(
        _t(a["q"]), _t(a["kc"]), _t(a["vc"]), _t(a["valid"]),
        k_scale=None if a["ks"] is None else _t(a["ks"]),
        v_scale=None if a["vs"] is None else _t(a["vs"]),
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("case", [
    # (B, H, KH, L, Dh, valid, quant)
    ("mha", 2, 4, 4, 32, 16, [32, 7], False),
    ("gqa", 3, 6, 2, 24, 16, [1, 24, 13], False),
    ("int8_gqa", 2, 4, 2, 32, 32, [20, 3], True),
], ids=lambda c: c[0])
def test_fused_matches_pallas(case):
    _, B, H, KH, L, Dh, valid, quant = case
    a = _fused_inputs(B, H, KH, L, Dh, valid, seed=len(case[0]),
                      quant=quant)
    want, got = _run_fused(a)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_fused_valid_zero_is_uniform_mean(quant):
    """valid_len == 0: every Pallas score is NEG_INF, so p = exp(0) = 1 at
    every position and the output is the mean of v_scale * V over the
    whole panel, not zeros."""
    a = _fused_inputs(2, 4, 2, 16, 16, [0, 9], seed=5, quant=quant)
    want, got = _run_fused(a)
    vf = a["vc"].astype(np.float32)
    if quant:
        vf = vf * a["vs"][..., None]
    mean = vf[0].mean(axis=1)  # (KH, Dh)
    np.testing.assert_allclose(
        want[0].reshape(2, 2, 16), np.repeat(mean[:, None], 2, 1),
        atol=ATOL,
    )
    np.testing.assert_allclose(
        got, want, atol=ATOL, rtol=0,
        err_msg="fused kernel with valid_len == 0 must give the uniform "
        "mean of V over the panel (Pallas one-shot softmax over an "
        "all-NEG_INF row)",
    )


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 4, 16)
    kc = torch.zeros(2, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple of KH"):
        tda.fused_decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32))
    kc8 = torch.zeros(2, 2, 8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tda.fused_decode_attention(q, kc8, kc8,
                                   torch.zeros(2, dtype=torch.int32))
    pool = torch.zeros(2, 5, 4, 16)
    with pytest.raises(ValueError, match="block_tables"):
        tda.paged_decode_attention(q, pool, pool,
                                   torch.zeros(3, 2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="MAX_VERIFY_T"):
        tda.paged_decode_attention(
            torch.zeros(2, 17, 4, 16), pool, pool,
            torch.zeros(2, 2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
        )
