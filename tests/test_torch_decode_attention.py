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


# ------------------------------------------------ the launch's split plan
# The CUDA kernels split each row's positions over the CTAs of a cluster
# (``tda._plan``).  The plan is a function of static shapes alone; these
# tests hold it to covering every position once, and hold the merge rule
# the kernels apply to the CTAs' partial softmax states to the Pallas
# kernels, by emulating the kernels' split-and-merge on the plain
# arithmetic.

@pytest.mark.parametrize("n_max,pairs,sms,align", [
    (240, 96, 132, 16), (4096, 96, 132, 16), (16384, 96, 132, 16),
    (192, 96, 132, 16), (100, 32, 132, 32), (17, 1, 132, 16),
    (1, 8, 132, 16), (240, 3000, 132, 16), (96, 24, 8, 8),
])
def test_split_plan_covers_every_position_once(n_max, pairs, sms, align):
    splits, per = tda._split_plan(n_max, pairs, sms, align)
    assert 1 <= splits <= tda.MAX_SPLITS
    assert per % align == 0 and per > 0
    covered = np.zeros(n_max, np.int64)
    for c in range(splits):
        lo, hi = c * per, min((c + 1) * per, n_max)
        assert lo < n_max, "a split starts past the row"
        covered[lo:hi] += 1
    assert np.all(covered == 1)


@pytest.mark.parametrize("BL,Dh,elt", [(16, 64, 2), (16, 64, 4),
                                       (16, 128, 4), (8, 16, 1),
                                       (32, 32, 2), (7, 64, 2),
                                       (64, 128, 2)])
def test_paged_plan_aligns_to_blocks(BL, Dh, elt):
    splits, per, chunk = tda._plan(15 * BL, 8, 12, 1, Dh * elt, 132,
                                   block_len=BL)
    assert per % BL == 0 and BL % chunk == 0
    assert chunk * Dh * elt <= tda.CHUNK_BYTES
    assert splits * per >= 15 * BL > (splits - 1) * per


def test_plan_takes_static_shapes_only():
    """The plan never sees valid_len or the tables, so one plan serves
    every length: a launch captured in a CUDA graph stays right after they
    change in place (the card test replays one)."""
    import inspect

    assert list(inspect.signature(tda._plan).parameters) == [
        "n_max", "rows_of", "KH", "R", "row_bytes", "sms", "block_len"]
    # More rows per kv head (verify chunks, GQA) take row blocks, which
    # count as pairs: fewer splits each.
    assert tda._plan(240, 8, 4, 48, 128, 132, block_len=16)[0] < \
        tda._plan(240, 8, 4, 1, 128, 132, block_len=16)[0]


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("elt", [1, 2, 4], ids=["int8", "bf16", "fp32"])
def test_bulk_copy_takes_every_supported_row(Dh, elt):
    tda._check_bulk_copy("k", 4096, Dh * elt)


def test_bulk_copy_refuses_what_it_cannot_move():
    with pytest.raises(ValueError, match="16-byte aligned"):
        tda._check_bulk_copy("k", 4096 + 8, 128)
    with pytest.raises(ValueError, match="multiples of 16"):
        tda._check_bulk_copy("v", 4096, 8 * 3)


def _split_merge(scores, vals, ok, vscale, plan_per, n_splits, uniform):
    """The kernels' split-and-merge for one query row: ``scores`` (P,),
    ``vals`` (P, Dh), ``ok`` (P,) the attendable positions.  Each split
    folds its positions into (m, l, acc); a split that saw none keeps m =
    NEG_INF and weighs 0 in the merge."""
    NEG = tda.NEG_INF
    parts = []
    for c in range(n_splits):
        sl = slice(c * plan_per, (c + 1) * plan_per)
        s = np.where(ok[sl], 0.0 if uniform else scores[sl], NEG)
        m = s.max(initial=NEG)
        p = np.where(ok[sl], np.exp(s - m), 0.0)
        parts.append((m, p.sum(), (p * vscale[sl])[:, None] * vals[sl]))
    M = max(m for m, _, _ in parts)
    w = [np.exp(m - M) if m > NEG else 0.0 for m, _, _ in parts]
    lsum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi * a.sum(0) for wi, (_, _, a) in zip(w, parts))
    return acc / max(lsum, 1e-30)


def _emulate_paged(a, BL, MB, sms=132):
    q = a["q"] if a["q"].ndim == 4 else a["q"][:, None]
    S, T, H, Dh = q.shape
    KH = a["kp"].shape[0]
    G = H // KH
    splits, per, _ = tda._plan(MB * BL, S, KH, T * G, Dh * 4, sms,
                               block_len=BL)
    out = np.zeros_like(q, dtype=np.float64)
    pos = np.arange(MB * BL)
    for s in range(S):
        blocks = a["tables"][s]
        k = a["kp"][:, blocks].reshape(KH, MB * BL, Dh).astype(np.float64)
        v = a["vp"][:, blocks].reshape(KH, MB * BL, Dh).astype(np.float64)
        ks = np.ones((KH, MB * BL)) if a["ks"] is None else \
            a["ks"][:, blocks].reshape(KH, MB * BL)
        vs = np.ones((KH, MB * BL)) if a["vs"] is None else \
            a["vs"][:, blocks].reshape(KH, MB * BL)
        for t in range(T):
            for h in range(H):
                kh = h // G
                sc = k[kh] @ (q[s, t, h] / np.sqrt(Dh)) * ks[kh]
                ok = pos < a["valid"][s] + t
                out[s, t, h] = _split_merge(sc, v[kh], ok, vs[kh], per,
                                            splits, False)
    return out if a["q"].ndim == 4 else out[:, 0]


def _emulate_fused(a, sms=132):
    B, H, Dh = a["q"].shape
    _, KH, L, _ = a["kc"].shape
    G = H // KH
    splits, per, _ = tda._plan(L, B, KH, G, Dh * 4, sms)
    out = np.zeros_like(a["q"], dtype=np.float64)
    for b in range(B):
        uniform = a["valid"][b] <= 0
        ok = np.arange(L) < (L if uniform else a["valid"][b])
        for h in range(H):
            kh = h // G
            k = a["kc"][b, kh].astype(np.float64)
            ks = np.ones(L) if a["ks"] is None else a["ks"][b, kh]
            vs = np.ones(L) if a["vs"] is None else a["vs"][b, kh]
            sc = k @ (a["q"][b, h] / np.sqrt(Dh)) * ks
            out[b, h] = _split_merge(sc, a["vc"][b, kh].astype(np.float64),
                                     ok, vs, per, splits, uniform)
    return out


@pytest.mark.parametrize("case", [
    # (S, T, H, KH, Dh, BL, MB, valid(per), quant, sms): an idle row,
    # lengths on and around the first split boundary (per positions),
    # verify rows straddling one, splits left empty.
    ("idle_and_boundaries", 4, 1, 4, 4, 16, 8, 8,
     lambda per: [0, per, per - 1, per + 1], False, 16),
    ("verify_straddles", 3, 3, 4, 2, 16, 8, 8,
     lambda per: [per - 2, 0, per - 1], False, 16),
    ("int8_verify_empty_splits", 2, 3, 4, 2, 16, 8, 8,
     lambda per: [1, per - 1], True, 16),
    ("gqa_many_rows", 2, 4, 6, 1, 16, 4, 10,
     lambda per: [3, per + 5], False, 132),
], ids=lambda c: c[0])
def test_split_merge_matches_pallas_paged(case):
    _, S, T, H, KH, Dh, BL, MB, lengths, quant, sms = case
    splits, per, _ = tda._plan(MB * BL, S, KH, T * (H // KH), Dh * 4, sms,
                               block_len=BL)
    assert splits > 1
    valid = lengths(per)
    a = _paged_inputs(S, T, H, KH, Dh, NB=S * MB + 1, BL=BL, MB=MB,
                      valid=valid, seed=len(case[0]), quant=quant)
    want, got = _run_paged(a)
    emulated = _emulate_paged(a, BL, MB, sms)
    np.testing.assert_allclose(emulated, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if T == 1:
        idle = [s for s in range(S) if valid[s] == 0]
        assert all(np.all(emulated[s] == 0.0) for s in idle)


@pytest.mark.parametrize("case", [
    # (B, H, KH, L, Dh, valid(per), quant, sms): valid <= 0 rows (the
    # uniform mean over every split), lengths on the split boundaries,
    # splits left empty.
    ("uniform_and_boundaries", 4, 4, 2, 48, 16,
     lambda per: [0, per, per + 1, -3], False, 16),
    ("int8_uniform", 3, 4, 2, 40, 32, lambda per: [0, 2 * per, 1], True,
     16),
    ("gqa_empty_splits", 2, 6, 2, 64, 16, lambda per: [5, 64], False, 16),
], ids=lambda c: c[0])
def test_split_merge_matches_pallas_fused(case):
    _, B, H, KH, L, Dh, lengths, quant, sms = case
    splits, per, _ = tda._plan(L, B, KH, H // KH, Dh * 4, sms)
    assert splits > 1
    valid = [min(v, L) for v in lengths(per)]
    a = _fused_inputs(B, H, KH, L, Dh, valid, seed=len(case[0]),
                      quant=quant)
    want, got = _run_fused(a)
    np.testing.assert_allclose(_emulate_fused(a, sms), want, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
