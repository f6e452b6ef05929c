"""The port's flash attention (its plain PyTorch versions, which the
wrappers run on the CPU) against the JAX package's Pallas kernels in
interpret mode, on the same seeded numpy inputs.

The JAX side runs with ``block_q = block_k = 16`` so that its kernels
really walk several blocks: the online softmax across kv blocks, the
block-skipping ranges of the causal and window masks, and the dK/dV and
dQ loops.  Both sides compute in float32; tolerance atol = rtol = 1e-5
(sums over at most 64 positions taken in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu_torch.ops import (
    flash_attention,
    flash_attention_lse,
    reference_attention,
    resolve_attention,
)

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

# The module, not the function of the same name that ``chainermn_tpu.ops``
# re-exports.
jfa = importlib.import_module("chainermn_tpu.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
LIVE = -1e29  # lse above this: a row with at least one admitted key


def _inputs(B, T, S, H, KH, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, KH, D).astype(np.float32)
    v = rng.randn(B, S, KH, D).astype(np.float32)
    wo = rng.randn(B, T, H, D).astype(np.float32)
    wl = rng.randn(B, H, T).astype(np.float32)
    return q, k, v, wo, wl


def _jax_run(fn, q, k, v, wo, wl, kw):
    """Forward ``(o, lse)`` and the gradients of a loss that reads both
    outputs (lse only on live rows: a dead row's lse is the -1e30 sentinel
    and carries no gradient)."""
    def loss(q, k, v):
        o, lse = fn(q, k, v, **kw)
        return (jnp.sum(o * wo)
                + jnp.sum(jnp.where(lse > LIVE, lse, 0.0) * wl)), (o, lse)

    (_, (o, lse)), grads = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o, lse, *grads)]


def _torch_run(fn, q, k, v, wo, wl, kw):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = fn(q, k, v, **kw)
    loss = (o * torch.from_numpy(wo)).sum() + (
        torch.where(lse > LIVE, lse, torch.zeros_like(lse))
        * torch.from_numpy(wl)).sum()
    loss.backward()
    return [x.detach().numpy() for x in (o, lse, q.grad, k.grad, v.grad)]


def _seg(rows, T):
    """Segment ids from per-row lists of (id, length) runs."""
    out = np.zeros((len(rows), T), np.int32)
    for r, runs in enumerate(rows):
        at = 0
        for sid, n in runs:
            out[r, at:at + n] = sid
            at += n
    return out


def _compare(got, want, names=("o", "lse", "dq", "dk", "dv")):
    for n, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, err_msg=n, **TOL)


# (name, B, T, S, H, KH, D, kwargs builder)
CASES = {
    "causal": (2, 48, 48, 4, 4, 16, lambda: dict(causal=True)),
    "noncausal": (2, 48, 48, 4, 4, 16, lambda: dict(causal=False)),
    "causal_window": (2, 48, 48, 4, 4, 16,
                      lambda: dict(causal=True, window=7)),
    "window": (1, 48, 48, 2, 2, 32, lambda: dict(window=20)),
    "packed_causal": (2, 48, 48, 4, 4, 16, lambda: dict(
        causal=True, segment_ids=_seg([[(1, 10), (2, 25), (3, 13)],
                                       [(5, 48)]], 48))),
    # kv segments that no query of segment 9 matches: fully masked rows.
    "packed_fully_masked": (2, 32, 32, 2, 2, 16, lambda: dict(
        segment_ids=_seg([[(1, 12), (9, 10), (2, 10)],
                          [(4, 32)]], 32),
        kv_segment_ids=_seg([[(1, 16), (2, 16)], [(4, 20), (0, 12)]], 32))),
    "cross_kv_segments": (2, 32, 48, 4, 4, 16, lambda: dict(
        segment_ids=_seg([[(1, 16), (2, 16)], [(1, 32)]], 32),
        kv_segment_ids=_seg([[(1, 20), (2, 20), (0, 8)],
                             [(1, 40), (0, 8)]], 48))),
    "cross": (1, 16, 48, 2, 2, 32, lambda: dict()),
    "gqa_causal": (2, 48, 48, 4, 2, 16, lambda: dict(causal=True)),
    "mqa_window": (1, 48, 48, 4, 1, 16, lambda: dict(causal=True,
                                                      window=9)),
    "gqa_packed": (1, 48, 48, 4, 2, 16, lambda: dict(
        causal=True, segment_ids=_seg([[(3, 30), (4, 18)]], 48))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_lse_and_grads_match_jax_kernels(name):
    B, T, S, H, KH, D, kw = CASES[name]
    kw = kw()
    arrs = _inputs(B, T, S, H, KH, D, seed=len(name))
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    want = _jax_run(
        lambda q, k, v, **a: jfa.flash_attention_lse(
            q, k, v, block_q=16, block_k=16, **a), *arrs, jkw)
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    got = _torch_run(flash_attention_lse, *arrs, tkw)
    _compare(got, want)
    if name == "packed_fully_masked":
        dead = got[1] < LIVE
        assert dead.any(), "the case must hold a fully masked row"
        assert np.all(got[1][dead] == -1e30)
        assert np.all(got[0].transpose(0, 2, 1, 3)[dead] == 0.0)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=5),
                                dict(segment_ids="packed")],
                         ids=["causal", "causal_window", "packed"])
def test_ragged_length_matches_jax_reference(kw):
    """T = 37 has no 16-row block: the JAX kernels reject it, the port's
    kernels take any length.  Held against the JAX oracle
    (``_reference_attention_lse``) forward and backward."""
    B, T, H, KH, D = 2, 37, 4, 2, 16
    arrs = _inputs(B, T, T, H, KH, D, seed=5)
    if kw.get("segment_ids") == "packed":
        kw = dict(causal=True, segment_ids=_seg(
            [[(1, 20), (2, 17)], [(7, 37)]], T))
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    want = _jax_run(jfa._reference_attention_lse, *arrs, jkw)
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    got = _torch_run(flash_attention_lse, *arrs, tkw)
    _compare(got, want)


def test_flash_attention_drops_lse():
    q, k, v, _, _ = _inputs(1, 32, 32, 2, 2, 16, seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    o = flash_attention(*args, causal=True)
    o2, _ = flash_attention_lse(*args, causal=True)
    assert torch.equal(o, o2)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False, window=6),
    dict(causal=True, segment_ids="packed"),
    dict(kv_segment_ids="pad"),
], ids=["causal", "window", "packed", "kv_pad"])
def test_reference_attention_matches_jax(kw):
    B, T, H, KH, D = 2, 24, 4, 2, 16
    q, k, v, _, _ = _inputs(B, T, T, H, KH, D, seed=11)
    if kw.get("segment_ids") == "packed":
        kw = dict(kw, segment_ids=_seg([[(1, 9), (2, 15)], [(3, 24)]], T))
    if kw.get("kv_segment_ids") == "pad":
        kw = dict(kv_segment_ids=_seg([[(0, 20), (5, 4)],
                                       [(0, 24)]], T))
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    tkw = {key: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    want = np.asarray(jfa.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    got = reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              **tkw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# The JAX package's own ValueError cases (tests/ops_tests/
# test_flash_attention.py) raise in the port too, with the same messages.
def _bad_cases():
    z = np.zeros
    return {
        "causal_cross": ((z((1, 16, 2, 8)), z((1, 32, 2, 8)),
                          z((1, 32, 2, 8))), dict(causal=True),
                         "causal attention needs equal"),
        "heads": ((z((1, 16, 4, 8)), z((1, 16, 3, 8)), z((1, 16, 3, 8))),
                  {}, "must be a multiple of kv heads"),
        "kv_shape": ((z((1, 16, 2, 8)), z((1, 16, 2, 8)), z((1, 8, 2, 8))),
                     {}, "k/v must be"),
        "window_zero": ((z((1, 16, 2, 8)),) * 3, dict(window=0),
                        "window must be >= 1"),
        "window_cross": ((z((1, 16, 2, 8)), z((1, 32, 2, 8)),
                          z((1, 32, 2, 8))), dict(window=4),
                         "sliding-window attention needs equal"),
        "seg_shape": ((z((1, 16, 2, 8)),) * 3,
                      dict(segment_ids=z((1, 15), np.int32)),
                      "segment_ids must be"),
        "kv_seg_shape": ((z((1, 16, 2, 8)),) * 3,
                         dict(kv_segment_ids=z((1, 12), np.int32)),
                         "kv_segment_ids must be"),
        "cross_seg": ((z((1, 16, 2, 8)), z((1, 32, 2, 8)),
                       z((1, 32, 2, 8))),
                      dict(segment_ids=z((1, 16), np.int32)),
                      "needs explicit kv_segment_ids"),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_bad_shapes_raise_like_jax(case):
    arrays, kw, match = _bad_cases()[case]
    jkw = {key: jnp.asarray(x) for key, x in kw.items()
           if isinstance(x, np.ndarray)}
    jkw.update({key: x for key, x in kw.items()
                if not isinstance(x, np.ndarray)})
    with pytest.raises(ValueError, match=match):
        jfa.flash_attention(*(jnp.asarray(a.astype(np.float32))
                              for a in arrays), block_q=8, block_k=8, **jkw)
    tkw = {key: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for key, x in kw.items()}
    with pytest.raises(ValueError, match=match):
        flash_attention(*(torch.from_numpy(a.astype(np.float32))
                          for a in arrays), **tkw)


def test_resolve_attention_auto_follows_the_device():
    assert resolve_attention("auto", device="cpu") == "xla"
    assert resolve_attention("auto", device="cuda") == "flash"
    assert resolve_attention("xla", device="cuda") == "xla"
    assert resolve_attention("flash", device="cpu") == "flash"
    with pytest.raises(ValueError, match="expected 'flash'"):
        resolve_attention("pallas")
