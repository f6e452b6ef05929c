"""The port's mixture-of-experts TransformerLM, its routing and the
chunked LM-head loss against the JAX package, on Flax parameters carried
across by ``params_from_flax``.

Geometry: 2 layers, d_model 32, 2 heads, 4 experts of width 48, vocab
64, float32 on the CPU; a routing group of 16 tokens, so that every
forward routes several groups, and capacity factors that drop routings.
Tolerances: routing masks and first choices exactly (the same argmax
picks, the same integer slot counts); combine weights 1e-6 (a quotient of
fp32 gates); logits, losses and gradients atol 1e-5 (float32 through two
blocks, sums in another order); the sown statistics 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import lm_generate as jax_generate
from chainermn_tpu.models import lm_loss as jax_lm_loss
from chainermn_tpu.models import lm_loss_chunked as jax_lm_loss_chunked
from chainermn_tpu.ops import chunked_softmax_cross_entropy as jax_cce
from chainermn_tpu.parallel.moe import _topk_dispatch as jax_dispatch
from chainermn_tpu_torch.models import (
    TransformerLM,
    lm_generate,
    lm_loss,
    lm_loss_chunked,
    moe_stats,
)
from chainermn_tpu_torch.ops import chunked_softmax_cross_entropy
from chainermn_tpu_torch.parallel.moe import _topk_dispatch
from chainermn_tpu_torch.utils import params_from_flax, params_to_flax

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

ATOL = 1e-5
MOE = dict(vocab=64, n_layers=2, d_model=32, n_heads=2, d_ff=48, max_len=32,
           n_experts=4, moe_group=16)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_PARAMS = {}


def _pair(**over):
    """A JAX MoE model with Flax params and the port's model carrying the
    same weights (params made once per parameter-shape key)."""
    kw = {**MOE, **over}
    jm = JaxLM(**kw, dtype=jnp.float32, attention="xla")
    key = (kw["pos_enc"] if "pos_enc" in kw else "learned",)
    if key not in _PARAMS:
        p = jax.jit(jm.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))
        _PARAMS[key] = jax.tree_util.tree_map(np.asarray, p["params"])
    params = _PARAMS[key]
    tm = TransformerLM(**kw, dtype=torch.float32, attention="xla",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


def _tokens(B, T, seed=0, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)) \
        .astype(np.int32)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("case", ["random", "ties"])
def test_topk_dispatch_matches_jax(case):
    """Three groups of 16 tokens over 4 experts, capacity 5, top-2: the
    same slots, the same drops, the same first choices.  ``ties`` gives
    every token a tied pair of experts: the first maximum must win on
    both sides."""
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 16, 4).astype(np.float32)
    if case == "ties":
        logits[..., 2] = logits[..., 1]
        logits[:, ::2] = 0.0  # whole rows tied across all experts
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = jax.vmap(lambda p: jax_dispatch(p, 5, 2))(jnp.asarray(probs))
    got = _topk_dispatch(torch.from_numpy(probs.copy()), 5, 2)
    d_w, c_w, f_w = (np.asarray(x) for x in want)
    d_g, c_g, f_g = (x.numpy() for x in got)
    np.testing.assert_array_equal(d_g, d_w)
    np.testing.assert_array_equal(f_g, f_w)
    np.testing.assert_allclose(c_g, c_w, atol=1e-6, rtol=0)
    assert 0 < d_w.sum() < 3 * 16 * 2  # some routings dropped, not all


# ------------------------------------------------------------------ model
def _jax_apply(jm, params, toks, **kw):
    return jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                         mutable=["intermediates"], **kw)
                   )(params, jnp.asarray(toks))


def _jax_stats(mut):
    flat = _flat(mut["intermediates"])
    aux = [v for k, v in flat.items() if "moe_aux" in k]
    drop = [v for k, v in flat.items() if "moe_dropped" in k]
    return float(np.mean(aux)), float(np.mean(drop))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_forward_and_stats_match_jax(cf):
    jm, params, tm = _pair(moe_capacity_factor=cf)
    toks = _tokens(2, 24, seed=2)  # N = 48: three groups of 16
    want, mut = _jax_apply(jm, params, toks)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    aux_w, drop_w = _jax_stats(mut)
    aux_g, drop_g = (float(x) for x in moe_stats(tm))
    assert abs(aux_g - aux_w) <= 1e-6 and abs(drop_g - drop_w) <= 1e-6
    assert drop_w > 0.0  # the capacity race drops routings at both cfs


@pytest.mark.parametrize("chunked", [False, True], ids=["lm_loss",
                                                        "lm_loss_chunked"])
def test_moe_loss_and_gradients_match_jax(chunked):
    """The loss with its aux term and every gradient leaf, the router's
    included; ``lm_loss_chunked`` at chunk 24 over vocab 64 (a ragged
    tail of 16) with an ignored target per row."""
    jm, params, tm = _pair(moe_capacity_factor=0.5)
    toks = _tokens(2, 24, seed=3)
    tgts = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)],
                          axis=1)
    jfn = jax_lm_loss_chunked(jm, chunk_size=24) if chunked \
        else jax_lm_loss(jm)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, (toks, tgts)), has_aux=True))(params)
    tfn = lm_loss_chunked(tm, chunk_size=24) if chunked else lm_loss(tm)
    tl, tmet = tfn(tm, (torch.from_numpy(toks), torch.from_numpy(tgts)))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= ATOL
    for k in ("ppl_log", "moe_aux", "moe_dropped"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-6, k
    grads = _flat(params_to_flax({n: p.grad for n, p in
                                  tm.named_parameters()}, n_heads=2))
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert set(grads) == set(want)
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    assert np.abs(grads["block_0/router"]).sum() > 0


def test_moe_decode_prefill_matches_full_forward():
    """Eight single-token decode steps reproduce the full forward's
    logits (the JAX test's property), and match the JAX decode steps."""
    jm, params, tm = _pair()
    toks = _tokens(2, 8, seed=4)
    with torch.no_grad():
        full = tm(torch.from_numpy(toks))
        cache = tm.init_cache(2, 8)
        steps = []
        for i in range(8):
            lg, cache = tm(torch.from_numpy(toks[:, i:i + 1]), cache=cache,
                           decode_pos=i)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=ATOL, rtol=0)
    jc = jm.init_cache(2, 8)
    step = jax.jit(lambda p, x, c, i: jm.apply({"params": p}, x, cache=c,
                                               decode_pos=i))
    for i in range(8):
        want, jc = step(params, jnp.asarray(toks[:, i:i + 1]), jc, i)
        np.testing.assert_allclose(steps[i].numpy(), np.asarray(want)[:, 0],
                                   atol=ATOL, rtol=0)


def test_moe_generate_matches_jax_fused():
    """Greedy generation of the MoE model on the kv-major cache (the JAX
    side's fused decode kernel in Pallas interpret mode, the port's plain
    version): the same tokens, decode-time drops included (N = 2 tokens
    per step routed with capacity 1)."""
    jm, params, tm = _pair(decode_attention="fused", max_len=32)
    prompt = _tokens(2, 6, seed=5)
    want = np.asarray(jax.jit(lambda p, x: jax_generate(jm, p, x, 6))(
        params, jnp.asarray(prompt)))
    got = lm_generate(tm, torch.from_numpy(prompt), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_bridge_round_trip_and_init():
    """Flax -> port -> Flax returns every leaf; the port's own init draws
    the JAX initializers' distributions (router std 0.02, experts
    lecun-normal truncated at two standard deviations)."""
    _, params, tm = _pair()
    back = _flat(params_to_flax(dict(tm.named_parameters()), n_heads=2))
    want = _flat(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    big = TransformerLM(vocab=16, n_layers=1, d_model=64, n_heads=2,
                        d_ff=128, max_len=8, n_experts=8, device="cpu",
                        seed=3)
    blk = big.blocks[0]
    assert abs(blk.router.std().item() - 0.02) < 2e-3
    assert blk.router.dtype == torch.float32
    for w, fan_in in ((blk.moe_w1, 64), (blk.moe_w2, 128)):
        std = 1 / np.sqrt(fan_in)
        assert abs(w.std().item() - std) < 0.05 * std
        assert w.abs().max().item() <= 2 * std / .87962566103423978 + 1e-6


# ------------------------------------------------------------- chunked CE
def _ce_case(n=24, d=16, v=100, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32) * 0.3
    b = rng.normal(size=(v,)).astype(np.float32) * 0.1
    t = rng.randint(0, v, size=(n,)).astype(np.int32)
    t[::3] = -1
    return h, w, b, t


@pytest.mark.parametrize("chunk,bias", [(16, True), (32, False),
                                        (100, True), (4096, True)])
def test_chunked_ce_matches_jax(chunk, bias):
    """Values and gradients of hidden, weight and bias, leading dims
    (4, 6), a third of the targets ignored, ragged tails (100 % 16, 100 %
    32) and a chunk wider than the vocab."""
    h, w, b, t = _ce_case()
    h3, t3 = h.reshape(4, 6, -1), t.reshape(4, 6)

    def jloss(h, w, b):
        ce = jax_cce(h, w, jnp.asarray(t3), bias=b if bias else None,
                     chunk_size=chunk)
        return ce.sum() / 24, ce

    (_, jce), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(h3, w, b)
    th = torch.from_numpy(h3).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()  # (V, D)
    tb = torch.from_numpy(b).requires_grad_()
    ce = chunked_softmax_cross_entropy(th, tw, torch.from_numpy(t3),
                                       bias=tb if bias else None,
                                       chunk_size=chunk)
    (ce.sum() / 24).backward()
    assert tuple(ce.shape) == (4, 6)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(jce),
                               atol=ATOL, rtol=0)
    assert (ce.detach().numpy().reshape(-1)[::3] == 0).all()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg[0]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jg[1]),
                               atol=ATOL, rtol=0)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]),
                                   atol=ATOL, rtol=0)
    else:
        assert tb.grad is None


def test_chunked_ce_all_ignored_and_validation():
    h, w, b, t = _ce_case()
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w.T.copy())
    ce = chunked_softmax_cross_entropy(th, tw, torch.full((24,), -1),
                                       bias=torch.from_numpy(b),
                                       chunk_size=32)
    ce.sum().backward()
    assert (ce == 0).all() and (th.grad == 0).all()
    with pytest.raises(ValueError, match="chunk_size"):
        chunked_softmax_cross_entropy(th, tw, torch.zeros(24), chunk_size=0)
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        chunked_softmax_cross_entropy(th, tw[None], torch.zeros(24))


def test_lm_loss_chunked_matches_lm_loss_dense():
    """A dense model: the chunked loss equals the materialized one, and
    both equal the JAX package's chunked loss."""
    kw = dict(vocab=100, n_layers=2, d_model=32, n_heads=2, d_ff=64,
              max_len=16)
    jm = JaxLM(**kw, dtype=jnp.float32, attention="xla")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TransformerLM(**kw, dtype=torch.float32, attention="xla",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    toks = _tokens(2, 16, seed=6, vocab=100)
    batch = (torch.from_numpy(toks), torch.from_numpy(toks))
    lc, mc = lm_loss_chunked(tm, chunk_size=32)(tm, batch)
    lf, _ = lm_loss(tm)(tm, batch)
    jl, _ = jax.jit(lambda p: jax_lm_loss_chunked(jm, chunk_size=32)(
        p, (toks, toks)))(params)
    assert abs(lc.item() - lf.item()) <= ATOL
    assert abs(lc.item() - float(jl)) <= ATOL
    assert set(mc) == {"ppl_log"}  # a dense model reports no MoE keys
