"""The port's TransformerLM and lm_generate against the JAX package's, on
Flax parameters carried across by ``params_from_flax``.

Geometry: the serving tier's tiny model (2 layers, d_model 64, 4 heads,
2 kv heads, rope) in float32 on the CPU.  The JAX fused-decode kernels
run in Pallas interpret mode, as the JAX package's own tests run them.
Tolerances: logits atol 1e-4 (float32 through two blocks of O(1)
activations, sums taken in another order); generated tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import lm_generate as jax_generate
from chainermn_tpu_torch.models import TransformerLM, lm_generate
from chainermn_tpu_torch.models import transformer as tt
from chainermn_tpu_torch.utils import params_from_flax

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

LOGIT_ATOL = 1e-4
KW = dict(vocab=128, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=96, n_kv_heads=2, pos_enc="rope")


_PARAMS = {}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(**over):
    """A JAX model with Flax params, and the port's model carrying the
    same weights.  The decode knobs do not change the parameter tree, so
    params are made once per (pos_enc, n_kv_heads)."""
    kw = {**KW, **over}
    jm = JaxLM(**kw, dtype=jnp.float32)
    key = (kw["pos_enc"], kw["n_kv_heads"])
    if key not in _PARAMS:
        p = jax.jit(jm.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))
        _PARAMS[key] = jax.tree_util.tree_map(np.asarray, p["params"])
    params = _PARAMS[key]
    tkw = dict(kw)
    if tkw.get("kv_dtype") is not None:
        tkw["kv_dtype"] = torch.int8
    tm = TransformerLM(**tkw, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def rope_pair():
    return _pair()


def _apply(jm, params, *args, **kw):
    """``jm.apply`` under one ``jax.jit`` (eager Flax dispatch compiles
    every primitive separately and is far slower on the CPU)."""
    return jax.jit(lambda p, a, k: jm.apply({"params": p}, *a, **k))(
        params, args, kw)


def _generate(jm, params, prompt, n_new, **kw):
    return np.asarray(jax.jit(
        lambda p, x, k: jax_generate(jm, p, x, n_new, **k)
    )(params, jnp.asarray(prompt), kw))


def _tokens(B, T, seed=0):
    return np.random.RandomState(seed).randint(1, 128, size=(B, T)) \
        .astype(np.int32)


def test_bridge_maps_every_parameter(rope_pair):
    _, params, tm = rope_pair
    sd = params_from_flax(params, device="cpu")
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(np.asarray(a).size
                 for a in jax.tree_util.tree_leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_flax


def test_full_forward_matches_xla(rope_pair):
    jm, params, tm = rope_pair
    toks = _tokens(2, 11)
    want = np.asarray(_apply(jm.clone(attention="xla"), params,
                             jnp.asarray(toks)))
    got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_learned_positions_match():
    jm, params, tm = _pair(pos_enc="learned", n_kv_heads=0)
    toks = _tokens(2, 9, seed=1)
    want = np.asarray(_apply(jm, params, jnp.asarray(toks)))
    np.testing.assert_allclose(tm(torch.from_numpy(toks)).numpy(), want,
                               atol=LOGIT_ATOL, rtol=0)
    want = _generate(jm, params, toks[:, :5], 5)
    got = lm_generate(tm, torch.from_numpy(toks[:, :5]), 5).numpy()
    np.testing.assert_array_equal(got, want)


def _paged_pools(model_kv_heads, head_dim, n_layers, nb, bl, quant, xp):
    shape = (model_kv_heads, nb, bl, head_dim)
    out = []
    for _ in range(n_layers):
        if quant:
            out.append({"k": xp.zeros(shape, "int8"),
                        "v": xp.zeros(shape, "int8"),
                        "k_scale": xp.zeros(shape[:3], "float32"),
                        "v_scale": xp.zeros(shape[:3], "float32")})
        else:
            out.append({"k": xp.zeros(shape, "float32"),
                        "v": xp.zeros(shape, "float32")})
    return out


class _TorchZeros:
    @staticmethod
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("layout,quant", [
    ("einsum", False), ("fused", False), ("paged", False),
    ("fused", True), ("paged", True),
])
def test_decode_step_logits_match(layout, quant):
    """Prefill a (2, 6) prompt, then one decode step at position 6: the
    step's logits agree on every cache layout (paged and fused steps go
    through the decode kernels' plain versions here)."""
    over = dict(decode_attention="einsum" if layout == "einsum" else "fused")
    if quant:
        over["kv_dtype"] = jnp.int8
    jm, params, tm = _pair(**over)
    toks = _tokens(2, 7, seed=2)
    prompt, nxt = toks[:, :6], toks[:, 6:]
    P = jnp.asarray(prompt)
    if layout == "paged":
        KH, Dh, BL = 2, 16, 4
        tbl = np.asarray([[3, 1, 0, 0], [2, 4, 0, 0]], np.int32)
        jc = _paged_pools(KH, Dh, 2, 6, BL, quant, jnp)
        tc = _paged_pools(KH, Dh, 2, 6, BL, quant, _TorchZeros)
        _, jc = _apply(jm, params, P, cache=jc, decode_pos=0,
                       block_tables=jnp.asarray(tbl))
        want, _ = _apply(jm, params, jnp.asarray(nxt), cache=jc,
                         decode_pos=jnp.asarray([6, 6]),
                         block_tables=jnp.asarray(tbl),
                         slot_mask=jnp.asarray([True, True]))
        tt_tbl = torch.from_numpy(tbl)
        tm(torch.from_numpy(prompt), cache=tc, decode_pos=0,
           block_tables=tt_tbl)
        got, _ = tm(torch.from_numpy(nxt), cache=tc,
                    decode_pos=torch.tensor([6, 6]), block_tables=tt_tbl,
                    slot_mask=torch.tensor([True, True]))
    else:
        jc = jm.init_cache(2, 8)
        _, jc = _apply(jm, params, P, cache=jc, decode_pos=0)
        want, _ = _apply(jm, params, jnp.asarray(nxt), cache=jc,
                         decode_pos=6)
        tc = tm.init_cache(2, 8)
        tm(torch.from_numpy(prompt), cache=tc, decode_pos=0)
        got, _ = tm(torch.from_numpy(nxt), cache=tc, decode_pos=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("over", [
    dict(decode_attention="einsum"),
    dict(decode_attention="fused"),
    dict(decode_attention="fused", kv_dtype=jnp.int8),
], ids=["einsum", "fused", "fused_int8"])
def test_greedy_generate_tokens_match(over):
    jm, params, tm = _pair(**over)
    prompt = _tokens(2, 6, seed=3)
    want = _generate(jm, params, prompt, 6)
    got = lm_generate(tm, torch.from_numpy(prompt), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_ragged_prompts_match(rope_pair):
    jm, params, tm = rope_pair
    prompt = _tokens(2, 7, seed=4)
    lens = np.asarray([4, 7], np.int32)
    want = _generate(jm, params, prompt, 4,
                     prompt_lengths=jnp.asarray(lens))
    got = lm_generate(tm, torch.from_numpy(prompt), 4,
                      prompt_lengths=torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded_and_top_k_one_is_greedy(rope_pair):
    _, _, tm = rope_pair
    prompt = torch.from_numpy(_tokens(2, 5, seed=5))

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return lm_generate(tm, prompt, 6, temperature=0.9, generator=g,
                           **kw)

    assert torch.equal(sample(1), sample(1))
    assert torch.equal(sample(1, top_k=1), lm_generate(tm, prompt, 6))
    assert torch.equal(sample(2, top_p=1e-6), lm_generate(tm, prompt, 6))


def test_unported_paths_raise():
    """The rolling ring cache's own checks still raise, with the JAX
    package's ValueErrors: a window-free model, and a window model on the
    fused (kv-head-major) cache, whose layout the ring does not serve.
    (The ring itself is held against the JAX package in
    ``test_torch_decoding.py``.)"""
    prompt = torch.zeros((1, 4), dtype=torch.long)
    tm = TransformerLM(**KW, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError,
                       match=r"rolling=True needs a sliding-window model"):
        lm_generate(tm, prompt, 2, rolling=True)
    fused = TransformerLM(**{**KW, "window": 8, "decode_attention": "fused"},
                          dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError,
                       match=r"rolling=True requires "
                             r"decode_attention='einsum'"):
        lm_generate(fused, prompt, 2, rolling=True)


# ----------------------------------------------------------------- traps
def test_trap_layernorm_eps(rope_pair):
    """Flax's LayerNorm uses eps 1e-6, torch's default is 1e-5: on
    low-variance rows the two differ well above float32 noise."""
    import flax.linen as fnn

    x = np.random.RandomState(6).randn(3, 64).astype(np.float32) * 2e-3
    ln = fnn.LayerNorm(dtype=jnp.float32)
    p = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ln.apply(p, jnp.asarray(x)))
    got = tt._layer_norm(torch.from_numpy(x),
                         torch.nn.LayerNorm(64), torch.float32).numpy()
    assert np.abs(got - want).max() < 1e-4, (
        "LayerNorm eps trap: the port must use Flax's eps 1e-6, not "
        f"torch's 1e-5 (max diff {np.abs(got - want).max():.3g})"
    )


def test_trap_tanh_gelu(rope_pair):
    """``flax.linen.gelu`` is the tanh approximation; torch's default GELU
    is exact.  The FFN of block 0 must equal Dense -> tanh-GELU -> Dense
    on the bridged weights."""
    import flax.linen as fnn

    _, params, tm = rope_pair
    b = params["block_0"]
    x = np.random.RandomState(7).randn(2, 3, 64).astype(np.float32) * 3.0
    h = jnp.asarray(x) @ b["ff1"]["kernel"] + b["ff1"]["bias"]
    want = np.asarray(fnn.gelu(h) @ b["ff2"]["kernel"] + b["ff2"]["bias"])
    got = tm.blocks[0].ffn(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < 1e-4, (
        "GELU trap: flax.linen.gelu is the tanh approximation; the port "
        "must not use torch's exact GELU (max diff "
        f"{np.abs(got - want).max():.3g})"
    )


def test_trap_fp32_head():
    """The LM head runs in float32 even under bf16 compute: fed the JAX
    bf16 model's own hidden states, the port's head must reproduce its
    logits to float32 accuracy, which a bf16 head cannot."""
    jm, params, tm = _pair(pos_enc="rope")
    jm = jm.clone(dtype=jnp.bfloat16)
    toks = jnp.asarray(_tokens(2, 6, seed=8))
    h = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                      return_hidden=True))(params, toks)
    want = np.asarray(_apply(jm, params, toks))
    h_t = torch.from_numpy(np.array(h.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = tm.head(h_t)
    assert got.dtype == torch.float32, "LM head trap: logits must be fp32"
    assert np.abs(got.numpy() - want).max() < 1e-4, (
        "fp32 head trap: the LM head (and the engine's prefill head) must "
        "run in float32, not the compute dtype (max diff "
        f"{np.abs(got.numpy() - want).max():.3g})"
    )
