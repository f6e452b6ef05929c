"""The port's LoRA against the JAX package's, on the Transformer LM and the
seq2seq Transformer, base weights and adapters carried across by the
bridges.

Geometry: LM 2 layers, d_model 32, 4 heads, vocab 64, T 16; seq2seq 1 + 1
layers, d_model 32, 4 heads; rank 4; float32 on the CPU.  Tolerances:
adapter shapes and counts exactly; the merged weights within 1e-6 of the
JAX leaf's largest magnitude (one product of rank 4 and an add); loss and
adapter gradients within 1e-5 of it (float32 through two blocks); the
zero-``b`` start exactly the base model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import TransformerSeq2Seq as JaxS2S
from chainermn_tpu.models import lm_loss as jax_lm_loss
from chainermn_tpu.models.lora import _split_shape as jax_split_shape
from chainermn_tpu.models.lora import lora_init as jax_lora_init
from chainermn_tpu.models.lora import lora_merge as jax_lora_merge
from chainermn_tpu.models.lora import make_lora_loss as jax_make_lora_loss
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.models import (
    DEFAULT_TARGETS,
    TransformerLM,
    TransformerSeq2Seq,
    lm_loss,
    lora_init,
    lora_merge,
    lora_param_count,
    make_lora_loss,
)
from chainermn_tpu_torch.optimizers import adamw, create_multi_node_optimizer
from chainermn_tpu_torch.utils import (
    lora_params_from_flax,
    lora_params_to_flax,
    params_from_flax,
    params_to_flax,
    seq2seq_params_from_flax,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

LM = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=16)
RANK = 4


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _lm(**over):
    kw = {**LM, **over}
    jm = JaxLM(**kw, dtype=jnp.float32, attention="xla")
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TransformerLM(**kw, dtype=torch.float32, attention="xla",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


def _adapters(params, seed=1):
    """The JAX adapter tree with a nonzero ``b`` (so that merges move)."""
    lora = jax_lora_init(jax.random.PRNGKey(seed), params, rank=RANK)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if x.shape[0] != RANK else
        (0.1 * rng.randn(*x.shape)).astype(np.float32), lora)


def _frozen(tm, pl):
    """The base's own parameters (the adapters also sit in its
    parametrizations)."""
    ours = {id(p) for p in pl.parameters()}
    return [p for p in tm.parameters() if id(p) not in ours]


def _port_lora(tm, lora):
    pl = lora_init(tm, RANK)
    pl.load_state_dict(lora_params_from_flax(lora, device="cpu"))
    return pl


def test_init_shapes_counts_and_zero_start():
    jm, params, tm = _lm(n_kv_heads=2)
    want = _flat(jax_lora_init(jax.random.PRNGKey(1), params, rank=RANK))
    pl = lora_init(tm, RANK)
    got = _flat(lora_params_to_flax(dict(pl.named_parameters())))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert lora_param_count(pl) == sum(v.size for v in want.values())
    assert [n for n, _ in pl.named_parameters()] == \
        [f"adapters.{p}.{ab}" for p in pl.paths for ab in "ab"]
    assert all(not p.requires_grad for p in _frozen(tm, pl))
    for path in pl.paths:  # GQA: the split q and kv projections
        name = path.rsplit(".", 1)[-1]
        lin = tm.get_submodule(path)
        flax = np.asarray(_flat(params)[path.replace("blocks.", "block_")
                                        .replace(".", "/") + "/kernel"])
        assert jax_split_shape(name, flax.shape) == (lin.in_features,
                                                     lin.out_features)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 16)))
    with torch.no_grad():
        torch.testing.assert_close(pl(toks), tm(toks), rtol=0, atol=0)
    with pytest.raises(ValueError, match="rank"):
        lora_init(tm, 0)
    with pytest.raises(ValueError, match="no nn.Linear"):
        lora_init(tm, 2, targets=("nope",))


def test_merge_matches_jax():
    _, params, tm = _lm()
    lora = _adapters(params)
    merged = lora_merge(_port_lora(tm, lora))
    want = _flat(jax_lora_merge(params, lora))
    got = _flat(params_to_flax(dict(merged.named_parameters()),
                               LM["n_heads"]))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-6)
    assert DEFAULT_TARGETS == ("qkv", "q", "kv", "proj")


def test_seq2seq_head_named_proj_clamps_like_jax():
    kw = dict(vocab_src=20, vocab_tgt=24, d_model=32, n_heads=4, d_ff=64,
              n_enc=1, n_dec=1, max_len=16)
    jm = JaxS2S(**kw, dtype=jnp.float32, attention="xla")
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TransformerSeq2Seq(**kw, attention="xla", device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(params, device="cpu"))
    lora = _adapters(params)
    pl = _port_lora(tm, lora)
    assert sorted(pl.paths) == ["dec.0.qkv", "enc.0.proj", "enc.0.qkv",
                                "proj"]
    merged = dict(lora_merge(pl).named_parameters())
    want = jax_lora_merge(params, lora)
    _close(merged["proj.weight"].detach().numpy().T, want["proj"]["kernel"],
           1e-6)
    _close(merged["enc.0.proj.weight"].detach().numpy().T,
           np.asarray(want["enc_0"]["proj"]["kernel"]).reshape(32, 32), 1e-6)


def test_gradients_only_on_adapters_and_equal_jax():
    jm, params, tm = _lm()
    lora = _adapters(params)
    pl = _port_lora(tm, lora)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 64, (2, 16)).astype(np.int32)
    tgts = rng.randint(0, 64, (2, 16)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jax_make_lora_loss(jax_lm_loss(jm), params), has_aux=True))(
        lora, (toks, tgts))
    loss, _ = make_lora_loss(lm_loss(tm))(pl, (toks, tgts))
    loss.backward()
    _close(loss.detach(), jl, 1e-5)
    assert all(p.grad is None for p in _frozen(tm, pl))
    got = _flat(lora_params_to_flax(
        {n: p.grad for n, p in pl.named_parameters()}))
    want = _flat(jg)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_train_step_updates_adapters_only():
    _, _, tm = _lm(remat=True)
    pl = lora_init(tm, RANK)
    frozen = [(p, p.clone()) for p in _frozen(tm, pl)]
    comm = create_communicator("xla", device="cpu")
    opt = create_multi_node_optimizer(adamw(1e-2), comm)
    state = opt.init(pl)
    assert {id(p) for g in state.optimizer.param_groups
            for p in g["params"]} == {id(p) for p in pl.parameters()}
    step = opt.make_train_step(make_lora_loss(lm_loss(tm)), has_aux=True)
    rng = np.random.RandomState(3)
    batch = (rng.randint(0, 64, (4, 16)), rng.randint(0, 64, (4, 16)))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]
    for p, before in frozen:
        torch.testing.assert_close(p, before, rtol=0, atol=0)
    assert float(pl.adapter("blocks.0.qkv").b.detach().abs().sum()) > 0


def test_train_lm_lora_runs_on_cpu(capsys):
    from chainermn_tpu_torch.examples import train_lm

    loss = train_lm.main(["--device", "cpu", "--steps", "3", "--seq-len",
                          "32", "--batch-per-chip", "4", "--d-model", "32",
                          "--lora", "4", "--eval", "--generate", "8"])
    out = capsys.readouterr().out
    assert "lora rank 4:" in out and "val_ppl" in out and "generated:" in out
    assert np.isfinite(loss)
