"""The port's ZeRO tier (``optimizers/zero.py``) and its checkpoints
against the JAX package's tests of the same tier
(``tests/optimizer_tests/test_zero_optimizer.py``,
``tests/extensions_tests/test_checkpoint_zero.py`` and
``test_checkpoint_elastic.py``).

One job of four gloo ranks (``torch_rank_bodies.zero``) starts from the
JAX tests' Flax parameters (carried across with the bridge) and batches
and runs every case; elastic restores save at 4 ranks and resume at 2
(ranks {0, 1}) or the other way round.  The oracles are the JAX tests':
plain optax on one device over the same global batches.  Tolerances are
the JAX tests' (3e-5 for the oracles, 5e-2 for the bf16 wire, 3e-6 for
the clip, 1e-5 for the schedule, 0.1 for the bf16-storage LM under
Adafactor, 1e-6 for the round trip, 2e-5 and 5e-5 for the elastic
restores).  The bf16-storage MoE LM has one layer where the JAX test has
two (its oracle's compile is the file's longest pole).  A state is carried over from the JAX ZeRO tier on 4 of the
forced CPU devices, stepped once here, and carried back: it must match
the JAX tier's own step (1e-6).
"""

import pickle
import warnings

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

import chainermn_tpu as cmn
from chainermn_tpu.datasets import make_synthetic_classification
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import classification_loss as jax_cls_loss
from chainermn_tpu.models import lm_loss as jax_lm_loss

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 4
LM_KW = dict(vocab=128, n_layers=1, d_model=32, n_heads=4, d_ff=64,
             max_len=32, n_experts=4)


def _mlp(hidden, n_out, n_in):
    model = JaxMLP(hidden=hidden, n_out=n_out)
    p = model.init(jax.random.PRNGKey(0), np.zeros((1, n_in), np.float32))
    return model, jax.tree_util.tree_map(np.asarray, p["params"])


def _batches(n, bs, dim, seed=0):
    x, y = make_synthetic_classification(n=n * bs, dim=dim, seed=seed).arrays
    return [(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
            for i in range(n)]


_GRADS = {}


def _grad_fn(model, loss):
    """One jitted gradient per model (the oracles share it)."""
    if model not in _GRADS:
        _GRADS[model] = jax.jit(jax.grad(
            lambda p, b: loss(model)(p, b)[0]))
    return _GRADS[model]


def _oracle(model, params, tx, batches, loss=jax_cls_loss):
    grad, update = _grad_fn(model, loss), jax.jit(tx.update)
    opt_state, p = tx.init(params), params
    for b in batches:
        up, opt_state = update(grad(p, b), opt_state, p)
        p = optax.apply_updates(p, up)
    return p


def _close(got, want, atol, rtol=None):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=atol if rtol is None else rtol)


TXS = {"sgd": lambda: optax.sgd(0.1),
       "sgd_momentum": lambda: optax.sgd(0.1, momentum=0.9),
       "momentum_nesterov": lambda: optax.sgd(0.1, momentum=0.9,
                                              nesterov=True),
       "adam": lambda: optax.adam(1e-2),
       "adamw": lambda: optax.adamw(1e-2, weight_decay=1e-3),
       "rmsprop": lambda: optax.rmsprop(1e-2)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero")
    m32, p32 = _mlp((32,), 10, 16)
    m16, p16 = _mlp((16,), 10, 8)
    m18, p18 = _mlp((18,), 5, 7)
    rng = np.random.RandomState(3)
    fam = [(rng.normal(size=(64, 7)).astype(np.float32),
            rng.randint(0, 5, size=(64,)).astype(np.int32))
           for _ in range(4)]
    lm = JaxLM(**LM_KW, param_dtype=jnp.bfloat16)
    lm_params = jax.tree_util.tree_map(np.asarray, jax.jit(lm.init)(
        jax.random.PRNGKey(0), np.zeros((1, 32), np.int32))["params"])
    toks = np.random.RandomState(0).randint(0, 128, size=(16, 32)) \
        .astype(np.int32)
    lm_batch = (toks, np.concatenate(
        [toks[:, 1:], np.full((16, 1), -1, np.int32)], axis=1))
    b6 = _batches(6, 64, 8)
    # The JAX ZeRO tier on 4 devices, two steps in: its state goes over.
    zcomm = cmn.create_communicator("xla", devices=jax.devices()[:N])
    zopt = cmn.create_zero_optimizer(optax.adam(1e-2), zcomm)
    zstate = zopt.init(p16)
    for b in b6[:2]:
        zstate, _ = zopt.update(zstate, b, jax_cls_loss(m16), has_aux=True)
    adam = zstate.opt_state[0]
    jz = {"params": [np.asarray(v) for v in zstate.flat_params],
          "mu": [np.asarray(v) for v in adam.mu],
          "nu": [np.asarray(v) for v in adam.nu],
          "count": int(adam.count), "step": int(zstate.step),
          "batch": b6[2]}
    znext, _ = zopt.update(zstate, b6[2], jax_cls_loss(m16), has_aux=True)
    inputs = {"dir": str(out / "ckpt"),
              "mlp32": (p32, ((32,), 10, 16)),
              "mlp16": (p16, ((16,), 10, 8)),
              "mlp18": (p18, ((18,), 5, 7)),
              "batches5": _batches(5, 64, 16), "batches6": b6,
              "batches_fam": fam, "lm": (lm_params, LM_KW),
              "lm_batch": lm_batch, "jax_zero": jz}
    with open(out / "zero_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ranks = run_ranks("zero", out, N, timeout_s=240.0)
    return {"ranks": ranks, "inputs": inputs, "m32": m32, "m16": m16,
            "m18": m18, "lm": lm, "jax_next": znext}


@pytest.mark.parametrize("tx_name", ["sgd_momentum", "adam"])
def test_zero_matches_single_device_oracle(setup, tx_name):
    """Sharded state on 4 ranks == plain optax on the same global
    batches (the JAX test's 3e-5)."""
    inp = setup["inputs"]
    want = _oracle(setup["m32"], inp["mlp32"][0], TXS[tx_name](),
                   inp["batches5"])
    for r in setup["ranks"]:
        got, loss = r[f"oracle_{tx_name}"]
        _close(got, want, 3e-5)
        assert np.isfinite(loss)


def test_zero_state_is_sharded(setup):
    """Each rank stores one ``1/N`` shard of every leaf (padded to a
    multiple of N) and shard-sized Adam moments; its bytes are a quarter
    of one replicated process's plus at most N - 1 padding elements per
    leaf in each of the three per-element tensors."""
    for r in setup["ranks"]:
        lay = r["layout"]
        for shard, size, padded in zip(lay["shards"], lay["sizes"],
                                       lay["padded"]):
            assert padded % N == 0 and 0 <= padded - size < N
            assert shard == (padded // N,)
        for shapes, shard in zip(lay["opt_shapes"], lay["shards"]):
            assert shapes["exp_avg"] == shard
            assert shapes["exp_avg_sq"] == shard
            assert shapes["step"] == ()
        leaves = len(lay["sizes"])
        pad = sum(p - s for p, s in zip(lay["padded"], lay["sizes"]))
        assert N * lay["bytes"] - lay["replicated_bytes"] == \
            3 * 4 * pad + (N - 1) * 4 * leaves


def test_zero_wire_dtype_close_to_fp32(setup):
    """The bf16 reduce-scatter wire stays within bf16 tolerance of fp32
    (5e-2), and the fp32 run is the optax oracle's."""
    inp = setup["inputs"]
    want = _oracle(setup["m32"], inp["mlp32"][0], optax.sgd(0.1),
                   inp["batches5"][:3])
    for r in setup["ranks"]:
        _close(r["wire16"], r["wire32"], 5e-2)
        _close(r["wire32"], want, 3e-5)


def test_zero_global_norm_clip_matches_oracle(setup):
    """``zero_clip_by_global_norm`` (one all-reduce of the shards'
    squared norms) == optax's clip on one device (3e-6)."""
    inp = setup["inputs"]
    tx = optax.chain(optax.clip_by_global_norm(0.05), optax.sgd(0.1))
    want = _oracle(setup["m32"], inp["mlp32"][0], tx, inp["batches5"])
    for r in setup["ranks"]:
        _close(r["clip"], want, 3e-6)


def test_zero_schedule_bearing_transform(setup):
    """Adam with a learning-rate schedule of the step count (optax's
    ``scale_by_adam`` + ``scale_by_schedule``) under sharding (1e-5)."""
    inp = setup["inputs"]
    tx = optax.chain(optax.scale_by_adam(), optax.scale_by_schedule(
        lambda c: -0.05 / (1.0 + 0.1 * c)))
    want = _oracle(setup["m32"], inp["mlp32"][0], tx, inp["batches5"][:3])
    for r in setup["ranks"]:
        _close(r["schedule"], want, 1e-5)


def test_zero_mixed_param_dtypes_bf16_storage(setup):
    """bf16 parameter storage beside the fp32 MoE router under Adafactor:
    each leaf keeps its dtype through shard, update and gather, the loss
    falls, and the parameters track the optax oracle within the JAX
    test's bound (0.1: bf16 sums in another order, amplified by
    Adafactor's clipping and parameter scale)."""
    inp = setup["inputs"]
    p = _oracle(setup["lm"], inp["lm"][0], optax.adafactor(1e-2),
                [inp["lm_batch"]] * 3, loss=jax_lm_loss)
    for r in setup["ranks"]:
        mixed = r["mixed"]
        assert mixed["losses"][-1] < mixed["losses"][0], mixed["losses"]
        dts = mixed["dtypes"]
        assert all(v == "torch.float32" for k, v in dts.items()
                   if k.endswith("router"))
        assert any(v == "torch.bfloat16" for v in dts.values())
        _close(mixed["params"], p, 0.1)


def test_zero_state_checkpoint_roundtrip(setup):
    """Save the sharded state, restore it into a fresh optimizer's state,
    and continue: the restore and the continuation match the
    uninterrupted run (test_checkpoint_zero.py)."""
    for r in setup["ranks"]:
        saved, back, cont_a, cont_b = r["roundtrip"]
        _close(back, saved, 1e-7, 0)
        _close(cont_b, cont_a, 1e-6, 0)


@pytest.mark.parametrize("n_save", [4, 2])
def test_zero_elastic_restore_matches_oracle(setup, n_save):
    """Save at ``n_save`` ranks, resume at the other count: the re-laid
    parameters materialize to the saved ones (2e-5) and training goes on
    as one uninterrupted replicated run (5e-5)."""
    inp = setup["inputs"]
    want = _oracle(setup["m16"], inp["mlp16"][0], TXS["adam"](),
                   inp["batches6"])
    saved = next(r for r in setup["ranks"] if "saved" in
                 r[f"elastic_adam_{n_save}"])[f"elastic_adam_{n_save}"]
    loaded = [r[f"elastic_adam_{n_save}"] for r in setup["ranks"]
              if "final" in r[f"elastic_adam_{n_save}"]]
    assert len(loaded) == (2 if n_save == 4 else 4)
    for out in loaded:
        assert out["step"] == 3
        _close(out["restored"], saved["saved"], 2e-5)
        _close(out["final"], want, 5e-5)


@pytest.mark.parametrize("n_save", [4, 2])
@pytest.mark.parametrize("tx_name", ["sgd", "momentum_nesterov", "adam",
                                     "adamw", "rmsprop"])
def test_zero_elastic_across_transform_families(setup, tx_name, n_save):
    """Every element-wise optimizer's state (stateless, one trace, two
    moments and a count, an average) re-lays across 4 <-> 2 ranks, odd
    leaf sizes (hidden 18) padded differently at each count (5e-5)."""
    inp = setup["inputs"]
    want = _oracle(setup["m18"], inp["mlp18"][0], TXS[tx_name](),
                   inp["batches_fam"])
    for r in setup["ranks"]:
        out = r[f"family_{tx_name}_{n_save}"]
        if "final" in out:
            _close(out["final"], want, 5e-5)


def test_zero_elastic_int8_ef_resets_residual_with_warning(setup):
    """A rank-count change cannot carry the per-rank error-feedback
    residual: it resets to zeros with the JAX package's warning; the
    parameters still round-trip."""
    saved = setup["ranks"][0]["int8_reset"]
    assert saved["saved_resid_max"] > 0
    for r in setup["ranks"][:2]:
        out = r["int8_reset"]
        assert any("error-feedback residual" in w for w in out["warnings"])
        assert out["resid_max"] == 0.0
        _close(out["restored"], saved["saved"], 2e-5)


def test_zero_elastic_fresh_start_without_checkpoint(setup):
    for r in setup["ranks"]:
        assert r["fresh"] == (0, 0)


def test_zero_state_carries_over_from_and_to_the_jax_tier(setup):
    """The JAX ZeRO tier's flat shards and Adam state, carried into the
    port (the bridge's logical view), stepped once here and carried back,
    equal the JAX tier's own next step (1e-6)."""
    nxt = setup["jax_next"]
    adam = nxt.opt_state[0]
    for r in setup["ranks"]:
        got = r["from_jax"]
        assert got["step"] == int(nxt.step)
        _close(got["params"], [np.asarray(v) for v in nxt.flat_params],
               1e-6, 1e-6)
        _close(got["opt"]["exp_avg"], [np.asarray(v) for v in adam.mu],
               1e-6, 1e-6)
        _close(got["opt"]["exp_avg_sq"], [np.asarray(v) for v in adam.nu],
               1e-6, 1e-6)
        assert got["opt"]["step"] == int(adam.count)


def test_zero_optimizer_refuses_a_built_optimizer():
    """The tier builds its optimizer over the rank's shards: an optimizer
    over the model's parameters is refused."""
    import torch

    from chainermn_tpu_torch.optimizers import create_zero_optimizer

    w = torch.nn.Parameter(torch.zeros(3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(TypeError, match="factory"):
            create_zero_optimizer(torch.optim.SGD([w], lr=0.1), None)
