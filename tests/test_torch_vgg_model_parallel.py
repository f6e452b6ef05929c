"""Model-parallel VGG across four gloo ranks against the JAX package
(``tests/models_tests/test_vgg_model_parallel.py``, and the example
``examples/vgg/train_vgg_model_parallel.py``'s training step).

The JAX test's narrow VGG-11 (``width_mult`` 1/16, 5 classes, 4 stages,
4 images of 32×32×3 from ``RandomState(0)``) is built in the JAX package,
its stage parameters carried to the port by ``vgg_stage_params_from_flax``
and one stage loaded on each of four gloo ranks (a 1 × 4 ``data × model``
grid, one job through the port's launcher).  The ranks' chain, broadcast
from the last stage, must give the JAX chain's logits and the loss; then
two steps of SGD with momentum (lr 0.1, 0.9) under
``model_parallel_grad_reduce`` must leave every stage's parameters where
the JAX package's ``create_multi_node_optimizer(..., grad_reduce=
model_parallel_grad_reduce(dcomm, mcomm))`` leaves them.  Tolerances:
logits atol 2e-4 + rtol 1e-4 (the JAX test's chain-vs-sequential bound:
float32 convolutions summed in other orders), losses rtol 1e-5,
parameters atol 2e-5 + rtol 1e-4 (two updates of lr 0.1 on gradients
that agree to ~1e-6 relative).
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu import functions as JF
from chainermn_tpu.models.vgg import (
    apply_sequential,
    build_chain,
    init_stage_params,
    vgg_stage_modules,
)
from chainermn_tpu.optimizers import model_parallel_grad_reduce

import torch

from chainermn_tpu_torch.models import apply_sequential as t_apply
from chainermn_tpu_torch.models import vgg_stage_modules as t_modules
from chainermn_tpu_torch.utils import (
    vgg_stage_params_from_flax,
    vgg_stage_params_to_flax,
)

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import VGG
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

S = 4
LR = 0.1


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def ref():
    """The JAX side: stage parameters, inputs, the chain's logits and
    loss, and the stages after two SGD-momentum steps."""
    modules = vgg_stage_modules(VGG["cfg"], num_classes=VGG["num_classes"],
                                n_stages=S, width_mult=VGG["width_mult"])
    rng = np.random.RandomState(0)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = (np.arange(4) % VGG["num_classes"]).astype(np.int32)
    params = init_stage_params(modules, jax.random.PRNGKey(0), x[:1])
    mesh = cmn.hybrid_mesh({"data": 1, "model": S},
                           devices=jax.devices()[:S])
    comm = cmn.XlaCommunicator(mesh)
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    chain = build_chain(modules, mcomm)

    def logits_of(ps, xx):
        return JF.bcast(mcomm, chain(ps, xx), root=S - 1)

    logits = np.asarray(jax.jit(comm.spmd(
        lambda *a: logits_of(list(a[:-1]), a[-1]),
        in_specs=(P(),) * (S + 1), out_specs=P(), check_vma=False))(
        *params, x))

    def loss_fn(p, batch):
        xx, yy = batch
        lg = logits_of([p[f"stage{i}"] for i in range(S)], xx)
        return optax.softmax_cross_entropy_with_integer_labels(
            lg, yy).mean()

    opt = cmn.create_multi_node_optimizer(
        optax.sgd(LR, momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init({f"stage{i}": p for i, p in enumerate(params)})
    step = opt.make_train_step(loss_fn)
    losses = []
    for _ in range(2):
        state, m = step(state, (x, y))
        losses.append(float(m["loss"]))
    return {"params": [_np_tree(p) for p in params], "x": x, "y": y,
            "logits": logits, "losses": losses,
            "after": [_np_tree(state.params[f"stage{i}"]) for i in range(S)],
            "oracle": np.asarray(apply_sequential(modules, params, x))}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    out = tmp_path_factory.mktemp("vgg")
    with open(out / "vgg_inputs.pkl", "wb") as f:
        pickle.dump({"params": ref["params"], "x": ref["x"], "y": ref["y"],
                     "lr": LR}, f)
    return run_ranks("vgg", out, S)


def test_bridged_stages_compose_to_the_jax_oracle(ref):
    """One process: the port's stages with the bridged parameters, applied
    back to back, give the JAX ``apply_sequential``; the bridge round
    trips exactly."""
    mods = t_modules(**VGG, device="cpu")
    for m, p in zip(mods, ref["params"]):
        m.load_state_dict(vgg_stage_params_from_flax(p, device="cpu"))
        back = vgg_stage_params_to_flax(dict(m.named_parameters()))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(p)):
            np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        got = t_apply(mods, torch.tensor(ref["x"])).numpy()
    np.testing.assert_allclose(got, ref["oracle"], atol=2e-4, rtol=1e-4)


def test_chain_logits_and_loss_match_jax(ranks, ref):
    want_loss = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(ref["logits"]), ref["y"]).mean())
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["logits"], ref["logits"],
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(ranks[r]["loss"], want_loss, rtol=1e-5)


def test_two_sgd_momentum_steps_match_jax_per_stage(ranks, ref):
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["losses"], ref["losses"],
                                   rtol=1e-5)
        got, want = ranks[r]["params"], ref["after"][r]
        assert set(got) == set(want)
        for mod in want:
            for leaf in want[mod]:
                np.testing.assert_allclose(
                    got[mod][leaf], want[mod][leaf], atol=2e-5, rtol=1e-4,
                    err_msg=f"stage {r} {mod}.{leaf}")
                # The update moved the parameters.
                assert np.abs(want[mod][leaf]
                              - ref["params"][r][mod][leaf]).max() > 1e-4
