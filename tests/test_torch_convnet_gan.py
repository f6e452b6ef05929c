"""The port's channel-parallel convnet and data-parallel DCGAN
(``models/parallel_convnet.py``, ``models/dcgan.py``) and their example
twins, against the JAX package's tests
(``tests/models_tests/test_parallel_convnet.py``, ``test_dcgan.py``).

One job of two gloo ranks (``torch_rank_bodies.cnngan``) starts from the
JAX tests' Flax parameters (carried across with the bridge) and batches:
the convnet's filters cut over the two ranks and three SGD-momentum
steps on the replicated batch, against the dense one-device oracle (the
JAX test's loss 1e-5, parameters rtol 2e-4 + atol 2e-5); the DCGAN's two
players, three simultaneous SGD-momentum steps with each rank on its half
of the batch, against the one-device two-player update (atol 5e-5 + rtol
5e-4); eight Adam steps in which the discriminator's loss falls; then
``train_parallel_convnet``, ``train_dcgan`` and
``train_mnist_model_parallel`` on the two ranks.
"""

import pickle

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from chainermn_tpu.models import (
    Discriminator as JaxD,
    Generator as JaxG,
    dense_reference_apply as jax_dense_apply,
    init_channel_parallel as jax_init_cp,
)
from chainermn_tpu.models.dcgan import _bce_logits

from chainermn_tpu_torch.models import shard_channel_parallel
from chainermn_tpu_torch.utils import (
    channel_parallel_params_from_flax,
    dcgan_params_from_flax,
)

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 2
WIDTHS, NUM_CLASSES, IMG = (16, 32), 10, (16, 16, 3)
NZ, GAN_IMG = 16, (32, 32, 1)


def _cnn_batch(bs, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(bs,) + IMG).astype(np.float32),
            rng.randint(0, NUM_CLASSES, size=(bs,)).astype(np.int32))


def _gan_batches(n, bs, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=(bs,) + GAN_IMG).astype(np.float32),
             rng.normal(size=(bs, NZ)).astype(np.float32))
            for _ in range(n)]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("cnngan")
    rg, rd = jax.random.split(jax.random.PRNGKey(0))
    g, d = JaxG(ch=8, out_ch=1), JaxD(ch=8)
    gp = _np_tree(g.init(rg, jnp.zeros((1, NZ), jnp.float32))["params"])
    dp = _np_tree(d.init(rd, jnp.zeros((1,) + GAN_IMG,
                                       jnp.float32))["params"])
    inputs = {
        "cnn": _np_tree(jax_init_cp(jax.random.PRNGKey(0), WIDTHS,
                                    NUM_CLASSES, in_ch=IMG[-1])),
        "cnn_batches": [_cnn_batch(16, s) for s in range(3)],
        "gan_g": gp, "gan_d": dp, "gan_batches": _gan_batches(3, 16),
        "gan_move_batches": _gan_batches(8, 16, seed=3)}
    with open(out / "cnngan_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return {"ranks": run_ranks("cnngan", out, N, timeout_s=240.0),
            "inputs": inputs, "g": g, "d": d}


def _dense_loss(params, batch):
    x, y = batch
    logp = jax.nn.log_softmax(jax_dense_apply(params, x).astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))


def test_channel_parallel_matches_dense_oracle(setup):
    """The filter-sharded network == the dense one on one device:
    forward logits, the last step's loss and the parameters after three
    SGD-momentum steps (the shards joined on the channel axis)."""
    inp = setup["inputs"]
    params = inp["cnn"]
    x0 = inp["cnn_batches"][0][0]
    want0 = np.asarray(jax_dense_apply(params, x0))
    tx = optax.sgd(0.05, momentum=0.9)
    step = jax.jit(jax.value_and_grad(_dense_loss))
    p, opt = params, tx.init(params)
    for b in inp["cnn_batches"]:
        loss, grads = step(p, b)
        up, opt = tx.update(grads, opt, p)
        p = optax.apply_updates(p, up)
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["cnn_logits0"], want0, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["cnn_loss"], float(loss), rtol=1e-5,
                                   atol=1e-5)
    joined = {
        "convs": [tuple(np.concatenate(
            [r["cnn_shards"]["convs"][i][j] for r in setup["ranks"]],
            axis=3 if j == 0 else 0) for j in range(2))
            for i in range(len(WIDTHS))],
        "head": setup["ranks"][0]["cnn_shards"]["head"]}
    for a, b in zip(jax.tree_util.tree_leaves(joined),
                    jax.tree_util.tree_leaves(_np_tree(p))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    for r in setup["ranks"][1:]:
        np.testing.assert_array_equal(r["cnn_shards"]["head"]["w"],
                                      joined["head"]["w"])


def test_channel_parallel_width_divisibility():
    """A width that does not divide the model ranks fails at the cut with
    a shape error, not silently."""
    params = channel_parallel_params_from_flax(_np_tree(jax_init_cp(
        jax.random.PRNGKey(0), (12,), NUM_CLASSES, in_ch=3)), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        shard_channel_parallel(params, 0, 8)


def test_gan_dp_matches_single_device_oracle(setup):
    """The two-player data-parallel step (each rank on its half of the
    batch, both gradient sets mean-reduced) == the same simultaneous
    update on one device on the whole batch; SGD, so a gradient scaled
    by a constant could not hide."""
    inp, g, d = setup["inputs"], setup["g"], setup["d"]
    g_tx = d_tx = optax.sgd(1e-3, momentum=0.9)
    gp, dp = inp["gan_g"], inp["gan_d"]
    g_opt, d_opt = g_tx.init(gp), d_tx.init(dp)

    @jax.jit
    def grads(gp, dp, real, z):
        def d_loss(dq):
            fake = jax.lax.stop_gradient(g.apply({"params": gp}, z))
            return _bce_logits(d.apply({"params": dq}, real), 1.0) + \
                _bce_logits(d.apply({"params": dq}, fake), 0.0)

        def g_loss(gq):
            return _bce_logits(d.apply({"params": dp},
                                       g.apply({"params": gq}, z)), 1.0)

        return jax.grad(g_loss)(gp), jax.grad(d_loss)(dp)

    for real, z in inp["gan_batches"]:
        gg, dg = grads(gp, dp, real, z)
        g_up, g_opt = g_tx.update(gg, g_opt, gp)
        d_up, d_opt = d_tx.update(dg, d_opt, dp)
        gp = optax.apply_updates(gp, g_up)
        dp = optax.apply_updates(dp, d_up)
    for name, tree in (("g", gp), ("d", dp)):
        want = dcgan_params_from_flax(_np_tree(tree), device="cpu")
        for r in setup["ranks"]:
            got = r["gan_sgd"][name]
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v.numpy(), atol=5e-5,
                                           rtol=5e-4, err_msg=k)


def test_gan_losses_move(setup):
    """Eight Adam steps keep both losses finite and the discriminator
    learns to separate real from fake (its loss falls); every rank reads
    the same means."""
    hist = [r["gan_adam"]["history"] for r in setup["ranks"]]
    assert hist[0] == hist[1]
    first, last = hist[0][0], hist[0][-1]
    assert np.isfinite(last["loss_dis"]) and np.isfinite(last["loss_gen"])
    assert last["loss_dis"] < first["loss_dis"]


def test_example_twins_run_on_two_ranks(setup):
    """``train_parallel_convnet`` (2 epochs of 4 steps), ``train_dcgan``
    (1 epoch of 4 steps) and ``train_mnist_model_parallel`` (the 1 x 2
    grid, 2 epochs of 4 steps) run on the two ranks with finite losses,
    the same on both."""
    r0, r1 = setup["ranks"]
    assert len(r0["ex_convnet"]) == 2 and np.isfinite(r0["ex_convnet"]).all()
    assert r0["ex_convnet"] == r1["ex_convnet"]
    assert r0["ex_dcgan"] == 4
    assert len(r0["ex_mnist_mp"]) == 2
    assert np.isfinite(r0["ex_mnist_mp"]).all()
