"""ResNet data-parallel training in the port against the JAX package, on
Flax variables carried across by ``resnet_params_from_flax``.

Sync-BN (outputs, gradients, running statistics) against the Flax module;
XLA's ``SAME`` padding of the stem, a stride-2 3×3 conv and the max-pool
at an even size; ``ResNetTiny`` logits, loss, every gradient leaf (read back
by ``resnet_params_to_flax``) and the updated ``batch_stats`` against
``resnet_loss`` + ``jax.value_and_grad`` for ``bn="sync"``, ``bn="frozen"``
with and without the fused 1×1 convs (the JAX ones run their Pallas kernel
in interpret mode), and the s2d stem; two momentum-SGD steps of the port's
stateful ``MultiNodeOptimizer`` against the JAX optimizer on the
conftest's 8-device mesh; ``accum_steps``; two gloo ranks against one; the
``train_imagenet`` twin.

Geometry: width 8, 16 or 32 px, 10 classes, batch 8, float32 on the CPU.
Tolerances: loss rtol 1e-5; logits, gradients, parameters and running
statistics atol 1e-4 + rtol 1e-4 (float32 through 14 convolutions and 17
normalizations, sums in another order).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

import chainermn_tpu as cmn
from chainermn_tpu.links import MultiNodeBatchNormalization as JaxBN
from chainermn_tpu.links import sync_batch_norm as jax_sync_batch_norm
from chainermn_tpu.models import ResNetTiny as JaxTiny
from chainermn_tpu.models import resnet_loss as jax_resnet_loss
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.links import (
    MultiNodeBatchNormalization,
    sync_batch_norm,
)
from chainermn_tpu_torch.models import ResNet50, ResNetTiny, resnet_loss
from chainermn_tpu_torch.models.resnet import (
    Conv,
    max_pool_same,
    s2d_stem_kernel,
    space_to_depth,
)
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd
from chainermn_tpu_torch.utils import (
    resnet_params_from_flax,
    resnet_params_to_flax,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(num_classes=10, width=8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], err_msg=leaf,
                                   **(tol or TOL))


def _images(B, size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, size, size, 3).astype(np.float32),
            rng.randint(0, 10, size=B).astype(np.int32))


def _nchw(x):
    """NHWC numpy -> the port's NCHW tensor in channels_last memory."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _pair(size=16, stats_seed=None, **kw):
    """A JAX ``ResNetTiny`` and the port's, on the same Flax variables; with
    ``stats_seed`` the running statistics are random (so a frozen-BN model
    is not the identity affine)."""
    jm = JaxTiny(**TINY, dtype=jnp.float32, **kw)
    x0 = jnp.zeros((1, size, size, 3), jnp.float32)
    v = jax.jit(lambda r: JaxTiny(**TINY, dtype=jnp.float32,
                                  **{k: a for k, a in kw.items()
                                     if k != "axis_name"}).init(
        r, x0, train=False))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    if stats_seed is not None:
        rng = np.random.RandomState(stats_seed)
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.randn(*a.shape) * 0.1 if p[-1].key == "mean"
                          else rng.rand(*a.shape) + 0.5).astype(np.float32),
            stats)
    tkw = {k: a for k, a in kw.items() if k != "axis_name"}
    tm = ResNetTiny(**TINY, dtype=torch.float32, device="cpu", **tkw)
    tm.load_state_dict(resnet_params_from_flax(params, stats, device="cpu"))
    return jm, params, stats, tm


# ---------------------------------------------------------------- sync-BN
def test_batch_norm_matches_flax_module():
    """Training-mode output, gradients and running statistics, and the
    eval-mode affine, on an NHWC activation (the port's is NCHW)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 5, 6, 3) * 2 + 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    jm = JaxBN(3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = {"scale": jnp.asarray(rng.rand(3) + 0.5, jnp.float32),
         "bias": jnp.asarray(rng.randn(3), jnp.float32)}

    def jf(x, p):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          x, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (jy, jst)), (jdx, jdp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    tm = MultiNodeBatchNormalization(3, device="cpu")
    with torch.no_grad():
        tm.scale.copy_(torch.tensor(np.asarray(p["scale"])))
        tm.bias.copy_(torch.tensor(np.asarray(p["bias"])))
    xt = _nchw(x).requires_grad_(True)
    ty = tm(xt)
    (ty * _nchw(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), jy,
                               **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), jdx,
                               **TOL)
    np.testing.assert_allclose(tm.scale.grad.numpy(), jdp["scale"], **TOL)
    np.testing.assert_allclose(tm.bias.grad.numpy(), jdp["bias"], **TOL)
    np.testing.assert_allclose(tm.mean.numpy(), jst["mean"], **TOL)
    np.testing.assert_allclose(tm.var.numpy(), jst["var"], **TOL)
    # The biased variance, momentum 0.9 in the JAX package's sense.
    np.testing.assert_allclose(tm.var.numpy(),
                               0.9 + 0.1 * x.reshape(-1, 3).var(0), **TOL)
    # The functional form, as the JAX one outside a mesh (no axis).
    jfn = jax_sync_batch_norm(jnp.asarray(x), p["scale"], p["bias"], None)
    tfn = sync_batch_norm(_nchw(x), tm.scale.detach(), tm.bias.detach())
    np.testing.assert_allclose(tfn.permute(0, 2, 3, 1).numpy(), jfn, **TOL)
    je = jm.apply({"params": p, "batch_stats": jst}, jnp.asarray(x),
                  use_running_average=True)
    te = tm(_nchw(x), use_running_average=True)
    np.testing.assert_allclose(te.permute(0, 2, 3, 1).detach().numpy(), je,
                               **TOL)


# ---------------------------------------------------------------- padding
def _flax_conv(x, w, k, s, padding="SAME"):
    conv = fnn.Conv(w.shape[-1], (k, k), strides=(s, s), padding=padding,
                    use_bias=False)
    return np.asarray(conv.apply({"params": {"kernel": w}}, x))


@pytest.mark.parametrize("k,s,size", [(7, 2, 32), (3, 2, 16), (3, 1, 16),
                                      (1, 2, 16), (3, 2, 15)])
def test_same_padding_matches_jax(k, s, size):
    rng = np.random.RandomState(k * 10 + s)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 4).astype(np.float32)
    want = _flax_conv(x, w, k, s)
    conv = Conv(3, 4, k, s, device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    got = conv(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if k > 1 and s == 2 and size % 2 == 0:
        # The symmetric torch padding has the right size and other windows.
        sym = F.conv2d(_nchw(x), conv.weight, stride=s, padding=k // 2)
        assert sym.shape == conv(_nchw(x)).shape
        assert not np.allclose(sym.permute(0, 2, 3, 1).detach().numpy(),
                               want, atol=1e-3)


@pytest.mark.parametrize("size", [16, 15])
def test_max_pool_same_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(
        np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    got = max_pool_same(_nchw(x), 3, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_explicit_s2d_padding_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 12).astype(np.float32)
    w = rng.randn(4, 4, 12, 4).astype(np.float32)
    want = _flax_conv(x, w, 4, 1, padding=((1, 2), (1, 2)))
    conv = Conv(12, 4, 4, 1, padding=((1, 2), (1, 2)), device="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    got = conv(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_s2d_stem_kernel_turns_the_conv7_stem_into_the_s2d_stem():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    w7 = rng.randn(7, 7, 3, 8).astype(np.float32)
    conv7 = Conv(3, 8, 7, 2, device="cpu")
    s2d = Conv(12, 8, 4, 1, padding=((1, 2), (1, 2)), device="cpu")
    with torch.no_grad():
        conv7.weight.copy_(torch.from_numpy(w7.transpose(3, 2, 0, 1)))
        s2d.weight.copy_(torch.from_numpy(
            s2d_stem_kernel(w7).transpose(3, 2, 0, 1)))
        want = conv7(_nchw(x))
        got = s2d(space_to_depth(torch.from_numpy(x)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


# ------------------------------------------------------------ whole model
CASES = {
    "sync": (dict(), None),
    "frozen": (dict(bn="frozen"), 3),
    "frozen_pallas": (dict(bn="frozen", conv1="pallas"), 4),
    "sync_s2d": (dict(stem="s2d"), None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_resnet_tiny_loss_grads_and_stats_match_jax(name):
    kw, stats_seed = CASES[name]
    jm, params, stats, tm = _pair(stats_seed=stats_seed, **kw)
    x, y = _images(8, 16, seed=len(name))

    @jax.jit
    def jfun(params, stats, x, y):
        (loss, (aux, new)), grads = jax.value_and_grad(
            jax_resnet_loss(jm), has_aux=True)(params, stats, (x, y))
        logits = jm.apply({"params": params, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])[0]
        return loss, aux, new, grads, logits

    jl, jaux, jst, jg, jlogits = jfun(params, stats, jnp.asarray(x),
                                      jnp.asarray(y))
    tl, (taux, tstate) = resnet_loss(tm)(tm, (x, y))
    tl.backward()
    tl = tl.detach()
    # The statistics the training forward left, before any other forward.
    _, tstats = resnet_params_to_flax(tstate)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["accuracy"]),
                               float(jaux["accuracy"]))
    _close(tstats, jax.tree_util.tree_map(np.asarray, jst))
    grads, _ = resnet_params_to_flax({n: p.grad
                                      for n, p in tm.named_parameters()})
    _close(grads, jax.tree_util.tree_map(np.asarray, jg))
    # Training-mode logits depend on the batch, not on the running
    # statistics, so a second forward gives the first one's logits.
    with torch.no_grad():
        tlogits = tm(x, train=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)


def test_sgd_steps_with_batch_stats_match_jax_optimizer():
    """Two steps of momentum SGD (0.1, 0.9) with sync-BN: the JAX optimizer
    over the 8-device mesh (one image per device, moments ``pmean``'d),
    the port on one rank over the whole batch (moments all-reduced over the
    communicator's one-rank group)."""
    comm = cmn.create_communicator("xla")
    jm, params, stats, tm = _pair(axis_name=comm.axis_name)
    batches = [_images(8, 16, seed=20), _images(8, 16, seed=21)]
    opt = cmn.create_multi_node_optimizer(optax.sgd(0.1, momentum=0.9),
                                          comm)
    st = opt.init(params, model_state=stats)
    jlosses = []
    for b in batches:
        st, m = opt.update(st, b, jax_resnet_loss(jm), stateful=True)
        jlosses.append(float(m["loss"]))

    tcomm = create_communicator("xla", device="cpu")
    tm = ResNetTiny(**TINY, dtype=torch.float32, axis_name=tcomm.axis_name,
                    device="cpu")
    tm.load_state_dict(resnet_params_from_flax(params, stats, device="cpu"))
    topt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), tcomm)
    state = topt.init(tm)
    step = topt.make_train_step(resnet_loss(tm), stateful=True)
    tlosses = [float(step(state, b)[1]["loss"]) for b in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    tp, _ = resnet_params_to_flax(state.params)
    _, ts = resnet_params_to_flax(state.model_state)
    _close(tp, jax.tree_util.tree_map(np.asarray, st.params))
    _close(ts, jax.tree_util.tree_map(np.asarray, st.model_state))


def _tiny(comm=None, seed=0, **kw):
    return ResNetTiny(**TINY, dtype=torch.float32, device="cpu", seed=seed,
                      axis_name=None if comm is None else comm.axis_name,
                      **kw)


def _steps(model, comm, batches, accum=1):
    opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm)
    state = opt.init(model)
    step = opt.make_train_step(resnet_loss(model), stateful=True,
                               accum_steps=accum)
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    return losses, {n: t.detach().clone()
                    for n, t in model.state_dict().items()}


def test_accum_steps_two_equals_one_with_frozen_bn():
    """Without batch statistics the microbatches do not interact: two
    microbatches of 4 give the step of one batch of 8."""
    comm = create_communicator("xla", device="cpu")
    batches = [_images(8, 16, seed=30), _images(8, 16, seed=31)]
    runs = [_steps(_tiny(comm, seed=2, bn="frozen", conv1="xla"), comm,
                   batches, accum) for accum in (1, 2)]
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for n in runs[0][1]:
        torch.testing.assert_close(runs[1][1][n], runs[0][1][n], msg=n,
                                   atol=1e-5, rtol=1e-4)


def test_accum_steps_thread_the_batch_statistics_in_order():
    """With sync-BN each microbatch normalizes over itself and updates the
    running statistics in turn: the accumulated step equals two
    forward/backward passes in order, the mean gradient, one SGD step."""
    comm = create_communicator("xla", device="cpu")
    x, y = _images(8, 16, seed=32)
    got = _tiny(comm, seed=3)
    _steps(got, comm, [(x, y)], accum=2)
    want = _tiny(comm, seed=3)
    loss_fn = resnet_loss(want)
    for half in (slice(0, 4), slice(4, 8)):
        loss_fn(want, (x[half], y[half]))[0].backward()
    with torch.no_grad():
        for p in want.parameters():
            p -= 0.1 * p.grad / 2  # the first momentum step: trace = g
    for n, t in want.state_dict().items():
        torch.testing.assert_close(got.state_dict()[n], t, msg=n, atol=1e-5,
                                   rtol=1e-4)


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import ResNetTiny, resnet_loss
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer, sgd)

    def run(comm, batches, axis_name):
        m = ResNetTiny(num_classes=10, width=8, dtype=torch.float32,
                       axis_name=axis_name, device="cpu", seed=4)
        opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm)
        state = opt.init(m)
        step = opt.make_train_step(resnet_loss(m), stateful=True)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        return losses, m.state_dict()

    comm = create_communicator("naive", device="cpu")
    r, n = comm.rank, comm.size
    rng = np.random.RandomState(40)
    batches = [(rng.randn(8, 16, 16, 3).astype(np.float32),
                rng.randint(0, 10, size=8)) for _ in range(2)]
    mine = [tuple(a[r * 8 // n:(r + 1) * 8 // n] for a in b)
            for b in batches]
    losses, sd = run(comm, mine, comm.axis_name)
    local = run(comm, mine[:1], None)[0]  # local BN: the control
    np.savez({out!r} + f"/n{{n}}_rank{{r}}.npz",
             **{{k: v.numpy() for k, v in sd.items()}})
    json.dump({{"losses": losses, "local": local}},
              open({out!r} + f"/n{{n}}_rank{{r}}.json", "w"))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_of_sync_bn_equal_one_rank(tmp_path):
    """Two ranks on half batches each against one rank on the whole batch:
    the sync-BN moments are all-reduced in the forward and their
    cotangents in the backward, so loss, parameters and running statistics
    agree; local BN on the same halves does not."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(out=str(tmp_path)))
    procs = []
    for n in (1, 2):
        port = _free_port()
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
            procs.append(subprocess.Popen(
                [sys.executable, str(script)], env=env, cwd=str(REPO),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for pr in procs:
        out, _ = pr.communicate(timeout=180)
        assert pr.returncode == 0, out
    one = json.loads((tmp_path / "n1_rank0.json").read_text())
    want = np.load(tmp_path / "n1_rank0.npz")
    for r in range(2):
        info = json.loads((tmp_path / f"n2_rank{r}.json").read_text())
        np.testing.assert_allclose(info["losses"], one["losses"], rtol=1e-5)
        assert abs(info["local"][0] - one["losses"][0]) > 1e-3
        got = np.load(tmp_path / f"n2_rank{r}.npz")
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"rank {r} "
                                       f"{k}", **TOL)


def test_train_imagenet_twin_runs_on_cpu(capsys):
    from chainermn_tpu_torch.examples import train_imagenet

    for extra in (["--arch", "resnet18", "--stem", "s2d"],
                  ["--bn", "frozen", "--conv1", "pallas", "--branch-scale",
                   "0.1"]):
        loss = train_imagenet.main(
            ["--device", "cpu", "--steps", "2", "--image-size", "32",
             "--num-classes", "10", "--batch-per-chip", "4", "--lr", "0.01",
             *extra])
        assert np.isfinite(loss)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"] * 2


def test_unported_options_raise(tmp_path):
    """The options of ROADMAP items 6 and 7 are ported and run (the fused
    max-pool, augmentation, the evaluator, the checkpointer, file-backed
    data, double buffering, int8 error feedback); those of items 9 and 11
    still raise, naming their item."""
    from chainermn_tpu_torch.examples import train_imagenet

    m = ResNetTiny(**TINY, maxpool="fused", device="cpu")
    assert m.maxpool == "fused"
    rng = np.random.RandomState(0)
    for name in ("train", "val"):
        np.savez(tmp_path / f"{name}.npz",
                 images=rng.rand(8, 32, 32, 3).astype(np.float32),
                 labels=rng.randint(0, 10, 8).astype(np.int32))
    base = ["--device", "cpu", "--arch", "resnet18", "--image-size", "32",
            "--num-classes", "10", "--batch-per-chip", "4", "--lr", "0.01"]
    for flags in (["--checkpoint", str(tmp_path / "ck"), "--augment",
                   "--maxpool", "fused", "--eval", "--double-buffering",
                   "--train-npz", str(tmp_path / "train.npz"),
                   "--val-npz", str(tmp_path / "val.npz")],
                  ["--grad-compression", "int8_ef", "--steps", "1",
                   "--iters-per-epoch", "2"]):
        assert np.isfinite(train_imagenet.main(base + flags))
    assert os.listdir(tmp_path / "ck" / "imagenet") == ["2"]
    for flags in (["--optimizer", "lars"], ["--base-batch", "256"],
                  ["--warmup-epochs", "5"], ["--arch", "vit"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_imagenet.main(["--device", "cpu", *flags])
    for kw, match in ((dict(bn="nope"), "bn="), (dict(conv1="fused"), "conv1="),
                      (dict(conv1="pallas"), "bn='frozen'"),
                      (dict(stem="conv3"), "stem="),
                      (dict(maxpool="avg"), "maxpool=")):
        with pytest.raises(ValueError, match=match):
            ResNetTiny(**TINY, device="cpu", **kw)


def test_resnet_entry_points_raise_without_cuda(monkeypatch):
    from chainermn_tpu_torch.examples import train_imagenet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet_params_from_flax({"head": {"kernel": np.zeros((2, 2)),
                                          "bias": np.zeros(2)}})
    with pytest.raises(RuntimeError, match="create_communicator"):
        train_imagenet.main(["--steps", "1"])
