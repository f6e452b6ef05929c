"""The data-parallel optimizer's options in the port against the JAX
package's (``chainermn_tpu/optimizers``): ``double_buffering``,
``ema_decay`` and ``grad_compression="int8_ef"``, and the ``update``
facade's step cache.

The small MLP (32 inputs, hidden 16, 10 classes) with bridged Flax
parameters takes 3 steps of each package's train step on the same global
batches (the JAX one on the conftest's 8-device CPU mesh, the port's on
one rank).  Double buffering with SGD-momentum and with AdamW: the first
update applies the zero carry (AdamW's weight decay still acts on it), so
3 steps exercise the carry, its zero start and two stale updates; losses
within rtol 1e-5, parameters within rtol 1e-5 + atol 1e-6.  The EMA
after 3 steps likewise.

int8 error feedback: the reduction is factored as a function of stacked
per-rank tensors (``int8_ef_mean``), given the gradients the JAX mesh's 8
devices compute on their shards of the batch (each shard's gradient of
the shard-mean loss), residuals carried over 3 rounds, and held against
the JAX package's own ``_int8_ef_reduce`` run under ``shard_map``: the
int8 codes exactly (recovered from each side's residual on the shared
scale), the mean and the residuals within 1e-6.  One 2-rank gloo run then
drives the wire (``MultiNodeOptimizer`` with ``grad_compression``, and
with ``double_buffering``), each rank on its half of every batch, against
the stacked function on the same per-rank gradients.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import classification_loss as jax_cls_loss
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.models import MLP, classification_loss
from chainermn_tpu_torch.optimizers import (
    adamw,
    create_multi_node_optimizer,
    ema_model,
    int8_ef_codes,
    int8_ef_mean,
    sgd,
)
from chainermn_tpu_torch.utils import mlp_params_from_flax, mlp_params_to_flax

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
D_IN, HID, B, STEPS = 32, (16,), 32, 3


@pytest.fixture(scope="module")
def setup():
    model = JaxMLP(hidden=HID, n_out=10)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, D_IN), np.float32))["params"]
    rng = np.random.RandomState(0)
    batches = [(rng.randn(B, D_IN).astype(np.float32),
                rng.randint(0, 10, size=B).astype(np.int32))
               for _ in range(STEPS)]
    return model, jax.tree_util.tree_map(np.asarray, params), batches


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_model(params):
    m = MLP(hidden=HID, in_features=D_IN, device="cpu")
    m.load_state_dict(mlp_params_from_flax(params, device="cpu"))
    return m


def _run_both(setup, jax_tx, port_tx, **opts):
    jm, params, batches = setup
    comm = cmn.create_communicator("xla")
    jopt = cmn.create_multi_node_optimizer(jax_tx, comm, **opts)
    js = jopt.init(params)
    jl = []
    for b in batches:
        js, met = jopt.update(js, b, jax_cls_loss(jm), has_aux=True)
        jl.append(float(met["loss"]))
    model = _port_model(params)
    popt = create_multi_node_optimizer(
        port_tx, create_communicator("xla", device="cpu"), **opts)
    ps = popt.init(model)
    pl = [float(popt.update(ps, b, classification_loss(model),
                            has_aux=True)[1]["loss"]) for b in batches]
    return js, jl, ps, pl


def _check(js, jl, ps, pl):
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, js.params))
    got = _flat(mlp_params_to_flax(dict(ps.model.named_parameters())))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_double_buffering_matches_jax(setup, opt):
    if opt == "sgd_momentum":
        jtx, ptx = optax.sgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9)
    else:
        jtx = optax.adamw(1e-2, eps=1e-6, weight_decay=0.1)
        ptx = adamw(1e-2, eps=1e-6, weight_decay=0.1)
    js, jl, ps, pl = _run_both(setup, jtx, ptx, double_buffering=True)
    _check(js, jl, ps, pl)
    # The carry holds the newest reduced gradients, as the JAX state does.
    want = _flat(jax.tree_util.tree_map(np.asarray, js.pending_grads))
    got = _flat(mlp_params_to_flax(ps.pending_grads))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # The first update applied zeros: with SGD the parameters after step 1
    # are the initial ones.
    if opt == "sgd_momentum":
        _, params, batches = setup
        model = _port_model(params)
        o = create_multi_node_optimizer(
            sgd(0.1, momentum=0.9), create_communicator("xla", device="cpu"),
            double_buffering=True)
        st = o.init(model)
        o.update(st, batches[0], classification_loss(model), has_aux=True)
        got = _flat(mlp_params_to_flax(dict(model.named_parameters())))
        for k, v in _flat(params).items():
            np.testing.assert_array_equal(got[k], v)


def test_ema_matches_jax(setup):
    js, jl, ps, pl = _run_both(setup, optax.sgd(0.1, momentum=0.9),
                               sgd(0.1, momentum=0.9), ema_decay=0.9)
    _check(js, jl, ps, pl)
    want = _flat(jax.tree_util.tree_map(np.asarray, js.ema_params))
    got = _flat(mlp_params_to_flax(ps.ema_params))
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    em = _flat(mlp_params_to_flax(dict(ema_model(ps).named_parameters())))
    for k in want:
        np.testing.assert_array_equal(em[k], got[k])
    with pytest.raises(ValueError, match="ema_decay"):
        create_multi_node_optimizer(sgd(0.1), None, ema_decay=1.0)


def _shard_grads(params, batch, shards):
    """Each shard's gradient of its own mean loss (what a JAX mesh device
    computes before the reduction), stacked: ``{flax path: (R, ...)}``."""
    model = _port_model(params)
    x, y = batch
    per = len(x) // shards
    out = []
    for r in range(shards):
        model.zero_grad()
        sl = slice(r * per, (r + 1) * per)
        F.cross_entropy(model(x[sl]), torch.from_numpy(y[sl]).long()) \
            .backward()
        out.append(_flat(mlp_params_to_flax(
            {n: p.grad for n, p in model.named_parameters()})))
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


def test_int8_ef_reduction_matches_jax(setup):
    _, params, batches = setup
    comm = cmn.create_communicator("xla")
    jopt = cmn.create_multi_node_optimizer(optax.sgd(0.1), comm,
                                           grad_compression="int8_ef")
    keys = list(_flat(params))

    def body(g, r):
        y, rn = jopt._int8_ef_reduce({k: g[k][0] for k in g}, r)
        return y, rn

    spec = {k: P(comm.axes) for k in keys}
    reduce = jax.jit(jax.shard_map(
        body, mesh=comm.mesh, in_specs=(spec, spec),
        out_specs=({k: P() for k in keys}, spec)))
    n = comm.size
    resid_j = {k: np.zeros((n,) + v.shape, np.float32)
               for k, v in _flat(params).items()}
    resid_p = {k: torch.zeros((n,) + v.shape) for k, v in
               _flat(params).items()}
    for step, batch in enumerate(batches):
        g = _shard_grads(params, batch, n)
        y_j, rn_j = reduce({k: jnp.asarray(v) for k, v in g.items()},
                           {k: jnp.asarray(v) for k, v in resid_j.items()})
        for k in keys:
            c = torch.from_numpy(g[k]) + resid_p[k]
            y, q, rn = int8_ef_mean(c)
            s = int8_ef_codes(c, c.abs().amax())[1]
            q_j = np.round((c.numpy() - np.asarray(rn_j[k])) / s.item())
            np.testing.assert_array_equal(q.numpy(), q_j,
                                          err_msg=f"codes {k} step {step}")
            np.testing.assert_allclose(y.numpy(), np.asarray(y_j[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(rn.numpy(), np.asarray(rn_j[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            assert np.abs(q.numpy()).max() <= 127
            resid_p[k] = rn
            resid_j[k] = np.asarray(rn_j[k])


def test_update_caches_one_step_per_variant(setup):
    _, params, batches = setup
    model = _port_model(params)
    opt = create_multi_node_optimizer(sgd(0.1),
                                      create_communicator("xla",
                                                          device="cpu"))
    st = opt.init(model)
    loss = classification_loss(model)
    for b in batches:
        opt.update(st, b, loss, has_aux=True)
    assert len(opt._step_cache) == 1 and st.step == STEPS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(2, 10):
            opt.update(st, batches[0], loss, has_aux=True, accum_steps=1,
                       augment_seed=k)
    assert len(opt._step_cache) == 9
    assert sum("9+ distinct" in str(w.message) for w in caught) == 1
    with pytest.raises(NotImplementedError, match="item 12"):
        opt.make_train_step(loss, health_check=True)
    # Item 8's seam is ported: it takes a function of the model and
    # refuses anything else.
    assert create_multi_node_optimizer(
        sgd(0.1), None, grad_reduce=print).grad_reduce is print
    with pytest.raises(TypeError, match="grad_reduce"):
        create_multi_node_optimizer(sgd(0.1), None, grad_reduce="mean")


WORKER = textwrap.dedent("""
    import json
    import numpy as np
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (create_multi_node_optimizer,
                                                sgd)

    state = dict(np.load({params!r}))
    data = np.load({batches!r})
    batches = list(zip(data["x"], data["y"]))
    comm = create_communicator("naive", device="cpu")
    r = comm.rank
    out = {{}}
    for arm, kw in (("int8", dict(grad_compression="int8_ef")),
                    ("dbuf_int8", dict(grad_compression="int8_ef",
                                       double_buffering=True))):
        model = MLP(hidden={hid!r}, in_features={d_in!r}, device="cpu")
        model.load_state_dict({{k: __import__("torch").from_numpy(v)
                               for k, v in state.items()}})
        opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm, **kw)
        st = opt.init(model)
        for x, y in batches:
            half = slice(r * len(x) // 2, (r + 1) * len(x) // 2)
            opt.update(st, (x[half], y[half]), classification_loss(model),
                       has_aux=True)
        out[arm] = {{
            "params": {{n: p.tolist() for n, p in
                        model.state_dict().items()}},
            "resid": {{n: t.tolist() for n, t in st.ef_residual.items()}}}}
    json.dump(out, open({out!r} + f"/rank{{r}}.json", "w"))
""")



def _stacked_run(params, batches, dbuf):
    """The 2-rank run through ``int8_ef_mean`` on stacked per-rank
    gradients, in one process: the reference for the wire."""
    model = _port_model(params)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    named = list(model.named_parameters())
    resid = {n: torch.zeros((2,) + p.shape) for n, p in named}
    pending = {n: torch.zeros_like(p) for n, p in named}
    for x, y in batches:
        grads = {n: [] for n, _ in named}
        for r in range(2):
            model.zero_grad()
            half = slice(r * len(x) // 2, (r + 1) * len(x) // 2)
            F.cross_entropy(model(x[half]),
                            torch.from_numpy(y[half]).long()).backward()
            for n, p in named:
                grads[n].append(p.grad.clone())
        for n, p in named:
            mean, _, resid[n] = int8_ef_mean(torch.stack(grads[n]) + resid[n])
            if dbuf:
                p.grad, pending[n] = pending[n], mean
            else:
                p.grad = mean
        opt.step()
    return ({n: p.detach().numpy() for n, p in named},
            [{n: resid[n][r].numpy() for n, _ in named} for r in range(2)])


def test_two_gloo_ranks_int8_wire_equals_stacked_reduction(setup, tmp_path):
    _, params, batches = setup
    np.savez(tmp_path / "params.npz", **{
        n: t.numpy() for n, t in
        mlp_params_from_flax(params, device="cpu").items()})
    np.savez(tmp_path / "batches.npz", x=np.stack([b[0] for b in batches]),
             y=np.stack([b[1] for b in batches]))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(
        hid=HID, d_in=D_IN, params=str(tmp_path / "params.npz"),
        batches=str(tmp_path / "batches.npz"), out=str(tmp_path)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=str(REPO),
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for pr in procs:
        out, _ = pr.communicate(timeout=180)
        assert pr.returncode == 0, out
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for arm, dbuf in (("int8", False), ("dbuf_int8", True)):
        want_p, want_r = _stacked_run(params, batches, dbuf)
        for r in range(2):
            for k, v in want_p.items():
                np.testing.assert_allclose(got[r][arm]["params"][k], v,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{arm} rank {r} {k}")
            for k, v in want_r[r].items():
                np.testing.assert_allclose(got[r][arm]["resid"][k], v,
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{arm} rank {r} {k}")
        # The residual is each rank's own: the ranks' residuals differ.
        k = next(iter(want_r[0]))
        assert not np.array_equal(got[0][arm]["resid"][k],
                                  got[1][arm]["resid"][k])
