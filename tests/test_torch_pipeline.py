"""The port's GPipe pipelines against the JAX package's
(``tests/links_tests/test_chain_list.py``'s pipeline tests,
``test_hetero_pipeline.py`` and ``test_hetero_sharded.py``).

One job of four gloo ranks (``torch_rank_bodies.pipeline``) runs, on the
JAX tests' seeded inputs: the homogeneous ``PipelineChain`` forward and
its gradients with 2 and 4 microbatches over 4 stages (each stage
sleeping a random 0-20 ms per microbatch in its forward and backward, so
the ranks reach the microbatches in scrambled order: gradients paired by
arrival instead of by microbatch would come out wrong) and with 3
microbatches over 3 stages; ``HeteroPipelineChain``'s replicated and
stage-sharded tiers, forward, gradients and the unshard round trip;
``MultiNodeChainList.to_pipeline``; VGG-11's ``build_hetero_pipeline``
on the JAX package's Flax parameters, then two SGD-momentum steps under
``model_parallel_grad_reduce``.  The JAX side runs on four of its forced
CPU devices.  Every stage rank backprops the broadcast output's loss, so
the port's stage gradients are ``4 x`` (``3 x`` on three stages) the
one-process gradient; the tests divide.  Tolerances: float32 tanh chains
atol 1e-5 (the JAX tests: 1e-4 forward, 2e-4 gradients); VGG logits
atol/rtol 2e-5 (the JAX test's), its gradients 1e-5 of each leaf's
largest magnitude, its parameters after two steps atol 2e-5 + rtol 1e-4
(as ``test_torch_vgg_model_parallel.py``).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu.links import HeteroPipelineChain as JaxHetero
from chainermn_tpu.links import PipelineChain as JaxPipe
from chainermn_tpu.models.vgg import (
    apply_sequential,
    build_hetero_pipeline,
    init_stage_params,
    vgg_stage_modules,
)

from chainermn_tpu_torch.links import HeteroPipelineChain, MultiNodeChainList

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

S = 4
TOL = dict(atol=1e-5, rtol=1e-5)
VGG = dict(cfg="vgg11", num_classes=10, n_stages=S, width_mult=0.125)
LR = 0.1


def _vgg_setup():
    modules = vgg_stage_modules(VGG["cfg"], num_classes=VGG["num_classes"],
                                n_stages=S, width_mult=VGG["width_mult"])
    x = np.random.RandomState(3).normal(size=(16, 32, 32, 3)).astype(
        np.float32)
    y = (np.arange(16) % VGG["num_classes"]).astype(np.int32)
    params = init_stage_params(modules, jax.random.PRNGKey(0), x[:1])
    return modules, jax.tree_util.tree_map(np.asarray, params), x, y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    _, params, x, y = _vgg_setup()
    with open(out / "pipeline_inputs.pkl", "wb") as f:
        pickle.dump({"vgg": VGG, "vgg_params": params, "vgg_x": x,
                     "vgg_y": y, "lr": LR}, f)
    return run_ranks("pipeline", out, S)


@pytest.fixture(scope="module")
def jcomm():
    return cmn.create_communicator("xla", devices=jax.devices()[:S])


def _chain(ws, x):
    h = x
    for w in ws:
        h = jnp.tanh(h @ w)
    return h


def _homogeneous(seed, d, B):
    rng = np.random.RandomState(seed)
    st = (rng.normal(size=(S, d, d)).astype(np.float32)
          * (0.5 / np.sqrt(d))).astype(np.float32)
    return st, rng.normal(size=(B, d)).astype(np.float32)


def test_pipeline_chain_matches_sequential(ranks, jcomm):
    st, x = _homogeneous(2, 16, 32)
    pipe = JaxPipe(lambda p, h: jnp.tanh(h @ p[0]), jcomm, n_microbatches=4)
    jout = np.asarray(jax.jit(jcomm.spmd(
        lambda p, xx: pipe(p, xx), in_specs=(P(jcomm.axes), P()),
        out_specs=P(), check_vma=False))(st, x))
    np.testing.assert_allclose(jout, np.asarray(_chain(st, x)), atol=1e-4)
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["pipe_fwd"], jout, **TOL)


@pytest.mark.parametrize("M", [2, 4])
def test_pipeline_chain_gradients(ranks, M):
    """Four stages, ``M`` microbatches in scrambled wall-clock order,
    against the sequential gradients the JAX test holds its pipeline to
    (``test_pipeline_chain_gradients``)."""
    st, x = _homogeneous(3, 8, 16)
    og, ox = jax.grad(lambda w, xx: jnp.sum(_chain(w, xx) ** 2),
                      argnums=(0, 1))(st, x)
    for r in range(S):
        np.testing.assert_allclose(ranks[r][f"pipe_grad_m{M}"] / S,
                                   np.asarray(og[r]), **TOL)
    np.testing.assert_allclose(ranks[0][f"pipe_dx_m{M}"] / S,
                               np.asarray(ox), **TOL)


def test_pipeline_three_stages_three_microbatches(ranks):
    st, x = _homogeneous(3, 8, 16)
    x = x[:12]
    out = np.asarray(_chain(st[:3], x))
    g = jax.grad(lambda w: jnp.sum(_chain(w, x) ** 2))(st[:3])
    for r in range(3):
        np.testing.assert_allclose(ranks[r]["pipe3_out"], out, **TOL)
        np.testing.assert_allclose(ranks[r]["pipe3_grad"] / 3,
                                   np.asarray(g[r]), **TOL)
    assert "pipe3_out" not in ranks[3]


def _hetero_mlp():
    dims = [16, 16, 32, 8, 24][:S + 1]
    rng = np.random.RandomState(0)
    params = [(rng.normal(size=(dims[s], dims[s + 1]))
               * (0.7 / np.sqrt(dims[s]))).astype(np.float32)
              for s in range(S)]
    io = [((dims[s],), (dims[s + 1],)) for s in range(S)]
    return params, io, dims


def _x(seed, dims):
    return np.random.RandomState(seed).normal(size=(32, dims[0])).astype(
        np.float32)


def test_hetero_forward_matches_sequential(ranks, jcomm):
    params, io, dims = _hetero_mlp()
    x = _x(1, dims)
    pipe = JaxHetero(jcomm, [lambda p, h: jnp.tanh(h @ p)] * S, io,
                     n_microbatches=4)
    jout = np.asarray(pipe.as_spmd_fn()(params, x))
    np.testing.assert_allclose(jout, np.asarray(_chain(params, x)), **TOL)
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["hetero_fwd"], jout, **TOL)


def test_hetero_gradients_match_sequential(ranks):
    """Against the sequential gradients, as the JAX test holds its
    pipeline."""
    params, io, dims = _hetero_mlp()
    x = _x(2, dims)
    g = jax.grad(lambda pl: jnp.sum(_chain(pl, x) ** 2))(params)
    for r in range(S):
        got = ranks[r]["hetero_grads"]
        # Only this rank's own stage gets a gradient.
        assert [a is not None for a in got] == [s == r for s in range(S)]
        np.testing.assert_allclose(got[r] / S, np.asarray(g[r]), **TOL)


class _Comm:
    """A stand-in for the checks that run before any communication."""

    device = torch.device("cpu")

    def __init__(self, rank=0, size=S):
        self.rank, self.size = rank, size

    def wait_pending(self):
        pass


def test_hetero_io_shapes_validated(jcomm):
    stages = [lambda p, h: h] * S
    io = [((4,), (8,))] * S
    for cls, comm in ((JaxHetero, jcomm), (HeteroPipelineChain, _Comm())):
        with pytest.raises(ValueError, match="outputs"):
            cls(comm, stages, io, n_microbatches=2)
        with pytest.raises(ValueError, match="io_shapes"):
            cls(comm, stages, io[:-1], n_microbatches=2)


def test_hetero_stage_outputs_are_checked_against_io_shapes():
    """A stage whose output differs from its ``io_shapes`` entry raises
    (the JAX package pads every boundary into one flat buffer; the port's
    boundaries carry their true shapes)."""
    pipe = HeteroPipelineChain(_Comm(0, 1), [lambda p, h: h @ p],
                               [((4,), (3,))], n_microbatches=2)
    with pytest.raises(ValueError, match="io_shapes says"):
        pipe([torch.zeros(4, 5)], torch.zeros(4, 4))
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        pipe([torch.zeros(4, 3)], torch.zeros(3, 4))


def test_chain_list_to_pipeline_lowering(ranks, jcomm):
    params, io, dims = _hetero_mlp()
    x = _x(2, dims)
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["lowered_fwd"],
                                   np.asarray(_chain(params, x)), **TOL)
        assert ranks[r]["lowered_params"] == params[r].size
    # Non-linear chains are refused, with the JAX package's messages.
    cases = {
        "rank reuse": [dict(rank=0)] * S,
        "size": [dict(rank=s, rank_out=s + 1 if s < S - 2 else None)
                 for s in range(S - 1)],
        "terminal send": [dict(rank=s, rank_out=s + 1) for s in range(S)],
    }
    from chainermn_tpu.links import MultiNodeChainList as JaxChain

    for name, links in cases.items():
        msgs = []
        for cls, comm in ((JaxChain, jcomm), (MultiNodeChainList, _Comm())):
            chain = cls(comm)
            try:
                for kw in links:
                    chain.add_link(torch.nn.Identity() if cls is
                                   MultiNodeChainList else (lambda p, h: h),
                                   **kw)
                chain.to_pipeline(io, n_microbatches=4)
            except ValueError as e:
                msgs.append(str(e))
        assert len(msgs) == 2 and msgs[0] == msgs[1], (name, msgs)


def test_sharded_forward_matches_sequential_and_replicated(ranks):
    params, io, dims = _hetero_mlp()
    out = np.asarray(_chain(params, _x(1, dims)))
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["sharded_fwd"], out, **TOL)
        np.testing.assert_array_equal(ranks[r]["sharded_fwd"],
                                      ranks[r]["hetero_fwd"])


def test_sharded_grads_match_sequential(ranks):
    params, io, dims = _hetero_mlp()
    x = _x(2, dims)
    g = jax.grad(lambda pl: jnp.sum(_chain(pl, x) ** 2))(params)
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["row_grad"][0] / S,
                                   np.asarray(g[r]).ravel(), **TOL)


def test_each_rank_holds_only_its_own_stage(ranks):
    """The JAX package's stage-sharded memory property: rank ``s`` holds
    stage ``s``'s parameters only (the flat row, the lowered chain, the
    VGG pipeline's module)."""
    params, _, _ = _hetero_mlp()
    modules, vparams, _, _ = _vgg_setup()
    sizes = [sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(p))
             for p in vparams]
    for r in range(S):
        assert ranks[r]["row_shape"] == (1, params[r].size)
        assert ranks[r]["lowered_params"] == params[r].size
        assert ranks[r]["vgg_params_held"] == sizes[r]
    assert sum(sizes) == sum(r["vgg_params_held"] for r in ranks)


def test_unshard_roundtrip(ranks):
    params, _, _ = _hetero_mlp()
    for r in range(S):
        back = ranks[r]["unshard"]
        assert len(back) == S
        for a, b in zip(back, params):
            np.testing.assert_array_equal(a, b)


def test_shard_params_validates(jcomm):
    params, io, dims = _hetero_mlp()
    fn = [lambda p, h: h] * (2 * S)
    io2 = [((16,), (16,))] * (2 * S)
    with pytest.raises(ValueError, match="must match"):
        JaxHetero(jcomm, fn, io2, 2).shard_params([params[0]] * (2 * S))
    with pytest.raises(ValueError, match="must match"):
        HeteroPipelineChain(_Comm(), fn, io2, 2).shard_params(
            [params[0]] * (2 * S))
    mixed = [{"a": params[s], "b": params[s].astype(np.float64)}
             for s in range(S)]
    pipe = HeteroPipelineChain(_Comm(), [lambda p, h: h] * S, io, 2)
    with pytest.raises(ValueError, match="mixes dtypes"):
        pipe.shard_params(mixed)
    with pytest.raises(ValueError, match="shard_params"):
        pipe.apply_sharded(torch.zeros(1, 8), torch.zeros(4, 16))


@pytest.fixture(scope="module")
def vgg_ref():
    """The sequential JAX VGG-11 (jitted): logits, each stage's gradient
    of the mean cross-entropy, the losses and parameters of two optax
    SGD-momentum steps."""
    modules, params, x, y = _vgg_setup()

    @jax.jit
    def loss(ps):
        logits = apply_sequential(modules, ps, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (_, logits), g = jax.value_and_grad(loss, has_aux=True)(params)
    tx = optax.sgd(LR, momentum=0.9)
    state, ps, losses = tx.init(params), params, []
    for _ in range(2):
        (value, _), gs = jax.value_and_grad(loss, has_aux=True)(ps)
        losses.append(float(value))
        upd, state = tx.update(gs, state, ps)
        ps = optax.apply_updates(ps, upd)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(modules=modules, x=x, logits=np.asarray(logits),
                grads=np_(g), losses=losses, after=np_(ps))


def test_vgg_hetero_pipeline_matches_sequential(ranks, jcomm, vgg_ref):
    """VGG-11 with 4-D conv activations and a dense head: the pipeline's
    stage shapes are the JAX pipeline's, its logits the sequential JAX
    network's (the JAX test's oracle for its pipeline), and each stage's
    gradient the sequential loss's."""
    pipe = build_hetero_pipeline(vgg_ref["modules"], jcomm,
                                 vgg_ref["x"][:1], n_microbatches=4)
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["vgg_logits"],
                                   vgg_ref["logits"], atol=2e-5, rtol=2e-5)
        assert ranks[r]["vgg_io"] == pipe.io_shapes
        got, want = ranks[r]["vgg_grads"], vgg_ref["grads"][r]
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a / S, b, atol=1e-5 * np.abs(b).max(),
                                       rtol=0)


def test_vgg_pipeline_sgd_steps_match_jax(ranks, vgg_ref):
    """Two SGD-momentum steps through the pipeline under
    ``model_parallel_grad_reduce`` leave every stage where two optax
    steps of the sequential network leave it."""
    for r in range(S):
        np.testing.assert_allclose(ranks[r]["vgg_losses"],
                                   vgg_ref["losses"], rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(ranks[r]["vgg_after"]),
                        jax.tree_util.tree_leaves(vgg_ref["after"][r])):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)
