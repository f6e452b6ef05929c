"""The port's ``MultiNodeChainList`` against the JAX package's
(``tests/links_tests/test_chain_list.py``).

The edge checks run in this process and must raise the JAX package's
messages.  One job of four gloo ranks (``torch_rank_bodies.chain``) runs
three chains on the JAX test's seeded weights: the 3-stage tanh MLP over
ranks 0 → 1 → 2, the 2-link chain 0 → 3, and a 4-stage chain that
revisits rank 0 (0 → 1 → 0 → 2, output sent back to rank 1), forward and
backward.  Each rank builds only its own links.  Every rank backprops the
broadcast output's loss, so the port's stage gradients are ``N`` times
the one-process gradient (the transposed broadcast sums the ranks'
copies); the 4-stage chain's loss lives on rank 1 alone and its
gradients equal the one-process ones.  Tolerance: atol 1e-5 (float32
tanh chains of a few products, JAX's test uses 1e-4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu import functions as JF
from chainermn_tpu.links import MultiNodeChainList as JaxChain

from chainermn_tpu_torch.links import MultiNodeChainList

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 4
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("chain", tmp_path_factory.mktemp("chain"), N)


class _Rank0:
    rank, size = 0, N


BAD = {
    "broken": [(0, None, None), (1, None, None)],
    "rank_in": [(0, None, None), (1, 2, None)],
    "rank_out": [(0, None, 2), (1, None, None)],
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_edge_checks_raise_the_jax_messages(case):
    jchain = JaxChain(None)
    for rank, rin, rout in BAD[case]:
        jchain.add_link(lambda p, x: x, rank=rank, rank_in=rin,
                        rank_out=rout)
    with pytest.raises(ValueError) as want:
        jchain([None] * len(BAD[case]), jnp.zeros(2))
    chain = MultiNodeChainList(_Rank0())
    links = BAD[case]
    with pytest.raises(ValueError) as got:
        for rank, rin, rout in links:
            chain.add_link(lambda: __import__("torch").nn.Identity(),
                           rank=rank, rank_in=rin, rank_out=rout)
    assert str(got.value) == str(want.value)


def _weights(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=s).astype(np.float32) * 0.5 for s in shapes]


def _oracle(ws, x):
    h = x
    for w in ws:
        h = jnp.tanh(h @ w)
    return h


def test_three_stage_chain_matches_jax_and_oracle(ranks):
    w0, w1, w2, x = _weights(0, [(4, 8), (8, 8), (8, 2), (16, 4)])
    x = x * 2.0  # the ranks' input is the fourth draw, unscaled
    comm = cmn.create_communicator("xla", devices=jax.devices()[:N])
    chain = JaxChain(comm)
    stage = lambda p, h: jnp.tanh(h @ p)  # noqa: E731
    chain.add_link(stage, rank=0, rank_in=None, rank_out=1)
    chain.add_link(stage, rank=1, rank_in=0, rank_out=2)
    chain.add_link(stage, rank=2, rank_in=1, rank_out=None)
    jout = np.asarray(jax.jit(comm.spmd(
        lambda a, b, c, xx: JF.bcast(comm, chain([a, b, c], xx), root=2),
        in_specs=(P(),) * 4, out_specs=P(), check_vma=False))(
        w0, w1, w2, x))
    oracle = np.asarray(_oracle([w0, w1, w2], x))
    g = jax.grad(lambda ws: jnp.sum(_oracle(ws, x) ** 2))([w0, w1, w2])
    np.testing.assert_allclose(jout, oracle, **TOL)
    for r in range(N):
        np.testing.assert_allclose(ranks[r]["chain3"], jout, **TOL)
        # Each rank built its own link only.
        assert ranks[r]["built"] == ([w.shape for w in (w0, w1, w2)][r:r + 1]
                                     if r < 3 else [])
        grads = ranks[r]["chain3_grads"]
        if r < 3:
            np.testing.assert_allclose(grads["stages.0.w"] / N,
                                       np.asarray(g[r]), **TOL)
        else:
            assert grads == {} and ranks[r]["n_params"] == 0
    assert ranks[2]["chain3_local"] == (16, 2)
    assert ranks[0]["chain3_local"] == ranks[1]["chain3_local"] == (0,)
    assert ranks[3]["chain3_local"] is None


def test_two_link_chain_gradients_match_jax(ranks):
    """The JAX test's 0 → 3 chain: stage gradients on their owners."""
    rng = np.random.RandomState(1)
    v0 = rng.normal(size=(4, 6)).astype(np.float32) * 0.5
    v1 = rng.normal(size=(6, 3)).astype(np.float32) * 0.5
    x = rng.normal(size=(8, 4)).astype(np.float32)
    g = jax.grad(lambda ws: jnp.sum(_oracle(ws, x) ** 2))([v0, v1])
    np.testing.assert_allclose(ranks[0]["chain2_grads"]["stages.0.w"] / N,
                               np.asarray(g[0]), **TOL)
    np.testing.assert_allclose(ranks[3]["chain2_grads"]["stages.0.w"] / N,
                               np.asarray(g[1]), **TOL)
    assert ranks[1]["chain2_grads"] == ranks[2]["chain2_grads"] == {}


def test_four_stage_chain_revisiting_a_rank(ranks):
    """0 → 1 → 0 → 2 and the output back to rank 1: rank 0 sends, then
    receives (joined to its first send's delegate), then sends again; the
    backward runs the mirror order through the posted pairs."""
    ws = [np.random.RandomState(10 + i).normal(size=(4, 4)).astype(
        np.float32) * 0.6 for i in range(4)]
    x = _weights(0, [(4, 8), (8, 8), (8, 2), (16, 4)])[3] * 2.0
    out = np.asarray(_oracle(ws, x))
    g = jax.grad(lambda w: jnp.sum(_oracle(w, x) ** 2))(ws)
    np.testing.assert_allclose(ranks[1]["chain4_out"], out, **TOL)
    owners = [0, 1, 0, 2]
    for r in range(3):
        mine = [i for i, o in enumerate(owners) if o == r]
        got = ranks[r]["chain4_grads"]
        assert len(got) == len(mine)
        for k, i in enumerate(mine):
            np.testing.assert_allclose(got[f"stages.{k}.w"],
                                       np.asarray(g[i]), **TOL)
    assert ranks[3]["chain4_grads"] == {}
