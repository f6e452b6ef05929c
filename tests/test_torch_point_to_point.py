"""The port's point-to-point functions across four gloo ranks against the
JAX package's (``tests/functions_tests/test_communication_functions.py``).

One job of four ranks (``torch_rank_bodies.p2p``) runs the SPMD form of
``send``/``recv`` (every rank calls it, as in the JAX package),
``pseudo_connect``, ``shift`` and its gradient, the reference's MPMD form
(only the sender calls ``send``, only the receiver ``recv``; the
gradient comes back through the delegate), and a 3-stage ring backward
twice: through the port's posted pairs, and through a blocking
send-then-receive on a gloo group with a 3 s timeout, which deadlocks.
Values are exact: the functions move bits and scale by small integers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu import functions as JF

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("p2p", tmp_path_factory.mktemp("p2p"), N)


def _comm(n=N):
    return cmn.create_communicator("xla", devices=jax.devices()[:n])


def _spmd(comm, body, x):
    spec = P(comm.axes)
    return np.asarray(comm.spmd(body, in_specs=(spec,), out_specs=spec,
                                check_vma=True)(x))


def _grad(comm, body, x):
    def loss(x):
        def inner(t):
            return jax.lax.psum(body(t, comm.axis_index()), comm.axis_name)
        return jnp.sum(comm.spmd(inner, in_specs=P(comm.axes),
                                 out_specs=P(), check_vma=True)(x))
    return np.asarray(jax.grad(loss)(x))


def test_spmd_send_recv_forward_and_gradient(ranks):
    c = _comm()
    x = np.arange(N, dtype=np.float32)[:, None] + 1

    def fwd(t):
        d = JF.send(t, c, rank=3, rank_src=1)
        return JF.recv(c, rank=1, delegate_variable=d)

    want = _spmd(c, fwd, x)
    g = _grad(c, lambda t, i: jnp.sum(JF.recv(
        c, 0, JF.send(t * 2.0, c, rank=3, rank_src=0))) * (i == 3),
        np.ones((N, 3), np.float32))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["spmd_fwd"], want[r:r + 1])
        np.testing.assert_array_equal(ranks[r]["spmd_grad"], g[r:r + 1])
    # The JAX package's check of the delegate's source, word for word.
    d = JF.DelegateVariable(None, 1, 3)
    with pytest.raises(ValueError) as e:
        JF.recv(c, rank=2, delegate_variable=d)
    for r in range(N):
        assert ranks[r]["spmd_wrong_src"] == str(e.value)


def test_pseudo_connect_and_shift_match_jax(ranks):
    c = _comm()
    ones = np.ones((N, 2), np.float32)
    pseudo = _spmd(c, lambda t: JF.pseudo_connect(
        JF.send(t, c, rank=1, rank_src=0), t * 3.0), ones)
    x = np.arange(N, dtype=np.float32)[:, None]
    nowrap = _spmd(c, lambda t: JF.shift(t, c, offset=1, wrap=False), x)
    g = _grad(c, lambda t, i: jnp.sum(JF.shift(t, c, offset=1) * (i + 1.0)),
              x)
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["pseudo"], pseudo[r:r + 1])
        np.testing.assert_array_equal(ranks[r]["shift_nowrap"], nowrap[r])
        np.testing.assert_array_equal(ranks[r]["shift_grad"], g[r])


def test_mpmd_send_recv_gradient_comes_back_through_the_delegate(ranks):
    """Rank 0 sends 2·v to rank 3 and backprops only its delegate; rank 3
    receives and backprops sum(h²): rank 0's gradient is JAX's for the
    same edge, 8·v."""
    c = _comm()
    v = np.array([[[r + 0.5, -1.0]] for r in range(N)], np.float32)
    g = _grad(c, lambda t, i: jnp.sum(JF.send_recv(t[0] * 2.0, c, [(0, 3)])
                                      ** 2) * (i == 3), v)
    assert ranks[0]["mpmd_delegate"] == (0,)
    np.testing.assert_array_equal(ranks[3]["mpmd_recv"], 2.0 * v[0])
    np.testing.assert_array_equal(ranks[0]["mpmd_grad"], g[0])
    for r in (1, 2, 3):
        assert ranks[r]["mpmd_grad"] is None
        np.testing.assert_array_equal(g[r], 0.0)


def test_three_stage_ring_backward_cannot_deadlock(ranks):
    """The wrapped shift's backward over 3 ranks: each rank sends its
    gradient to one neighbour and receives from the other.  The port's
    posted pairs complete with JAX's gradient; the same exchange as a
    blocking send followed by a blocking receive waits on itself until
    the group's 3 s timeout."""
    c = _comm(3)
    x = np.arange(3, dtype=np.float32)[:, None]
    g = _grad(c, lambda t, i: jnp.sum(JF.shift(t, c, offset=1) * (i + 1.0)),
              x)
    for r in range(3):
        np.testing.assert_array_equal(ranks[r]["ring_grad"], g[r])
        kind, waited, msg = ranks[r]["blocking"]
        assert kind == "deadlock" and waited >= 2.5, ranks[r]["blocking"]
    assert "blocking" not in ranks[3]
