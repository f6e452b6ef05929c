"""The port's communicator across four gloo ranks against the JAX
package's ``XlaCommunicator`` on four of its forced CPU devices.

One job of four ranks (``torch_rank_bodies.collectives``, started once
through the port's launcher) runs every collective, the sub-grids and
``split``, the hierarchical names over two simulated hosts, the object
plane across processes, the differentiable collectives with their
gradients and the ragged functions, each on the seeded inputs of
``tests/comm_tests/test_communicator.py``,
``tests/functions_tests/test_communication_functions.py`` and
``tests/comm_tests/test_ragged.py``.  The JAX side computes the same
inputs as rankwise arrays.  Tolerances: exact for data movement (a
permutation moves bits), 1e-6 relative for sums of a few float32 terms,
and bf16's rounding (1e-2 relative) for the bf16 wire, as the reference
test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu import functions as JF
from chainermn_tpu.comm import mesh as jmesh

from chainermn_tpu_torch.comm import mesh as tmesh

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("collectives", tmp_path_factory.mktemp("coll"), N)


@pytest.fixture(scope="module")
def jcomm():
    return cmn.create_communicator("xla", devices=jax.devices()[:N])


def rankwise(comm, fn):
    return comm.shard_rankwise(np.stack([fn(r) for r in range(comm.size)]))


# -------------------------------------------------------------- grids
def test_rank_grids_match_the_jax_meshes():
    devs = jax.devices()[:8]
    for shape in ({"data": 2, "model": 4}, {"data": 4, "model": 2},
                  {"a": 2, "b": 2, "c": 2}):
        jm = cmn.hybrid_mesh(shape, devices=devs)
        tm = tmesh.hybrid_mesh(shape, size=8)
        ids = np.vectorize(lambda d: devs.index(d))(jm.devices)
        np.testing.assert_array_equal(tm.ranks, ids)
        assert tm.axis_names == tuple(jm.axis_names)
    flat = jmesh.flat_mesh(devs)
    np.testing.assert_array_equal(
        tmesh.flat_mesh(8).ranks,
        np.vectorize(lambda d: devs.index(d))(flat.devices))
    with pytest.raises(ValueError, match="needs 8"):
        tmesh.hybrid_mesh({"data": 2, "model": 4}, size=6)


def test_topology_maps_match_the_jax_topology():
    hosts = ["a", "b", "a", "b", "c", "c"]
    got = tmesh.topology(3, hosts)
    procs = {"a": 0, "b": 1, "c": 2}
    want = jmesh.Topology(rank=3, size=6, intra_rank=0, intra_size=2,
                          inter_rank=1, inter_size=3,
                          proc_of_rank=tuple(procs[h] for h in hosts),
                          procs=(0, 1, 2))
    for r in range(6):
        assert got.proc_of(r) == want.proc_of(r)
        assert got.inter_rank_of(r) == want.inter_rank_of(r)
        assert got.intra_rank_of(r) == want.intra_rank_of(r)
    for p in range(3):
        assert got.ranks_of_proc(p) == want.ranks_of_proc(p)
    # One rank per process: this rank's own position on its host.
    assert (got.intra_rank, got.intra_size, got.inter_rank,
            got.inter_size) == (1, 2, 1, 3)
    grid = tmesh.topology_mesh(["h0", "h0", "h1", "h1"])
    np.testing.assert_array_equal(grid.ranks, [[0, 1], [2, 3]])
    np.testing.assert_array_equal(grid.lines(("intra",)), [[0, 1], [2, 3]])
    np.testing.assert_array_equal(grid.lines(("inter",)), [[0, 2], [1, 3]])
    assert tmesh.topology_mesh(["a", "a", "b"]).ranks.shape == (3, 1)


# -------------------------------------------------- gradient all-reduce
@pytest.mark.parametrize("name", ["xla", "naive", "hierarchical",
                                  "two_dimensional"])
def test_allreduce_grad_mean(ranks, name):
    mean_w = np.mean([np.full((4, 3), float(r + 1)) for r in range(N)], 0)
    mean_b = np.mean([np.arange(5.0) * (r + 1) for r in range(N)], 0)
    for r in range(N):
        w, b = ranks[r][f"grad_{name}"]
        np.testing.assert_allclose(w, mean_w, rtol=1e-6)
        np.testing.assert_allclose(b, mean_b, rtol=1e-6)


def test_hierarchical_names_build_host_levels(ranks):
    """Two simulated hosts of two ranks: intra groups [0, 1] and [2, 3],
    inter groups [0, 2] and [1, 3]; the flat names see one host."""
    for name in ("hierarchical", "two_dimensional"):
        for r in range(N):
            intra, inter = ranks[r][f"levels_{name}"]
            assert intra == ((0, 1) if r < 2 else (2, 3))
            assert inter == ((0, 2) if r % 2 == 0 else (1, 3))
            assert ranks[r][f"topo_{name}"] == (r % 2, 2, r // 2, 2)
    for r in range(N):
        assert ranks[r]["topo_xla"] == (r, N, 0, 1)


def test_dummy_keeps_local_grads_and_bf16_wire_rounds(ranks, jcomm):
    for r in range(N):
        w, _ = ranks[r]["grad_dummy"]
        np.testing.assert_array_equal(w, np.full((4, 3), float(r + 1)))
    jwire = cmn.create_communicator("pure_nccl", devices=jax.devices()[:N],
                                    allreduce_grad_dtype="bfloat16")
    want = np.asarray(jwire.allreduce_grad(
        rankwise(jwire, lambda r: np.full((8, 8), float(r), np.float32))))
    for r in range(N):
        assert ranks[r]["grad_bf16"].dtype == np.float32
        np.testing.assert_allclose(ranks[r]["grad_bf16"], want[r],
                                   rtol=1e-2)


# ----------------------------------------------------------- array plane
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_allreduce_ops_match_jax(ranks, jcomm, op):
    want = np.asarray(jcomm.allreduce(
        rankwise(jcomm, lambda r: np.float32([r])), op=op))
    for r in range(N):
        np.testing.assert_allclose(ranks[r]["allreduce"][op], want[r],
                                   rtol=1e-6)


@pytest.mark.parametrize("root", [0, 3])
def test_bcast_data_matches_jax(ranks, jcomm, root):
    want = np.asarray(jcomm.bcast_data(rankwise(
        jcomm, lambda r: np.full((2, 2), float(r + 10), np.float32)),
        root=root))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r][f"bcast_data_{root}"],
                                      want[r])


def test_alltoall_allgather_scatter_gather_match_jax(ranks, jcomm):
    a2a = np.asarray(jcomm.alltoall(rankwise(
        jcomm, lambda r: np.array([[r * 10 + j] for j in range(N)],
                                  np.float32))))
    ag = np.asarray(jcomm.allgather(rankwise(
        jcomm, lambda r: np.float32([r, -r]))))
    rows = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    sc = np.asarray(jcomm.scatter(rankwise(
        jcomm, lambda r: rows if r == 2 else np.zeros_like(rows)), root=2))
    ga = np.asarray(jcomm.gather(rankwise(
        jcomm, lambda r: np.float32([r, 2 * r])), root=2))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["alltoall"], a2a[r])
        np.testing.assert_array_equal(ranks[r]["allgather"], ag[r])
        np.testing.assert_array_equal(ranks[r]["scatter"], sc[r])
        # The JAX gather hands every slot the stack; the port's root has
        # it and the other ranks None.
        if r == 2:
            np.testing.assert_array_equal(ranks[r]["gather"], ga[r])
        else:
            assert ranks[r]["gather"] is None
        assert (ranks[r]["reduce"] is None) == (r != 1)
    np.testing.assert_array_equal(ranks[1]["reduce"], [10.0])


def test_permute_and_send_match_jax(ranks, jcomm):
    x = rankwise(jcomm, lambda r: np.float32([r + 1]))
    perm = np.asarray(jcomm.permute(x, [(0, 3), (3, 0)]))
    send = np.asarray(jcomm.send(x, dest=2, source=1))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["permute"], perm[r])
        np.testing.assert_array_equal(ranks[r]["send"], send[r])


def test_split_and_sub_match_jax(ranks, jcomm):
    """``split`` by color with descending keys orders each color's ranks
    by key, as MPI_Comm_split (and the JAX package) does; ``sub`` over a
    2 × 2 grid gives the lines of the JAX ``sub``."""
    jsubs = jcomm.split([r % 2 for r in range(N)], key=[-r for r in range(N)])
    devs = list(jcomm.mesh.devices.reshape(-1))
    for c, sub in jsubs.items():
        members = tuple(devs.index(d) for d in sub.mesh.devices.reshape(-1))
        for r in range(N):
            got_members, got_rank = ranks[r]["split"][c]
            assert got_members == members
            assert got_rank == (members.index(r) if r in members else -1)
    for r in range(N):
        # Each color's ranks sum their sub-ranks: 0 + 1.
        np.testing.assert_array_equal(ranks[r]["split_sum"], [1.0])
        assert "not a member" in ranks[r]["split_other"]
    jgrid = cmn.XlaCommunicator(cmn.hybrid_mesh(
        {"data": 2, "model": 2}, devices=jax.devices()[:N]))
    assert jgrid.sub("data").size == 2 and jgrid.sub("model").size == 2
    for r in range(N):
        dm, dr, mm, mr = ranks[r]["grid"]
        assert dm == ((0, 2) if r % 2 == 0 else (1, 3))
        assert mm == ((0, 1) if r < 2 else (2, 3))
        assert (dr, mr) == (r // 2, r % 2)
        dsum, msum = ranks[r]["grid_sum"]
        np.testing.assert_array_equal(dsum, [sum(dm)])
        np.testing.assert_array_equal(msum, [sum(mm)])


# ---------------------------------------------------------- object plane
def test_object_plane_across_processes(ranks):
    for r in range(N):
        src = (r - 1) % N
        assert ranks[r]["ring_obj"] == (src, 3 + 3 * src)
        assert ranks[r]["self_obj"] == ("self", r)
        assert 0.2 <= ranks[r]["timeout"] < 5.0
        assert len(ranks[r]["range"]) == 2
        assert all("out of range" in m for m in ranks[r]["range"])
    # Demux on the exact (source, dest) pair, FIFO per pair.
    assert ranks[3]["fifo"] == ["from-2", "from-1-a", "from-1-b"]


def test_nccl_refuses_two_ranks_on_one_card(ranks):
    for r in range(N):
        msg = ranks[r]["same_card"]
        assert "same card" in msg and "naive" in msg, msg


def test_a_refused_nccl_check_leaves_no_group(ranks):
    """The check runs on the rendezvous store before any group exists,
    so a refused rank can still make a working gloo default group."""
    for r in range(N):
        assert ranks[r]["group_after_refusal"] is False
        assert ranks[r]["default_backend"] == "gloo"


# ------------------------------------------------ differentiable (F.*)
def _spmd(comm, body, *args, out_specs=None):
    spec = P(comm.axes)
    return comm.spmd(body, in_specs=tuple(spec for _ in args),
                     out_specs=spec if out_specs is None else out_specs,
                     check_vma=True)(*args)


def _grad(comm, body, x):
    """Gradient of ``psum(body(x_local, rank))`` over the rankwise x: the
    sum of every rank's own loss, as each port rank backprops its own."""
    def loss(x):
        def inner(t):
            return jax.lax.psum(body(t[0], comm.axis_index()),
                                comm.axis_name)
        return jnp.sum(comm.spmd(inner, in_specs=P(comm.axes),
                                 out_specs=P(), check_vma=True)(x))
    return np.asarray(jax.grad(loss)(x))


def test_differentiable_collectives_match_jax(ranks, jcomm):
    c = jcomm
    xs = np.array([[[100.0 * r + j] for j in range(N)] for r in range(N)],
                  np.float32)
    f = np.asarray(_spmd(c, lambda t: JF.alltoall(c, t[0])[None], xs))
    g = _grad(c, lambda t, i: jnp.sum(JF.alltoall(c, t)) * (i == 3), xs)
    v = np.array([[r, 1.0 + r] for r in range(N)], np.float32)
    A = np.arange(2.0 * N, dtype=np.float32).reshape(N, 2)
    fg = np.asarray(_spmd(c, lambda t: JF.allgather(c, t[0])[None], v))
    gg = _grad(c, lambda t, i: jnp.sum(JF.allgather(c, t) * A * (i + 1)), v)
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["f_alltoall"], f[r])
        np.testing.assert_array_equal(ranks[r]["g_alltoall"], g[r])
        np.testing.assert_array_equal(ranks[r]["f_allgather"], fg[r])
        np.testing.assert_allclose(ranks[r]["g_allgather"], gg[r],
                                   rtol=1e-6)
    for op in ("sum", "mean"):
        fa = np.asarray(_spmd(c, lambda t: JF.allreduce(c, t, op=op), v))
        ga = _grad(c, lambda t, i: jnp.sum(JF.allreduce(c, t, op=op)
                                           * (i + 1.0)), v)
        for r in range(N):
            np.testing.assert_allclose(ranks[r][f"f_allreduce_{op}"],
                                       fa[r], rtol=1e-6)
            np.testing.assert_allclose(ranks[r][f"g_allreduce_{op}"],
                                       ga[r], rtol=1e-6)
    b = np.arange(N, dtype=np.float32)[:, None] + 1
    fb = np.asarray(_spmd(c, lambda t: JF.bcast(c, t[0], root=2)[None], b))
    gb = _grad(c, lambda t, i: jnp.sum(JF.bcast(c, t, root=2)), b)
    ggat = _grad(c, lambda t, i: jnp.sum(JF.gather(c, t, root=0) * A)
                 * (i == 0), v)
    rows = np.broadcast_to(A, (N, N, 2)).copy()
    fs = np.asarray(_spmd(c, lambda t: JF.scatter(c, t[0], root=0)[None],
                          rows))
    gs = _grad(c, lambda t, i: jnp.sum(JF.scatter(c, t, root=0) * (i + 1.0)),
               rows)
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["f_bcast"], fb[r])
        np.testing.assert_array_equal(ranks[r]["g_bcast"], gb[r])
        np.testing.assert_array_equal(ranks[r]["g_gather"], ggat[r])
        np.testing.assert_array_equal(ranks[r]["f_scatter"], fs[r])
        # Only root's rows feed the scatter: its gradient is JAX's row
        # 0; the other ranks' inputs get zeros there as here.
        np.testing.assert_array_equal(ranks[r]["g_scatter"], gs[r])
    fga = np.asarray(_spmd(c, lambda t: JF.gather(c, t[0], root=0)[None],
                           v))
    np.testing.assert_array_equal(ranks[0]["f_gather"], fga[0])
    for r in range(1, N):
        assert ranks[r]["f_gather"].shape == (0,)


# ------------------------------------------------------------------ ragged
def test_ragged_functions_match_jax(ranks, jcomm):
    rng = np.random.RandomState(0)
    rows = [rng.normal(size=(7 + 13 * r, 3)).astype(np.float32)
            for r in range(N)]
    ring = cmn.ragged_permute(jcomm, rows, [(r, (r + 1) % N)
                                            for r in range(N)],
                              bucket_width=32)
    edge = cmn.ragged_permute(
        jcomm, [np.full((5,), float(r), np.float32) for r in range(N)],
        [(0, 1)], bucket_width=16)
    payload = np.arange(37, dtype=np.int32)
    sent = cmn.ragged_send(jcomm, payload, dest=3, source=1, bucket_width=16)
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["ragged_ring"], ring[r])
        np.testing.assert_array_equal(ranks[r]["ragged_edge"], edge[r])
        assert ranks[r]["ragged_edge"].shape == edge[r].shape
        assert "trailing" in ranks[r]["ragged_bad"]
    np.testing.assert_array_equal(ranks[3]["ragged_send"], sent)
    assert ranks[0]["ragged_send"].shape == (0,)
    # The variable-length all-reduce against numpy: rows zero-padded to
    # the longest, summed.
    hists = [ranks[r]["ragged_hist"] for r in range(N)]
    want = np.zeros(max(len(h) for h in hists), np.int64)
    for h in hists:
        want[:len(h)] += h
    assert len({len(h) for h in hists}) > 1
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["ragged_allreduce"], want)


def test_round_up_to_bucket_matches_jax():
    from chainermn_tpu_torch.comm import round_up_to_bucket

    for n, w in ((0, 128), (1, 128), (128, 128), (129, 128), (37, 16)):
        assert round_up_to_bucket(n, w) == cmn.comm.round_up_to_bucket(n, w)
    with pytest.raises(ValueError):
        round_up_to_bucket(5, 0)
