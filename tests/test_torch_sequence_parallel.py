"""The port's sequence and expert parallelism against the JAX package's
(``tests/parallel_tests/test_sequence_parallel.py``, ``test_zigzag.py``
and ``test_moe.py``).

One job of four gloo ranks (``torch_rank_bodies.seqpar``) runs every
case on the JAX tests' seeded inputs, each rank on its sequence block
(zigzag: its chunk pair) or its tokens: the plain ring and the flash ring
(causal and not, forward and gradients, GQA with compact K/V, packed rows
whose keys leave rows dead in whole visiting blocks), zigzag (einsum and
flash, forward, GQA, gradients, packed), Ulysses (the auto and the forced
flash branch, packed, the indivisible-heads error) and the
expert-parallel ``MoELayer`` (top-1 and top-2 against a dense oracle,
gradients, capacity drops, the aux loss).  On the CPU the flash paths run
the kernels' plain versions.  The assembled outputs are held against the
JAX package's functions on four of its forced CPU devices where the JAX
tests run them in tier 1 (the plain ring, its gradients, Ulysses, the
zigzag einsum ring, ``MoELayer``) and against the JAX oracles the JAX
tests use (``reference_attention`` and the dense attention) everywhere.
Tolerances: the JAX tests' own (2e-5 to 5e-5 absolute, 1e-4 to 1e-3
relative; MoE 1e-4 / 1e-3).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu.ops import reference_attention
from chainermn_tpu.parallel import (
    MoELayer as JaxMoE,
    ring_self_attention as jax_ring,
    ulysses_attention as jax_ulysses,
    zigzag_attention as jax_zigzag,
)

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import packed_segments, seq_qkv
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

S = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("seqpar", tmp_path_factory.mktemp("seqpar"), S)


@pytest.fixture(scope="module")
def seq_comm():
    return cmn.XlaCommunicator(cmn.hybrid_mesh(
        {"seq": S}, devices=jax.devices()[:S]))


def _glue(ranks, key, zig=False):
    out = np.concatenate([r[key] for r in ranks], axis=1)
    if zig:
        from chainermn_tpu.parallel import zigzag_unshard

        out = np.asarray(zigzag_unshard(jnp.asarray(out), S))
    return out


def _grads(ranks, key, zig=False):
    out = []
    for i in range(3):
        g = np.concatenate([r[key + "_grads"][i] for r in ranks], axis=1)
        if zig:
            from chainermn_tpu.parallel import zigzag_unshard

            g = np.asarray(zigzag_unshard(jnp.asarray(g), S))
        out.append(g)
    return out


def _oracle(q, k, v, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None, None], s,
                      -jnp.inf)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


def _spmd(comm, fn, n_in=3):
    spec = P(None, comm.axes)
    return jax.jit(comm.spmd(fn, in_specs=(spec,) * n_in, out_specs=spec,
                             check_vma=False))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_and_full(ranks, seq_comm, causal):
    q, k, v = seq_qkv(np.random.RandomState(0))
    got = _glue(ranks, f"ring_c{int(causal)}")
    want = np.asarray(_spmd(seq_comm, lambda a, b, c: jax_ring(
        a, b, c, seq_comm.axis_name, causal=causal))(q, k, v))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(_oracle(q, k, v, causal)),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match(ranks, seq_comm, causal):
    q, k, v = seq_qkv(np.random.RandomState(1), B=1, T=16, H=2, D=4)
    probe = jnp.cos(jnp.arange(q.size).reshape(q.shape))
    f = _spmd(seq_comm, lambda a, b, c: jax_ring(
        a, b, c, seq_comm.axis_name, causal=causal))
    g = jax.grad(lambda t: jnp.sum(f(*t) * probe))((q, k, v))
    og = jax.grad(lambda t: jnp.sum(_oracle(*t, causal) * probe))((q, k, v))
    for a, b, c in zip(_grads(ranks, f"ring_grad_c{int(causal)}"), g, og):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=1e-3)
        np.testing.assert_allclose(a, np.asarray(c), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("flash", [False, True], ids=["auto", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_full(ranks, seq_comm, causal, flash):
    q, k, v = seq_qkv(np.random.RandomState(2))
    key = f"ulysses{'_flash' if flash else ''}_c{int(causal)}"
    got = _glue(ranks, key)
    np.testing.assert_allclose(got, np.asarray(_oracle(q, k, v, causal)),
                               atol=2e-5, rtol=1e-4)
    if not flash:
        want = np.asarray(_spmd(seq_comm, lambda a, b, c: jax_ulysses(
            a, b, c, seq_comm.axis_name, causal=causal))(q, k, v))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_ulysses_rejects_indivisible_heads(ranks, seq_comm):
    q, k, v = seq_qkv(np.random.RandomState(3), H=6)
    with pytest.raises(ValueError) as e:
        _spmd(seq_comm, lambda a, b, c: jax_ulysses(
            a, b, c, seq_comm.axis_name))(q, k, v)
    assert all(r["ulysses_bad"] == str(e.value) for r in ranks)


@pytest.mark.parametrize("ring", ["xla", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_gqa_compact_kv_matches_expanded(ranks, causal, ring):
    rng = np.random.RandomState(7)
    q = (rng.normal(size=(2, 32, 8, 8)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(2, 32, 2, 8)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(2, 32, 2, 8)) * 0.5).astype(np.float32)
    ref = np.asarray(_oracle(q, np.repeat(k, 4, axis=2),
                             np.repeat(v, 4, axis=2), causal))
    np.testing.assert_allclose(_glue(ranks, f"gqa_{ring}_c{int(causal)}"),
                               ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_matches_full(ranks, causal):
    q, k, v = seq_qkv(np.random.RandomState(3), B=2, T=64, H=2, D=8)
    np.testing.assert_allclose(_glue(ranks, f"ring_flash_c{int(causal)}"),
                               np.asarray(_oracle(q, k, v, causal)),
                               atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_gradients_match(ranks, causal):
    """Through the lse merge and the lse cotangent of each block."""
    q, k, v = seq_qkv(np.random.RandomState(4), B=1, T=32, H=2, D=4)
    probe = np.random.RandomState(5).normal(size=q.shape).astype(np.float32)
    og = jax.grad(lambda t: jnp.sum(_oracle(*t, causal) * probe))((q, k, v))
    for a, b in zip(_grads(ranks, f"ring_flash_grad_c{int(causal)}"), og):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("ring", ["ring", "ring_flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_packed_segments(ranks, causal, ring):
    """Packed documents across the shards: rows dead in whole visiting
    blocks (no key of their segment there) stay out of the merge."""
    q, k, v = seq_qkv(np.random.RandomState(11), B=2, T=64, H=4, D=8)
    seg = packed_segments(2, 64, (20, 45, 45), shift=10)
    ref = np.asarray(reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        segment_ids=jnp.asarray(seg)))
    got = _glue(ranks, f"{ring}_packed_c{int(causal)}")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("ring", ["ring", "ring_flash"])
def test_ring_packed_gradients_match(ranks, ring):
    rng = np.random.RandomState(13)
    q, k, v = seq_qkv(rng, B=1, T=32, H=2, D=4)
    probe = rng.normal(size=q.shape).astype(np.float32)
    seg = jnp.asarray(packed_segments(1, 32, (12, 32)))
    og = jax.grad(lambda t: jnp.sum(reference_attention(
        *t, True, segment_ids=seg) * probe))(
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for name, a, b in zip("qkv", _grads(ranks, f"{ring}_packed_grad"), og):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=1e-3,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_packed_segments(ranks, causal):
    q, k, v = seq_qkv(np.random.RandomState(14), B=2, T=64, H=8, D=4)
    seg = packed_segments(2, 64, (18, 41, 41), shift=9)
    ref = np.asarray(reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        segment_ids=jnp.asarray(seg)))
    np.testing.assert_allclose(_glue(ranks, f"ulysses_packed_c{int(causal)}"),
                               ref, atol=2e-5, rtol=1e-4)


def test_zigzag_layout_helpers():
    from chainermn_tpu.parallel import zigzag_shard as jshard
    from chainermn_tpu.parallel.zigzag import zigzag_order as jorder

    import torch

    from chainermn_tpu_torch.parallel import (
        zigzag_order,
        zigzag_shard,
        zigzag_unshard,
    )

    x = np.arange(2 * 32 * 3.0).reshape(2, 32, 3)
    for n in (1, 2, 4, 8):
        assert zigzag_order(n).tolist() == jorder(n).tolist()
        z = zigzag_shard(torch.tensor(x), n)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jshard(x, n)))
        np.testing.assert_array_equal(zigzag_unshard(z, n).numpy(), x)
    with pytest.raises(ValueError, match="2\\*3 chunks"):
        zigzag_shard(torch.tensor(x), 3)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_zigzag_matches_jax_and_oracle(ranks, seq_comm, impl):
    rng = np.random.RandomState(0)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 64, 2, 16)).astype(
        np.float32)) for _ in range(3))
    got = _glue(ranks, f"zigzag_{impl}", zig=True)
    want = np.asarray(reference_attention(q, k, v, causal=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    if impl == "einsum":
        np.testing.assert_allclose(
            got, np.asarray(jax_zigzag(seq_comm, q, k, v, impl=impl)),
            atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_zigzag_gqa_compact_kv(ranks, impl):
    rng = np.random.RandomState(4)
    q = jnp.asarray(rng.normal(size=(2, 64, 8, 16)).astype(np.float32))
    k = jnp.asarray(rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
    want = reference_attention(q, jnp.repeat(k, 4, axis=2),
                               jnp.repeat(v, 4, axis=2), causal=True)
    np.testing.assert_allclose(_glue(ranks, f"zigzag_gqa_{impl}", zig=True),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_zigzag_gradients_match_oracle(ranks, impl):
    rng = np.random.RandomState(1)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 32, 2, 8)).astype(
        np.float32)) for _ in range(3))
    go = jax.grad(lambda a, b, c: jnp.sum(reference_attention(
        a, b, c, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(_grads(ranks, f"zigzag_grad_{impl}", zig=True), go):
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_zigzag_packed_segments(ranks, impl):
    rng = np.random.RandomState(5)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 64, 2, 16)).astype(
        np.float32)) for _ in range(3))
    seg = jnp.asarray(packed_segments(2, 64, (22, 47, 47), shift=11))
    want = reference_attention(q, k, v, causal=True, segment_ids=seg)
    np.testing.assert_allclose(
        _glue(ranks, f"zigzag_packed_{impl}", zig=True), np.asarray(want),
        atol=2e-5, rtol=2e-5)


# -------------------------------------------------------------------- MoE
E = S


def _moe_setup(rng, n=4, D=6, F_=12):
    x = (rng.normal(size=(E * n, D)) * 0.7).astype(np.float32)
    router = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F_)) * 0.4).astype(np.float32)
    w2 = (rng.normal(size=(E, F_, D)) * 0.4).astype(np.float32)
    return x, router, w1, w2


def _relu_expert(params, tokens):
    w1, w2 = params
    return jnp.maximum(tokens @ w1[0], 0.0) @ w2[0]


@pytest.fixture(scope="module")
def exp_comm():
    return cmn.XlaCommunicator(cmn.hybrid_mesh(
        {"expert": E}, devices=jax.devices()[:E]))


def _jax_moe(exp_comm, layer):
    return jax.jit(exp_comm.spmd(
        lambda r, w1, w2, x: layer(r, (w1, w2), x),
        in_specs=(P(), P("expert"), P("expert"), P("expert")),
        out_specs=(P("expert"), P("expert")), check_vma=False))


@pytest.mark.parametrize("k", [1, 2])
def test_moe_matches_jax_and_dense_oracle(ranks, exp_comm, k):
    x, router, w1, w2 = _moe_setup(np.random.RandomState(0))
    layer = JaxMoE(_relu_expert, exp_comm.axis_name, k=k,
                   capacity_factor=float(E))
    f = _jax_moe(exp_comm, lambda r, w, xx: (lambda o, a: (o, a[None]))(
        *layer(r, w, xx)))
    out, aux = f(router, w1, w2, x)
    got = np.concatenate([r[f"moe_k{k}"][0] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-4, rtol=1e-3)
    probs = np.asarray(jax.nn.softmax(x @ router, axis=-1))
    ref = np.zeros_like(x)
    for n in range(x.shape[0]):
        top = np.argsort(-probs[n])[:k]
        for e in top:
            h = np.maximum(x[n] @ w1[e], 0.0) @ w2[e]
            ref[n] += probs[n, e] / probs[n, top].sum() * h
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose([r[f"moe_k{k}"][1] for r in ranks],
                               np.asarray(aux), rtol=1e-5)

    def loss(rt, a, b):
        return jnp.sum(f(rt, a, b, x)[0] ** 2)

    g = jax.grad(loss, argnums=(0, 1, 2))(router, w1, w2)
    np.testing.assert_allclose(sum(r[f"moe_k{k}"][2][0] for r in ranks),
                               np.asarray(g[0]), atol=1e-4, rtol=1e-3)
    for i in (1, 2):
        got = np.concatenate([r[f"moe_k{k}"][2][i] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(g[i]), atol=1e-4,
                                   rtol=1e-3)


def test_moe_capacity_drops_tokens(ranks):
    """Capacity 1 per source and expert: every rank's first token
    survives (identity expert), the rest are dropped to zero."""
    rng = np.random.RandomState(1)
    x = np.abs((rng.normal(size=(E * 4, 6)) * 0.5).astype(np.float32))
    for r, res in enumerate(ranks):
        assert res["moe_capacity"] == 1
        out = res["moe_drop"][0]
        np.testing.assert_allclose(out[0], x[4 * r], atol=1e-5)
        np.testing.assert_allclose(out[1:], 0.0, atol=1e-6)


def test_moe_aux_loss_uniform_router(ranks):
    np.testing.assert_allclose([r["moe_aux_uniform"] for r in ranks], 1.0,
                               atol=1e-5)
