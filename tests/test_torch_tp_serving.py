"""The port's tensor-parallel serving engine (``DecodeEngine(mesh=)``,
``serving/sharding.py``) against the JAX package's sharded engine
(``tests/serving_tests/test_sharding.py``).

One job of four gloo ranks (``torch_rank_bodies.tp``) runs two 2-rank
engines (ranks {0, 1} and {2, 3}) on the JAX test's geometry (vocab 128,
2 layers, d_model 64, 4 heads, 2 kv heads, RoPE, float32, capacity 2, 20
blocks of 8, prefill chunk 8, a 1-layer draft, ``spec_k`` 2) and its
shared-prefix traffic, einsum and fused; one 4-rank engine with 4 kv
heads (one local kv head per rank); a MoE model and an odd vocab; and
``lm_generate`` through the tensor-parallel model's kv-major cache.  The
JAX side runs its sharded engine on 2 and 4 of the forced CPU devices.
Greedy tokens are compared exactly (as the JAX test compares its sharded
engine with its one-device engine); sampling is compared within the port
(fused against einsum, and against the one-rank engine): the two
frameworks' generators differ.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving.sharding import serving_mesh as jax_mesh
from chainermn_tpu.serving.sharding import shard_params as jax_shard_params

from chainermn_tpu_torch.serving.sharding import (
    Cut,
    param_spec,
    pool_placement,
    validate_geometry,
)
from chainermn_tpu_torch.utils import params_from_flax, tp_params_from_flax

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import TP_ENGINE, TP_MODEL, tp_requests
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1


def _jax_lm(**over):
    return JaxLM(**{**TP_MODEL, **over}, dtype=jnp.float32)


def _init(model, seed):
    p = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 12), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


@pytest.fixture(scope="module")
def params():
    return {"params": _init(_jax_lm(), 0),
            "draft_params": _init(_jax_lm(n_layers=1), 1),
            "params4": _init(_jax_lm(n_kv_heads=4), 0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params):
    import pickle

    out = tmp_path_factory.mktemp("tp")
    with open(out / "tp_inputs.pkl", "wb") as f:
        pickle.dump(params, f)
    return run_ranks("tp", out, 4, timeout_s=240.0)


def _serve(eng, reqs):
    return {c.id: c.tokens for c in JaxScheduler(eng).run(reqs)}


@pytest.fixture(scope="module")
def jax_tokens(params):
    """The JAX sharded engine's greedy tokens: 2-way einsum with
    speculation and prefix sharing (the JAX test's fixture), 4-way with
    4 kv heads; and the 2-way engine's parameter and pool layout."""
    devs = jax.devices()
    mesh2, mesh4 = jax_mesh(2, devices=devs[:2]), jax_mesh(4, devices=devs[:4])
    pset, pset4, _ = tp_requests()
    eng = JaxEngine(_jax_lm(), params["params"], **TP_ENGINE,
                    draft_model=_jax_lm(n_layers=1),
                    draft_params=params["draft_params"], spec_k=2,
                    mesh=mesh2)
    out = {"m2": _serve(eng, [JaxRequest(id=i, prompt=p, max_new_tokens=8,
                                         seed=100 + i)
                              for i, p in enumerate(pset)])}
    out["shards"] = {}
    for d, dev in enumerate(devs[:2]):
        out["shards"][d] = jax.tree_util.tree_map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), eng.params)
    out["pool"] = eng.pools[0]["k"].sharding.shard_shape(
        eng.pools[0]["k"].shape)
    eng4 = JaxEngine(_jax_lm(n_kv_heads=4), params["params4"], **TP_ENGINE,
                     mesh=mesh4)
    out["m4"] = _serve(eng4, [JaxRequest(id=i, prompt=p, max_new_tokens=6)
                              for i, p in enumerate(pset4)])
    return out


def test_tp_engine_greedy_equals_jax_sharded_engine(ranks, jax_tokens):
    """2 model ranks: the port's engine, einsum and fused (the paged
    kernel's plain version on each rank's heads), with speculative
    verify and prefix sharing on, gives the JAX sharded engine's tokens
    and the port's one-rank engine's."""
    want = jax_tokens["m2"]
    assert set(want) == set(range(6))
    for r in ranks:
        for attn in ("einsum", "fused"):
            assert r[f"m2_{attn}"] == want, (r["rank"], attn)
            assert r[f"one_{attn}"] == want, (r["rank"], attn)


def test_tp_engine_four_ranks_one_kv_head_each(ranks, jax_tokens):
    """4 model ranks with 4 kv heads: one local KV head per rank (the
    kernels' ``KH/M = 1`` grid), fused and einsum equal to the JAX 4-way
    engine and to the one-rank engine."""
    for r in ranks:
        assert r["m4_pool_shape"][0] == 1
        for attn in ("einsum", "fused"):
            assert r[f"m4_{attn}"] == jax_tokens["m4"], (r["rank"], attn)
            assert r[f"one4_{attn}"] == jax_tokens["m4"]
            assert r[f"m4_{attn}_compiles"] == 1


def test_tp_engine_books_and_one_signature(ranks):
    """The one-signature contract and the host books through slot churn,
    eviction pressure and copy-on-write; prefix sharing was live."""
    for r in ranks:
        for attn in ("einsum", "fused"):
            b = r[f"m2_{attn}_books"]
            assert b["decode_compiles"] == 1 and b["cow_compiles"] <= 1
            assert b["prefill_compiles"] == b["ladder"]
            assert b["hits"] > 0 and not b["over_budget"]


def test_tp_tokens_equal_on_every_rank(ranks):
    """Every model rank reads the all-gathered logits, so every rank
    emits the same tokens (else the next step's all-reduces would pair
    different layers)."""
    every = ranks[0]["all_tokens"]
    assert len(every) == 4
    for got in every[1:]:
        assert got == every[0]


def test_tp_sampling_fused_equals_einsum(ranks):
    """Seeded sampling draws the same tokens on the fused and the einsum
    engine, tensor-parallel or not (per-slot lanes hash positions, and
    the gathered logits are the whole row)."""
    for r in ranks:
        assert set(r["m2_fused_sampled"]) == {10, 11, 12}
        assert r["m2_fused_sampled"] == r["m2_einsum_sampled"]
        assert r["m2_fused_sampled"] == r["one_fused_sampled"]


def test_tp_layout_is_the_jax_param_spec_shard(ranks, params, jax_tokens):
    """Each rank's parameters are the JAX ``shard_params`` shard of the
    same leaf on the same model rank (carried across leaf by leaf with
    the bridge), its pools hold ``KH/M`` heads as the JAX pools' shard
    shape, and an odd vocab's head stays whole on both sides."""
    for r in ranks:
        want = params_from_flax(jax_tokens["shards"][r["m2_rank"]],
                                device="cpu")
        assert set(r["layout"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["layout"][k], v.numpy(),
                                          err_msg=k)
        assert r["pool_shape"] == tuple(jax_tokens["pool"])
        assert r["draft_pool_shape"][0] == 1
        assert r["odd_vocab_head"] == (127, TP_MODEL["d_model"])
        assert r["moe_head"] == (64, TP_MODEL["d_model"])
    odd = _init(_jax_lm(vocab=127), 4)
    mesh2 = jax_mesh(2, devices=jax.devices()[:2])
    sharded = jax_shard_params(odd, mesh2)
    assert sharded["lm_head"]["kernel"].sharding.spec == \
        jax.sharding.PartitionSpec()
    for rank in range(2):
        local = tp_params_from_flax(odd, rank, 2, device="cpu")
        assert tuple(local["lm_head.weight"].shape) == (127, 64)
        assert tuple(local["blocks.0.q.weight"].shape) == (32, 64)
        assert tuple(local["blocks.0.kv.weight"].shape) == (32, 64)


def test_tp_moe_odd_vocab_and_lm_generate(ranks):
    """A MoE model (each expert's hidden axis cut) and an odd vocab
    (the head whole) serve the one-rank engine's tokens; ``lm_generate``
    on the tensor-parallel model (the fused kernel's plain version on
    each rank's kv-major cache) gives the whole model's tokens."""
    for r in ranks:
        assert r["m2_moe"] == r["one_moe"]
        assert r["m2_odd_vocab"] == r["one_odd_vocab"]
        got, want = r["generate"]
        np.testing.assert_array_equal(got, want)


def test_tp_refusals(ranks):
    """The geometry fails fast naming the axis (2 kv heads over 4 ranks),
    and the policy plane, which budgets from each rank's own latencies,
    is refused on a multi-rank engine."""
    for r in ranks:
        assert "divisible by the mesh's 'model' axis (4)" in \
            r["geometry_error"]
        assert "policy" in r["policy_error"]


def test_param_spec_table_and_validate_geometry():
    """The Megatron cut on torch layouts, and the JAX geometry check's
    message (KH is the one axis that must split)."""
    assert param_spec("blocks.0.qkv.weight") == Cut(0, 3)
    assert param_spec("blocks.0.kv.bias") == Cut(0, 2)
    assert param_spec("blocks.3.proj.weight") == Cut(1)
    assert param_spec("blocks.3.proj.bias") is None
    assert param_spec("blocks.3.ff2.weight") == Cut(1)
    assert param_spec("blocks.3.ff2.bias") is None
    assert param_spec("blocks.1.moe_w1") == Cut(2)
    assert param_spec("blocks.1.moe_w2") == Cut(1)
    assert param_spec("blocks.1.moe_b2") is None
    assert param_spec("lm_head.bias") == Cut(0)
    for name in ("embed.weight", "pos", "ln_f.weight", "blocks.0.router"):
        assert param_spec(name) is None

    class _Mesh:
        size, rank = 3, 0

    class _Model:
        n_heads, n_kv_heads = 4, 2

    with pytest.raises(ValueError, match="divisible by the mesh"):
        validate_geometry(_Model(), _Mesh())
    import torch

    pool = torch.arange(4 * 3 * 2 * 5.0).view(4, 3, 2, 5)
    mesh = _Mesh()
    mesh.size, mesh.rank = 2, 1
    np.testing.assert_array_equal(pool_placement(mesh)(pool).numpy(),
                                  pool[2:].numpy())
