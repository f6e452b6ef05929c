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

The same job runs the serving decisions that must agree across model
ranks, on a fixed clock with every request arrived at 0: the policy
plane on one 2-rank engine, its drift latch held by per-rank SLO targets
(rank 0 breaching and rank 1 not, then the reverse) against the JAX
sharded engine's scheduler with rank 0's target; and the router over two
replicas of 2 model ranks against the JAX router over two 2-device
meshes, then with a fleet policy plane.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chainermn_tpu.observability.metrics as jmet
import chainermn_tpu.observability.slo as jslo
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu.serving import PolicyPlane as JaxPlane
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Router as JaxRouter
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import TenantPolicy as JaxTenant
from chainermn_tpu.serving.sharding import serving_mesh as jax_mesh
from chainermn_tpu.serving.sharding import shard_params as jax_shard_params

from chainermn_tpu_torch.serving.sharding import (
    Cut,
    param_spec,
    pool_placement,
    validate_geometry,
)
from chainermn_tpu_torch.utils import params_from_flax, tp_params_from_flax

from torch_fleet_common import FixedClock, StepClock
from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import (
    TP_ARRIVALS,
    TP_ENGINE,
    TP_MODEL,
    TP_PLANE,
    TP_TENANTS,
    tp_policy_requests,
    tp_requests,
    tp_router_requests,
    tp_slo_targets,
)
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


def _jax_plane():
    return JaxPlane(tenants={t: JaxTenant(t, weight=w)
                             for t, w in TP_TENANTS.items()},
                    registry=jmet.MetricsRegistry(), **TP_PLANE)


@pytest.fixture(scope="module")
def jax_planes(params):
    """The JAX side of the agreed decisions: its scheduler with a policy
    plane on a 2-device sharded engine, the drift latch breaching or
    not (rank 0's target of each case), and its router over two 2-device
    meshes; the engines are reused with their prefix caches dropped."""
    devs = jax.devices()
    engs = [JaxEngine(_jax_lm(), params["params"], **TP_ENGINE,
                      mesh=jax_mesh(2, devices=devs[2 * i:2 * i + 2]))
            for i in range(2)]
    out = {}
    for case, breach in (("r0", True), ("r1", False)):
        engs[0].drop_prefix_cache()
        pol, reg = _jax_plane(), jmet.MetricsRegistry()
        slo = jslo.SLOMonitor(registry=reg, min_samples=1, check_every=1,
                              targets=tp_slo_targets(breach))
        comps = JaxScheduler(engs[0], clock=FixedClock(), slo=slo,
                             policy=pol, registry=reg).run(
            tp_policy_requests(JaxRequest))
        out[case] = dict(tokens={c.id: c.tokens for c in comps},
                         log=list(pol.admission_log), state=pol.state(),
                         capped=pol._m_capped.value)
    for e in engs:
        e.drop_prefix_cache()
    reg = jmet.MetricsRegistry()
    router = JaxRouter(engs, clock=FixedClock(), registry=reg)
    comps = router.run(tp_router_requests(JaxRequest))
    out["router"] = dict(tokens={c.id: c.tokens for c in comps},
                         assignments=dict(router.assignments),
                         migrated=reg.peek("serve.router.migrated").value)
    for e in engs:
        e.drop_prefix_cache()
    router = JaxRouter(engs, clock=StepClock(),
                       registry=jmet.MetricsRegistry())
    comps = router.run(tp_router_requests(JaxRequest, arrivals=TP_ARRIVALS))
    out["router_arrivals"] = dict(
        tokens={c.id: c.tokens for c in comps},
        admitted={c.id: c.first_admitted_at for c in comps},
        assignments=dict(router.assignments), now=router.clock.now())
    return out


@pytest.mark.parametrize("case", ["r0", "r1"])
def test_tp_policy_latch_follows_model_rank_zero(ranks, jax_planes, case):
    """Item 2c: ``Scheduler(engine, policy=)`` over 2 model ranks.  Each
    rank's SLO monitor judges its own target (``r0``: rank 0 breaches and
    rank 1 not; ``r1``: the reverse), and the drift latch on both ranks
    follows rank 0's verdict: the admission log (ids, tenants, virtual
    clocks), the latch, the capped prefill count and the greedy tokens
    are equal on every rank and to the JAX sharded engine's scheduler
    under rank 0's target."""
    want = jax_planes[case]
    for r in ranks:
        got = r[f"policy_{case}"]
        assert got["tokens"] == want["tokens"], r["rank"]
        assert [x[:2] for x in got["log"]] == [x[:2] for x in want["log"]]
        np.testing.assert_allclose([x[2] for x in got["log"]],
                                   [x[2] for x in want["log"]],
                                   rtol=0, atol=1e-9)
        assert got["state"]["prefill_cap_active"] == \
            want["state"]["prefill_cap_active"]
        assert got["state"]["tenants"] == want["state"]["tenants"]
        for key in ("virtual", "charged"):
            assert got["state"][key] == pytest.approx(want["state"][key],
                                                      rel=0, abs=1e-9)
        assert got["capped"] == want["capped"]
        assert got["verdicts"] > 0
        # The rank's own monitor kept its own verdict.
        assert bool(got["own_breaches"]) == \
            ((r["m2_rank"] == 0) == (case == "r0"))
    assert (want["capped"] > 0) == (case == "r0")
    assert want["state"]["prefill_cap_active"] == (case == "r0")


def test_tp_router_equals_jax_router(ranks, jax_planes):
    """The router over 2 replicas of 2 model ranks (ranks {0, 1} and
    {2, 3}): every rank dispatches every request to the replica the JAX
    router over two 2-device meshes picks, steals as often, and returns
    the same completions with the JAX router's greedy tokens."""
    want = jax_planes["router"]
    assert want["migrated"] >= 1
    for r in ranks:
        got = r["router"]
        assert got["local"] == r["rank"] // 2
        assert got["assignments"] == want["assignments"], r["rank"]
        assert got["migrated"] == want["migrated"]
        assert got["dispatched"] == len(want["tokens"])
        assert got["tokens"] == want["tokens"]
        assert got["order"] == ranks[0]["router"]["order"]


def test_tp_router_idle_skips_equal_jax_router(ranks, jax_planes):
    """Staggered arrivals on a clock that moves only when the router
    skips it: every rank skips to the same arrivals (world rank 0's
    clock, latched at each skip), admits each request at the JAX
    router's time on the replica it picks, and ends with its tokens."""
    want = jax_planes["router_arrivals"]
    assert want["now"] == TP_ARRIVALS[-1]
    assert sorted(set(want["admitted"].values())) == sorted(set(
        TP_ARRIVALS))
    for r in ranks:
        assert r["router_arrivals"] == want, r["rank"]


def test_tp_router_fleet_plane_agrees_every_tick(ranks):
    """With a fleet policy plane over the tensor-parallel replicas, the
    plane's state and admission log are equal on every rank after every
    tick, the dispatch and steals agree, and the tokens are the
    plane-less run's."""
    first = ranks[0]["router_plane"]
    assert len(first["digests"]) >= 3
    assert first["migrated"] >= 1
    assert sorted(t for _, t in first["log"]) == ["a"] * 4 + ["b"] * 4
    for r in ranks:
        got = r["router_plane"]
        for key in ("digests", "log", "assignments", "migrated", "order",
                    "tokens"):
            assert got[key] == first[key], (r["rank"], key)
        assert got["tokens"] == r["router"]["tokens"]


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
    """The geometry fails fast naming the axis (2 kv heads over 4 ranks);
    the policy plane is accepted on a multi-rank engine (its latch
    follows model rank 0's verdict); the router over tensor-parallel
    replicas refuses nothing the JAX router takes: roles are accepted,
    and an idle replica drains with nothing to move (the seams are held
    against the JAX router in ``test_torch_tp_fleet.py``)."""
    for r in ranks:
        assert "divisible by the mesh's 'model' axis (4)" in \
            r["geometry_error"]
        assert r["policy_error"] == "no error"
        assert r["roles_error"] == "no error"
        assert r["drain"] == {"replica": 0, "slots_migrated": 0,
                              "entries_requeued": 0, "dropped_frames": 0}


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
