"""The fleet planes over tensor-parallel replicas (``Router(engine,
comm=world)``) against the JAX router over replicas on their own meshes
(``tests/serving_tests/test_recovery.py``, ``test_elastic.py``,
``test_disagg.py`` and the fleet trace of ``test_router.py``).

One job of four gloo ranks (``torch_rank_bodies.tp_fleet``) runs two
groups of 2 model ranks ({0, 1} and {2, 3}) on the ``tp`` body's model
(vocab 128, 2 layers, d_model 64, 4 heads, 2 kv heads, RoPE, float32,
capacity 2, 20 blocks of 8, prefill chunk 8) and the router's traffic (8
requests of two tenants, 16 in the crash case, every one arrived at 0,
on a clock that never moves):

* 2d, 2g, 2h: ``crash@serve_step:3`` on replica 1, its revival 2 ticks
  later, the fleet ledger and the merged trace of that run; an error on
  one model rank after the step's collectives; the chaos harness over
  ``chaos_schedule(1, 2)``;
* 2f: roles over the fleet, a prefill group feeding a decode group with
  one frame per model rank, and drains between the groups with and
  without a dropped frame;
* 2e: a scale-up from one active group and one standby group, its drain
  and deregistration, a rolling deploy of version-2 weights, and the
  autoscaler with one model rank's SLO drift breaching.

The JAX side runs the same drives over two 2-device meshes of the forced
CPU devices.  Tokens, assignments, statuses, counters and the ledger's
integer dimensions are compared exactly; only the KV frames carry a
float tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chainermn_tpu.observability.metrics as jmet
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.observability.ledger import CostLedger as JaxLedger
from chainermn_tpu.resilience.faults import FaultInjector as JaxInjector
from chainermn_tpu.resilience.faults import parse_fault_spec as jax_spec
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import RollingDeploy as JaxRollingDeploy
from chainermn_tpu.serving import Router as JaxRouter
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import disagg as jdisagg
from chainermn_tpu.serving.recovery import ChaosHarness as JaxHarness
from chainermn_tpu.serving.recovery import chaos_schedule as jax_chaos
from chainermn_tpu.serving.sharding import serving_mesh as jax_mesh

from torch_fleet_common import FixedClock
from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import (
    TP_ENGINE,
    TP_FLEET_CHAOS_SEED,
    TP_FLEET_CRASH,
    TP_FLEET_REQUESTS,
    TP_FLEET_V2_SEED,
    TP_MODEL,
    LateFault,
    fleet_drive,
    fleet_summary,
    tp_router_requests,
    trace_rows,
)
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

#: the summary keys held exactly against the JAX router.
_EXACT = ("tokens", "completions", "assignments", "health", "counters")


def _init(seed):
    model = JaxLM(**TP_MODEL, dtype=jnp.float32)
    p = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 12), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


@pytest.fixture(scope="module")
def params():
    return {"params": _init(0), "params_v2": _init(TP_FLEET_V2_SEED)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params):
    import pickle

    out = tmp_path_factory.mktemp("tp_fleet")
    with open(out / "tp_fleet_inputs.pkl", "wb") as f:
        pickle.dump(params, f)
    return run_ranks("tp_fleet", out, 4, timeout_s=300.0)


@pytest.fixture(scope="module")
def jax_fleet(params, tmp_path_factory):
    """The same drives on the JAX router over two 2-device meshes."""
    devs = jax.devices()
    meshes = [jax_mesh(2, devices=devs[2 * i:2 * i + 2]) for i in range(2)]
    model = JaxLM(**TP_MODEL, dtype=jnp.float32)
    turn = {"k": 0}

    def engine(mesh=None, params_=None):
        if mesh is None:  # a factory's call: the meshes in turn
            mesh, turn["k"] = meshes[turn["k"] % 2], turn["k"] + 1
        return JaxEngine(model, params["params"] if params_ is None
                         else params_, **TP_ENGINE, mesh=mesh)

    def inj(spec):
        return JaxInjector(jax_spec(spec)) if spec else None

    reqs = tp_router_requests(JaxRequest, tenants=True)
    out = {}
    reg = jmet.MetricsRegistry()
    router = JaxRouter([engine(meshes[0]), engine(meshes[1])],
                       clock=FixedClock(), registry=reg,
                       faults=[None, inj(TP_FLEET_CRASH)],
                       ledger=JaxLedger(registry=jmet.MetricsRegistry()))
    comps = fleet_drive(router, tp_router_requests(
        JaxRequest, tenants=True, n=TP_FLEET_REQUESTS),
        revive=lambda: router.revive_replica(1, engine(meshes[1])))
    out["crash"] = fleet_summary(router, comps, reg)
    path = str(tmp_path_factory.mktemp("jax_trace") / "trace.json")
    router.export_fleet_trace(path)
    out["trace"] = trace_rows(path)

    reg = jmet.MetricsRegistry()
    router = JaxRouter([engine(meshes[0]), engine(meshes[1])],
                       clock=FixedClock(), registry=reg)
    router.schedulers[1]._m_occ = LateFault(router.schedulers[1]._m_occ)
    out["late"] = fleet_summary(router, fleet_drive(router, reqs), reg)

    sched = jax_chaos(TP_FLEET_CHAOS_SEED, 2)
    sched.pop("elastic", None)
    harness = JaxHarness(engine, replicas=2, schedule=sched,
                         clock=FixedClock(), registry=jmet.MetricsRegistry())
    report = harness.run(reqs)
    out["chaos"] = dict(
        holds=report["holds"], by_status=report["by_status"],
        revived=report["revived"],
        tokens={c.id: list(c.tokens) for c in harness.router.completions},
        statuses={c.id: c.status for c in harness.router.completions})

    reg = jmet.MetricsRegistry()
    router = JaxRouter([engine(meshes[0]), engine(meshes[1])],
                       clock=FixedClock(), registry=reg,
                       roles=["decode", "mixed"])
    out["roles"] = fleet_summary(router, fleet_drive(router, reqs), reg)

    for name, spec in (("disagg", None), ("disagg_lost", "drop@migrate:1")):
        lc = jdisagg.LocalComm(2)
        tr = jdisagg.MigrationTransport(lc.endpoint(0), injector=inj(spec))
        frames = []
        send = tr.send
        tr.send = lambda body, dest: (frames.append(body), send(body, dest))
        pre = jdisagg.PrefillRole(JaxScheduler(engine(meshes[0]),
                                               clock=FixedClock()), tr,
                                  decode_ranks=[1])
        dec = jdisagg.DecodeRole(JaxScheduler(engine(meshes[1]),
                                              clock=FixedClock()),
                                 jdisagg.MigrationTransport(lc.endpoint(1)),
                                 prefill_ranks=[0])
        comps = jdisagg.serve_disaggregated(pre, dec, reqs)
        out[name] = dict(tokens={c.id: list(c.tokens) for c in comps},
                         frame=next(b for b in frames if b["slots"]))

    for name, spec in (("drain", None), ("drain_drop", "drop@migrate:1")):
        reg = jmet.MetricsRegistry()
        router = JaxRouter([engine(meshes[0]), engine(meshes[1])],
                           clock=FixedClock(), registry=reg,
                           fault=inj(spec))
        drained = []

        def drain(rt, tick):
            if tick == 3:
                drained.append(rt.drain_replica(1))
                rt.deregister_replica(1)

        out[name] = fleet_summary(router, fleet_drive(router, reqs,
                                                      every=drain), reg)
        out[name]["drain"] = drained[0]

    reg = jmet.MetricsRegistry()
    router = JaxRouter([engine(meshes[0])], clock=FixedClock(), registry=reg)
    events = []

    def elastic(rt, tick):
        if tick == 2:
            events.append(rt.add_replica(engine(meshes[1])))
        if tick == 6:
            events.append(rt.drain_replica(1))
            rt.deregister_replica(1)

    out["elastic"] = fleet_summary(router, fleet_drive(router, reqs,
                                                       every=elastic), reg)
    out["elastic"]["events"] = events

    reg = jmet.MetricsRegistry()
    router = JaxRouter([engine(meshes[0]), engine(meshes[1])],
                       clock=FixedClock(), registry=reg)
    rollout = []

    def roll(rt, tick):
        if tick == 2:
            rollout.append(JaxRollingDeploy(
                rt, lambda params: engine(params_=params),
                params=params["params_v2"], registry=jmet.MetricsRegistry()))
        if rollout:
            rollout[0].tick()

    comps = fleet_drive(router, reqs, every=roll)
    while not rollout[0].done:
        router.tick()
        rollout[0].tick()
    out["rollout"] = fleet_summary(router, comps, reg)
    out["rollout"]["replaced"] = list(rollout[0].replaced)
    return out


def _same(got, want):
    for key in _EXACT:
        assert got[key] == want[key], key


def test_tp_fleet_crash_and_revival_equal_jax_router(ranks, jax_fleet):
    """2d: ``crash@serve_step:3`` fires on both model ranks of replica 1
    at the same iteration; every rank harvests its work alike, the
    survivor finishes it, and the replica comes back behind probation.
    Assignments, retries, quarantines, the health rows, statuses and
    greedy tokens equal the JAX router's, and every request terminates
    once."""
    want = jax_fleet["crash"]
    assert want["counters"]["serve.health.retries"] > 0
    assert any(len(a) > 1 for a in want["assignments"].values())
    for r in ranks:
        got = r["crash"]
        _same(got, want)
        assert got["invariant"]["holds"], r["rank"]


def test_tp_fleet_peer_raises_after_the_collectives(ranks, jax_fleet):
    """2d: only model rank 1 of replica 1 raises, at the end of its
    tick (after the step's collectives), so model rank 0 ticked cleanly:
    the replica is dead on every rank, its model rank 0 harvests after
    the gather and the harvest rides one more gather; the run equals the
    JAX router's with replica 1 raising at the same point."""
    want = jax_fleet["late"]
    assert want["health"][1][1:] == ("dead", 0, "RuntimeError")
    for r in ranks:
        got = r["late"]
        _same(got, want)
        assert got["invariant"]["holds"]
        assert got["exchanges"] == ranks[0]["late"]["exchanges"]


def test_tp_fleet_chaos_harness_equals_jax(ranks, jax_fleet):
    """2d: the chaos harness drives the tensor-parallel fleet through
    the seeded schedule (a crash, a skew and a dropped re-dispatch
    frame, the revival's engine built only on its group's ranks) and
    ends with the JAX harness's completions."""
    want = jax_fleet["chaos"]
    assert want["revived"] >= 1 and want["holds"]
    for r in ranks:
        assert r["chaos"] == want, r["rank"]


def test_tp_fleet_ledger_equals_jax_ledger(ranks, jax_fleet):
    """2g: one ledger on every rank, its bookings made inside a replica's
    tick replayed in replica order: every record's integer dimensions
    and every tenant's totals equal the JAX fleet ledger's, equal on
    every rank, and conservation holds."""
    want = jax_fleet["crash"]["ledger"]
    assert want["totals"]["retries"] > 0 and want["totals"]["evictions"] > 0
    for r in ranks:
        assert r["crash"]["ledger"] == want, r["rank"]
        assert r["crash"]["conservation"]["holds"], r["crash"]["conservation"]


def test_tp_fleet_merged_trace_equals_jax(ranks, jax_fleet):
    """2h: each replica's ring lives on its model rank 0 and reaches
    world rank 0 with its process's clock offset; per replica the span
    names and request ids equal the JAX router's trace of the same run,
    and world rank 0 alone returns a summary (and writes the file)."""
    got = ranks[0]["trace"]
    assert set(got) == set(jax_fleet["trace"]) == {0, 1}
    for pid, rows in jax_fleet["trace"].items():
        assert got[pid] == rows, pid
    assert ranks[0]["trace_summary"]["nranks"] == 2
    assert set(ranks[0]["trace_summary"]["clock_offsets"]) == {"0", "1"}
    for r in ranks[1:]:
        assert r["trace_summary"] is None


def test_tp_fleet_roles_dispatch_among_admitting(ranks, jax_fleet):
    """2f: ``roles=`` over the fleet: fresh work goes to the admitting
    replica alone, as in the JAX router."""
    want = jax_fleet["roles"]
    assert {a[0] for a in want["assignments"].values()} == {1}
    for r in ranks:
        _same(r["roles"], want)


def test_tp_fleet_disaggregated_groups(ranks, jax_fleet):
    """2f: a prefill group feeds a decode group, each model rank its own
    frame to the same model rank of the decode group: the tokens equal
    JAX ``serve_disaggregated`` over the two meshes, and the two frames
    of the first hand-off, concatenated along the head axis in
    model-rank order, are the JAX ``pack_slots`` payload (fp32, rtol =
    atol = 1e-5) with the same slot records."""
    want = jax_fleet["disagg"]
    _roles_agree(ranks, "disagg", want)
    frames = [ranks[m]["disagg"]["frame"] for m in range(2)]
    ref = want["frame"]
    for f in frames:
        assert f["slots"] == ref["slots"] and f["entries"] == ref["entries"]
        assert sorted(f["blocks"]) == sorted(ref["blocks"])
    for b, data in ref["blocks"].items():
        for layer, ref_layer in enumerate(data["target"]):
            for name, arr in ref_layer.items():
                got = np.concatenate([f["blocks"][b]["target"][layer][name]
                                      for f in frames], axis=0)
                np.testing.assert_allclose(got, np.asarray(arr), rtol=1e-5,
                                           atol=1e-5, err_msg=(b, name))


def _roles_agree(ranks, case, want):
    """Each rank's own role completions: equal within the prefill group
    and within the decode group, disjoint, and together JAX's."""
    own = [r[case]["tokens"] for r in ranks]
    assert own[1] == own[0] and own[3] == own[2]
    assert not set(own[0]) & set(own[2])
    assert {**own[0], **own[2]} == want["tokens"]


@pytest.mark.parametrize("case", ["disagg_torn", "disagg_gap"])
def test_tp_fleet_frame_lost_on_one_model_rank(ranks, jax_fleet, case):
    """2f: the first frame of prefill model rank 1 alone is torn (its
    checksum fails) or lost on its wire alone (a sequence gap), while
    model rank 0's copy arrives intact: both decode model ranks drop
    that hand-off alike, as a one-rank decode role drops a lost frame,
    and serve the rest as JAX ``serve_disaggregated`` does under
    ``drop@migrate:1``."""
    want = jax_fleet["disagg_lost"]
    assert len(want["tokens"]) < len(jax_fleet["disagg"]["tokens"])
    _roles_agree(ranks, case, want)
    assert [r[case]["failed"] > 0 for r in ranks[2:]] == [True, True]


def test_chaos_harness_refuses_a_world_of_other_size(ranks):
    """A harness asked for 3 replicas over a world of 2 groups raises on
    every rank instead of shifting the schedule's per-replica faults."""
    for r in ranks:
        assert "2 groups" in r["chaos_groups"], r["chaos_groups"]


@pytest.mark.parametrize("case", ["drain", "drain_drop"])
def test_tp_fleet_drain_between_groups(ranks, jax_fleet, case):
    """2f: ``drain_replica`` hands each model rank's KV heads to the same
    model rank of the survivor (or, under ``drop@migrate``, falls back
    to recompute before any detach), then ``deregister_replica`` returns
    the group to standby: nothing is lost and the run equals the JAX
    router's."""
    want = jax_fleet[case]
    if case == "drain":
        assert want["drain"]["slots_migrated"] > 0
    else:
        assert want["drain"]["dropped_frames"] == 1
    for r in ranks:
        got = r[case]
        _same(got, want)
        assert got["invariant"]["holds"]
        assert {k: got["drain"][k] for k in want["drain"]} == want["drain"]
        assert got["standby"] == [1]


def test_tp_fleet_scale_up_from_standby_group(ranks, jax_fleet):
    """2e: from one active group and one standby group, ``add_replica``
    activates the standby group (its ranks build the engine), and its
    drain and deregistration return it to standby: the run equals a JAX
    router that starts with one engine and then adds the second mesh."""
    want = jax_fleet["elastic"]
    for r in ranks:
        got = r["elastic"]
        _same(got, want)
        assert got["invariant"]["holds"]
        assert got["events"][0] == want["events"][0] == 1
        assert {k: got["events"][1][k] for k in want["events"][1]} == \
            want["events"][1]
        # The frames moved (the survivor, its slots busy, requeued it).
        assert got["events"][1]["frame_bytes"] > 0
        assert got["events"][2] == [1]


def test_tp_fleet_rolling_deploy_equals_jax(ranks, jax_fleet):
    """2e: a rolling deploy of version-2 weights over both replicas
    (drain, retire, revive on the same group) loses nothing and gives the
    JAX rollout's tokens."""
    want = jax_fleet["rollout"]
    assert want["replaced"] == [0, 1]
    for r in ranks:
        got = r["rollout"]
        _same(got, want)
        assert got["replaced"] == want["replaced"]
        assert got["invariant"]["holds"]


def test_poll_takes_an_arrived_frame(ranks):
    """A receive with a zero deadline (a decode role's poll) looks at
    the wire once: the object plane's waits once timed out before
    looking when the deadline was under a millisecond, so a decode group
    polling every 2 ms never received a frame."""
    assert ranks[1]["poll"] == "polled"


def test_read_block_is_a_copy_of_the_pool():
    """A packed block is the pool's contents when it was read: on a CPU
    engine ``read_block`` once returned a view of the pool, so a body
    held past a later write of that block (a frame kept for a retry, a
    deferred install) changed under its holder."""
    import torch

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine

    model = TransformerLM(**TP_MODEL, dtype=torch.float32, device="cpu")
    eng = DecodeEngine(model, **TP_ENGINE, device="cpu")
    before = eng.read_block(3)
    ones = {"target": [{n: np.ones_like(a) for n, a in layer.items()}
                       for layer in before["target"]], "draft": None}
    eng.write_block(3, ones)
    for layer in before["target"]:
        for arr in layer.values():
            assert not np.any(arr == 1.0)
    np.testing.assert_array_equal(eng.read_block(3)["target"][0]["k"],
                                  ones["target"][0]["k"])


def test_tp_fleet_autoscaler_agrees_on_every_rank(ranks):
    """2e: the autoscaler's signals come from each replica's model rank
    0: with model rank 1 of replica 0 alone publishing a breaching SLO
    drift into its own registry, every rank reads rank 0's value, and
    every rank makes the same decisions (the backlog's scale-up, which
    builds the standby group's engine) and ends with the same tokens."""
    first = ranks[0]["autoscale"]
    assert [d["action"] for d in first["decisions"]][:1] == ["scale_up"]
    assert all(d["reason"] != "autoscale_up_slo" for d in first["decisions"])
    for r in ranks:
        assert r["autoscale"] == first, r["rank"]
    assert first["drift"] != 10.0
