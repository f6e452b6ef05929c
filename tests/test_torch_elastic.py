"""The port's elastic serving fleet against the JAX package's
(``tests/serving_tests/test_elastic.py``), on the serving test geometry.

Held against the JAX run, exactly: the DRAINING fence; the zero-loss
drain on scale-down (slots handed off over the migration path, or, when
the handoff frame drops, requeued for recompute); the autoscaler's
decisions, hysteresis, cooldown and flaps, on a fixed clock and on one
stepped clock fed to both packages; the rolling deploy (new weights: a
second Flax init carried across with ``params_from_flax``, and the same
weights round-tripped through each package's multi-node checkpointer, as
the JAX package's own test loads them), its pause on a death and its
stall watchdog; the env knobs; and the chaos harness's elastic
schedules.  Tokens by the greedy divergence structure.

On the port alone: a deregistered or rolled-out engine releases its
device state, and the autoscaler publishes through no-op instruments
with observability off.
"""

import gc
import math
import weakref

import pytest

from torch_fleet_common import (
    FixedClock,
    StepClock,
    assert_same,
    build_models,
    by_id,
    jax_pkg,
    make_prompts,
    port_pkg,
    tokens_of,
)
from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture(scope="module")
def pkgs(models):
    return jax_pkg(models), port_pkg(models)


@pytest.fixture(scope="module")
def prompts():
    return make_prompts()


def both(pkgs, scenario, *args, **kw):
    return tuple(scenario(p, *args, **kw) for p in pkgs)


def _reqs(pkg, prompts, n, max_new=5):
    return [pkg.Request(id=i, prompt=prompts[i % len(prompts)],
                        max_new_tokens=max_new) for i in range(n)]


def _up(router):
    return [i for i in range(router.health.replicas)
            if router.health.is_up(i)]


def fence_scenario(pkg, prompts):
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=pkg.MetricsRegistry(), clock=FixedClock())
    router.health.start_draining(1)
    cands = router._admit_candidates()
    comps = router.run(_reqs(pkg, prompts, 4, max_new=4))
    return {"candidates": cands, "assignments": dict(router.assignments),
            "fenced_iterations": router.schedulers[1]._iterations,
            "statuses": by_id(comps, "status"), "tokens": tokens_of(comps)}


def test_draining_replica_fenced_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, fence_scenario, prompts)
    assert_same(got, ref)
    assert got["candidates"] == [0] and got["fenced_iterations"] == 0


def scale_down_scenario(pkg, prompts, drop):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine() for _ in range(2)], registry=reg,
                        clock=FixedClock(),
                        fault=pkg.inj("drop@migrate:1" if drop else None))
    n, max_new = (4, 12) if drop else (6, 6)
    reqs = _reqs(pkg, prompts, n, max_new=max_new)
    for r in reqs:
        router.submit(r)
    for _ in range(3 if drop else 5):
        router.tick()
    victim = router.schedulers[1]
    ready = len(victim.ready_slots())
    summary = router.drain_replica(1)
    drained = (victim.pending, victim.memory.check_drained(victim.engine))
    router.deregister_replica(1)
    router.run()
    comps = router.completions
    survivor = router.schedulers[0]
    return {
        "ready": ready, "summary": summary, "drained": drained,
        "report": pkg.verify_terminal_invariant(reqs, comps),
        "statuses": by_id(comps, "status", "retries", "evictions"),
        "assignments": dict(router.assignments),
        "conservation": router.ledger.verify_conservation(reqs)["holds"],
        "counters": {n: pkg.counter(reg, n) for n in (
            "serve.router.migrated", "serve.health.retries")},
        "survivor": (survivor.engine.decode_compiles,
                     survivor.memory.check_drained(survivor.engine)),
        "released": getattr(victim.engine, "released", None),
        "tokens": tokens_of(comps),
    }


@pytest.mark.parametrize("drop", [False, True], ids=["handoff", "dropped"])
def test_scale_down_drain_zero_loss_matches_jax(pkgs, prompts, drop):
    ref, got = both(pkgs, scale_down_scenario, prompts, drop)
    got_released = got.pop("released")
    ref.pop("released")
    assert_same(got, ref)
    assert got["report"]["holds"] and got["conservation"]
    assert got["drained"] == (False, 0) and got["survivor"] == (1, 0)
    if drop:
        assert got["summary"]["dropped_frames"] == 1
        assert got["summary"]["slots_migrated"] == 0
    else:
        assert got["summary"]["slots_migrated"] >= 1
    assert got_released  # the port's deregistered engine freed its pools


def test_deregister_releases_replica_state(pkgs, prompts):
    """Deregistration drops every strong reference to the replica's
    scheduler, span ring, registry and engine, and moves its finished
    completions to the router's books."""
    jp, tp = pkgs

    def scenario(pkg):
        router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                            registry=pkg.MetricsRegistry(),
                            clock=FixedClock())
        router.run(_reqs(pkg, prompts, 2, max_new=3))
        refs = [weakref.ref(o) for o in (
            router.schedulers[1], router.rings[1],
            router.replica_registries[1], router.schedulers[1].engine)]
        before = {c.id for c in router.completions}
        router.drain_replica(1)
        router.deregister_replica(1)
        gc.collect()
        out = {"alive": [r() is not None for r in refs],
               "kept": {c.id for c in router.completions} == before,
               "state": router.health.state(1),
               "candidates": router._admit_candidates(),
               "stats_engine": router.replica_stats()[1]["engine"]}
        comps = router.run(_reqs(pkg, prompts, 1, max_new=3))
        out["tokens"] = tokens_of(comps)
        return out

    ref, got = scenario(jp), scenario(tp)
    assert_same(got, ref)
    assert got["alive"][:3] == [False, False, False]
    assert got["state"] == "removed" and got["kept"]


def up_scenario(pkg, prompts):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1)], registry=reg,
                        clock=FixedClock(), max_queue=1)
    scaler = pkg.Autoscaler(router, lambda: pkg.engine(capacity=1),
                            registry=reg, up_depth=3, hysteresis=2,
                            cooldown_ticks=4, max_replicas=2)
    for r in _reqs(pkg, prompts, 8, max_new=3):
        router.submit(r)
    router.tick()
    actions = [scaler.tick(), scaler.tick()]
    state = router.health.state(1)
    actions.append(scaler.tick())
    comps = router.run()
    return {"actions": actions, "state": state,
            "counters": {n: pkg.counter(reg, n) for n in (
                "serve.autoscale.scale_up", "serve.autoscale.replicas")},
            "replica_ticks": scaler.replica_ticks,
            "statuses": by_id(comps, "status"), "tokens": tokens_of(comps)}


def test_autoscaler_scales_up_on_backlog_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, up_scenario, prompts)
    assert_same(got, ref)
    assert got["actions"][1] == {"tick": 2, "action": "scale_up",
                                 "replica": 1,
                                 "reason": "autoscale_up_backlog"}
    assert got["state"] == "probation"


def down_scenario(pkg):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(3)],
                        registry=reg, clock=FixedClock())
    scaler = pkg.Autoscaler(router, lambda: pkg.engine(capacity=1),
                            registry=reg, down_occ=0.3, hysteresis=2,
                            cooldown_ticks=0, min_replicas=2)
    actions = [a for _ in range(6) if (a := scaler.tick()) is not None]
    return {"actions": actions, "up": _up(router),
            "states": [router.health.state(i) for i in range(3)],
            "counters": {n: pkg.counter(reg, n) for n in (
                "serve.autoscale.scale_down", "serve.autoscale.replicas")}}


def test_autoscaler_scales_down_to_min_matches_jax(pkgs):
    ref, got = both(pkgs, down_scenario)
    assert_same(got, ref)
    assert [a["action"] for a in got["actions"]] == ["scale_down"]
    assert len(got["up"]) == 2


def flap_scenario(pkg, prompts, down_hysteresis):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=reg, clock=FixedClock(), max_queue=1)
    scaler = pkg.Autoscaler(
        router, lambda: pkg.engine(capacity=1), registry=reg, up_depth=3,
        down_occ=0.3, hysteresis=1, down_hysteresis=down_hysteresis,
        cooldown_ticks=16, min_replicas=1, max_replicas=3)
    for r in _reqs(pkg, prompts, 8, max_new=3):
        router.submit(r)
    router.tick()
    actions = [scaler.tick()]
    comps = router.run()
    actions += [scaler.tick(), scaler.tick()]
    return {"actions": actions, "flaps": scaler.flaps,
            "flap_counter": pkg.counter(reg, "serve.autoscale.flap"),
            "watches": [(w.name, w.hysteresis, d)
                        for w, d in scaler.watches],
            "up": _up(router), "tokens": tokens_of(comps)}


@pytest.mark.parametrize("down_hysteresis", [None, 3],
                         ids=["flap", "damped"])
def test_autoscaler_cooldown_and_hysteresis_match_jax(pkgs, prompts,
                                                      down_hysteresis):
    ref, got = both(pkgs, flap_scenario, prompts, down_hysteresis)
    assert_same(got, ref)
    assert got["actions"][0]["action"] == "scale_up"
    assert got["flaps"] == (0 if down_hysteresis else 2)


def stepped_scenario(pkg, prompts):
    """Sinusoid-plus-burst arrivals on one stepped clock: a tick is
    50 ms, arrivals follow a rate that rises, falls and bursts."""
    clock = StepClock()
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1)], registry=reg,
                        clock=clock, max_queue=1)
    scaler = pkg.Autoscaler(
        router, lambda: pkg.engine(capacity=1), registry=reg,
        min_replicas=1, max_replicas=3, up_depth=1, down_occ=0.3,
        hysteresis=1, down_hysteresis=3, cooldown_ticks=4)
    t, reqs = 0.0, []
    for i in range(14):
        t += 0.05 + 0.04 * math.sin(i / 2.0) + (0.0 if i % 7 else 0.3)
        reqs.append(pkg.Request(id=i, prompt=prompts[i % 5],
                                max_new_tokens=4, arrival=round(t, 3)))
    for r in reqs:
        router.submit(r)
    ticks, idle = 0, 0
    while router.pending or idle < 12:
        clock.skip_to(clock.now() + 0.05)
        router.tick()
        scaler.tick()
        ticks += 1
        idle = 0 if router.pending else idle + 1
        assert ticks < 400
    router.finish()
    comps = router.completions
    return {"decisions": scaler.decisions, "flaps": scaler.flaps,
            "replica_ticks": scaler.replica_ticks, "ticks": ticks,
            "report": pkg.verify_terminal_invariant(reqs, comps),
            "assignments": dict(router.assignments),
            "tokens": tokens_of(comps)}


def test_autoscaler_on_a_stepped_clock_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, stepped_scenario, prompts)
    assert_same(got, ref)
    actions = [d["action"] for d in got["decisions"]]
    assert "scale_up" in actions and "scale_down" in actions
    assert got["report"]["holds"] and got["flaps"] == 0


def rollout_scenario(pkg, prompts, new_params):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine() for _ in range(2)], registry=reg,
                        clock=FixedClock(), probation_ticks=2)
    old = [s.engine for s in router.schedulers]
    reqs = _reqs(pkg, prompts, 6, max_new=5)
    for r in reqs:
        router.submit(r)
    for _ in range(3):
        router.tick()
    rollout = pkg.RollingDeploy(router, lambda params: pkg.engine(
        params=params), params=new_params, registry=reg, timeout_ticks=64)
    pending = list(rollout.pending)
    guard = 0
    while not rollout.done:
        router.tick()
        rollout.tick()
        guard += 1
        assert guard < 200
    router.run()
    comps = router.completions
    return {
        "pending": pending, "replaced": rollout.replaced,
        "paused": rollout.paused, "ticks": guard,
        "counters": {n: pkg.counter(reg, n) for n in (
            "serve.rollout.replaced", "serve.rollout.in_progress")},
        "report": pkg.verify_terminal_invariant(reqs, comps),
        "statuses": by_id(comps, "status", "retries", "evictions"),
        "new": [s.engine is not old[i]
                for i, s in enumerate(router.schedulers)],
        "compiles": [s.engine.decode_compiles for s in router.schedulers],
        "states": [router.health.state(i) for i in range(2)],
        "_released": [getattr(e, "released", None) for e in old],
        "tokens": tokens_of(comps),
    }


def test_rolling_deploy_new_weights_zero_loss_matches_jax(pkgs, models,
                                                          prompts):
    import jax
    import jax.numpy as jnp
    import numpy as np

    (jm, _, _), _ = models
    new = jax.jit(jm.init)(jax.random.PRNGKey(1),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    new = jax.tree_util.tree_map(np.asarray, new)
    ref, got = both(pkgs, rollout_scenario, prompts, new)
    released = got.pop("_released")
    ref.pop("_released")
    assert_same(got, ref)
    assert got["replaced"] == [0, 1] and not got["paused"]
    assert got["report"]["holds"] and got["new"] == [True, True]
    assert set(got["compiles"]) <= {0, 1} and got["states"] == ["live"] * 2
    assert released == [True, True]


def test_rolling_deploy_checkpointed_params_zero_loss_matches_jax(
        pkgs, models, prompts, tmp_path):
    """The twin of the JAX package's
    ``test_rolling_deploy_checkpointed_params_zero_loss``: the port's
    rollout loads what its checkpointer restored (a model of other weights
    restored through ``create_multi_node_checkpointer(...).maybe_load``,
    equal byte for byte to the saved one); the JAX rollout takes the same
    weights (its own test round-trips them through orbax)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )
    from chainermn_tpu_torch.utils import params_from_flax
    from torch_fleet_common import KW

    (jm, _, _), _ = models
    new = jax.jit(jm.init)(jax.random.PRNGKey(1),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    new = jax.tree_util.tree_map(np.asarray, new)
    tcomm = create_communicator("xla", device="cpu")

    def lm(seed):
        return TransformerLM(**KW, dtype=torch.float32,
                             decode_attention="fused", device="cpu",
                             seed=seed)

    src = lm(0)
    src.load_state_dict(params_from_flax(new, device="cpu"))
    topt = create_multi_node_optimizer(sgd(0.1), tcomm)
    create_multi_node_checkpointer("deploy", tcomm, path=str(tmp_path),
                                   async_save=False).save(topt.init(src))
    dst = lm(7)
    state, _ = create_multi_node_checkpointer(
        "deploy", tcomm, path=str(tmp_path)).maybe_load(topt.init(dst))
    for n, t in state.model.state_dict().items():
        assert torch.equal(t, src.state_dict()[n]), n
    jax_pkg, port_pkg = pkgs
    ref = rollout_scenario(jax_pkg, prompts, new)
    got = rollout_scenario(port_pkg, prompts, state.model)
    released = got.pop("_released")
    ref.pop("_released")
    assert_same(got, ref)
    assert got["replaced"] == [0, 1] and not got["paused"]
    assert got["report"]["holds"] and got["new"] == [True, True]
    assert released == [True, True]


def pause_scenario(pkg, directory):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=reg, clock=FixedClock(), probation_ticks=1)
    router.incidents = pkg.incident.IncidentManager(
        registry=reg, rules=[], directory=str(directory), cooldown_s=0.0)
    rollout = pkg.RollingDeploy(router, lambda: pkg.engine(capacity=1),
                                registry=reg)
    router.health.mark_dead(1, "chaos")
    guard = 0
    while not rollout.paused and not rollout.done:
        router.tick()
        rollout.tick()
        guard += 1
        assert guard < 50
    out = {"paused": rollout.paused, "done": rollout.done, "ticks": guard,
           "replaced": list(rollout.replaced),
           "bundles": sorted(p.name.split("-", 3)[-1]
                             for p in directory.iterdir() if p.is_dir())}
    router.revive_replica(1, pkg.engine(capacity=1))
    rollout.resume()
    out["resumed"] = not rollout.paused
    return out


def test_rollout_pauses_and_files_incident_matches_jax(pkgs, tmp_path):
    jp, tp = pkgs
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = pause_scenario(jp, tmp_path / "jax")
    got = pause_scenario(tp, tmp_path / "port")
    assert_same(got, ref)
    assert got["paused"] and got["resumed"]
    assert any("rollout_interrupted" in b for b in got["bundles"])


def stall_scenario(pkg):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=reg, clock=FixedClock(),
                        probation_ticks=500)
    rollout = pkg.RollingDeploy(router, lambda: pkg.engine(capacity=1),
                                registry=reg, timeout_ticks=3)
    for _ in range(6):
        rollout.tick()
    return {"stalled": pkg.counter(reg, "serve.rollout.stalled"),
            "done": rollout.done, "paused": rollout.paused,
            "current": rollout.current}


def test_rollout_stall_watchdog_matches_jax(pkgs):
    ref, got = both(pkgs, stall_scenario)
    assert_same(got, ref)
    assert got["stalled"] == 1 and not got["done"]


@pytest.mark.parametrize("env", [
    {}, {"CMN_SERVE_SCALE_UP_DEPTH": "9", "CMN_SERVE_SCALE_UP_DRIFT": "0.5",
         "CMN_SERVE_SCALE_DOWN_OCC": "0.1", "CMN_SERVE_SCALE_HYSTERESIS": "4",
         "CMN_SERVE_SCALE_COOLDOWN_TICKS": "32", "CMN_SERVE_SCALE_MIN": "2",
         "CMN_SERVE_SCALE_MAX": "1", "CMN_SERVE_ROLLOUT_TIMEOUT_TICKS": "64"},
    {"CMN_SERVE_SCALE_UP_DEPTH": "junk", "CMN_SERVE_SCALE_MAX": "6"},
])
def test_elastic_env_knobs_match_jax(pkgs, monkeypatch, env):
    names = ("scale_up_depth", "scale_up_drift", "scale_down_occ",
             "scale_hysteresis", "scale_cooldown", "scale_bounds",
             "rollout_timeout")
    for k in ("CMN_SERVE_SCALE_UP_DEPTH", "CMN_SERVE_SCALE_UP_DRIFT",
              "CMN_SERVE_SCALE_DOWN_OCC", "CMN_SERVE_SCALE_HYSTERESIS",
              "CMN_SERVE_SCALE_COOLDOWN_TICKS", "CMN_SERVE_SCALE_MIN",
              "CMN_SERVE_SCALE_MAX", "CMN_SERVE_ROLLOUT_TIMEOUT_TICKS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp, tp = pkgs
    assert [getattr(tp.elastic, n + "_from_env")() for n in names] == \
        [getattr(jp.elastic, n + "_from_env")() for n in names]


def elastic_chaos_scenario(pkg, prompts, schedule, n, max_new,
                           **harness_kw):
    reg = pkg.MetricsRegistry()
    harness = pkg.ChaosHarness(
        lambda: pkg.engine(), replicas=3, seed=0, registry=reg,
        revive_after=2, schedule=schedule, probation_ticks=4,
        clock=FixedClock(), **harness_kw)
    reqs = _reqs(pkg, prompts, n, max_new=max_new)
    report = harness.run(reqs)
    router = harness.router
    comps = router.completions
    return {
        "report": {k: report.get(k) for k in (
            "holds", "by_status", "lost", "duplicated", "revived",
            "rollout")},
        "elastic": [{k: v for k, v in e.items() if k != "drain"}
                    for e in report.get("elastic", ())],
        "drains": [e["drain"] for e in report.get("elastic", ())
                   if "drain" in e],
        "states": [router.health.state(i)
                   for i in range(router.health.replicas)],
        "counters": {n: pkg.counter(reg, n) for n in (
            "serve.health.replica_dead", "serve.rollout.replaced",
            "serve.autoscale.replicas")},
        "statuses": by_id(comps, "status", "retries"),
        "compiles": [s.engine.decode_compiles
                     for i, s in enumerate(router.schedulers)
                     if s is not None and router.health.is_up(i)],
        "drained": [s.memory.check_drained(s.engine)
                    for i, s in enumerate(router.schedulers)
                    if s is not None and router.health.is_up(i)],
        "tokens": tokens_of(comps),
    }


CRASH_DURING_DRAIN = {
    "seed": None,
    "replica_faults": [None, "crash@serve_step:3", None],
    "router_faults": "drop@migrate:1",
    "elastic": [{"tick": 2, "event": "scale_up"},
                {"tick": 5, "event": "scale_down"}],
}
MID_ROLLOUT = {
    "seed": None,
    "replica_faults": [None, None, None],
    "router_faults": "drop@migrate:1",
    "elastic": [{"tick": 3, "event": "rollout"}],
}


@pytest.mark.parametrize("case", ["crash_during_drain", "mid_rollout",
                                  "seeded"])
def test_chaos_elastic_schedules_match_jax(pkgs, prompts, case):
    jp, tp = pkgs
    if case == "crash_during_drain":
        args = (CRASH_DURING_DRAIN, 8, 5)
        kw = {}
    elif case == "mid_rollout":
        args = (MID_ROLLOUT, 8, 5)
        kw = dict(max_revives=0)
    else:
        args = (tp.chaos_schedule(11, 3, scale_ups=1, scale_downs=1), 6, 5)
        kw = {}
    ref, got = both(pkgs, elastic_chaos_scenario, prompts, *args, **kw)
    assert_same(got, ref)
    assert got["report"]["holds"]
    assert set(got["compiles"]) <= {0, 1} and set(got["drained"]) == {0}
    if case == "mid_rollout":
        assert sorted(got["report"]["rollout"]["replaced"]) == [0, 1, 2]
        assert got["counters"]["serve.rollout.replaced"] == 3


def test_autoscaler_noop_instruments_when_obs_off(pkgs, monkeypatch):
    _, tp = pkgs
    from chainermn_tpu_torch.observability.metrics import NoopInstrument

    monkeypatch.setenv("CMN_OBS", "0")
    router = tp.Router([tp.engine(capacity=1)],
                       registry=tp.MetricsRegistry())
    scaler = tp.Autoscaler(router, lambda: tp.engine(capacity=1))
    assert isinstance(scaler._m_flap, NoopInstrument)
    assert isinstance(scaler._m_replicas, NoopInstrument)
    assert scaler.tick() is None
