"""The port's serving failure plane against the JAX package's
(``tests/serving_tests/test_chaos.py``), on the serving test geometry.

Held against the JAX package, exactly: ``chaos_schedule``'s event lists
for the same seeds; ``FleetHealth``'s transitions, refusals and
counters; ``verify_terminal_invariant``'s reports; the env knobs; and,
through the Router on a fixed (or stepped) clock, harvest and
re-dispatch, the retry budget and poison quarantine, probation,
deadlines and shedding, the ``drop@migrate`` re-dispatch retry, and the
terminal statuses of a ``ChaosHarness`` run under the same schedule.
Tokens are held by the greedy divergence structure.

On the port alone: the fault boundary re-raises a CUDA error instead of
harvesting the replica (its context is shared by every replica of the
process), harvests a host-side one, and releases a dead engine's
device state.
"""

import pytest
import torch

from torch_fleet_common import (
    FixedClock,
    StepClock,
    assert_same,
    build_models,
    by_id,
    error_kind,
    jax_pkg,
    make_prompts,
    port_pkg,
    tokens_of,
)
from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

HEALTH = ("serve.health.replica_dead", "serve.health.recovered",
          "serve.health.retries", "serve.health.poisoned",
          "serve.health.shed", "serve.health.probation",
          "serve.health.draining", "serve.health.deadline_cancels")


@pytest.fixture(scope="module")
def pkgs():
    models = build_models()
    return jax_pkg(models), port_pkg(models)


@pytest.fixture(scope="module")
def prompts():
    return make_prompts()


def both(pkgs, scenario, *args, **kw):
    return tuple(scenario(p, *args, **kw) for p in pkgs)


def _health(pkg, reg, router):
    return {
        "counters": {n: pkg.counter(reg, n) for n in HEALTH},
        "states": [router.health.state(i)
                   for i in range(router.health.replicas)],
    }


# ------------------------------------------------------- pure functions
@pytest.mark.parametrize("seed,replicas,kw", [
    (0, 3, {}), (1, 3, {}), (3, 2, {}), (7, 4, {}),
    (5, 3, dict(crash_p=0.0, skew_p=0.0)),
    (2, 3, dict(drops=3, crash_iters=(2, 5))),
    (4, 3, dict(scale_ups=2, scale_downs=1, rollout_at=6)),
    (9, 5, dict(scale_ups=1, elastic_ticks=(1, 4))),
])
def test_chaos_schedule_matches_jax(pkgs, seed, replicas, kw):
    jp, tp = pkgs
    got = tp.chaos_schedule(seed, replicas, **kw)
    assert got == jp.chaos_schedule(seed, replicas, **kw)
    assert got == tp.chaos_schedule(seed, replicas, **kw)
    assert any(s and "crash@serve_step" in s
               for s in got["replica_faults"])
    for s in got["replica_faults"] + [got["router_faults"]]:
        if s:
            tp.parse_fault_spec(s)


HEALTH_OPS = [
    ("mark_dead", 0, "boom"), ("start_probation", 1), ("start_probation", 0),
    ("clean_tick", 0), ("clean_tick", 0), ("clean_tick", 0),
    ("start_draining", 1), ("start_probation", 1), ("mark_retired", 1),
    ("start_probation", 1), ("clean_tick", 1), ("add_replica",),
    ("start_probation", 2), ("start_draining", 2), ("remove_replica", 2),
    ("remove_replica", 0), ("mark_dead", 0, "again"),
    ("remove_replica", 0), ("start_draining", 0),
]


def health_scenario(pkg):
    reg = pkg.MetricsRegistry()
    h = pkg.FleetHealth(2, registry=reg, probation_ticks=2,
                        retry_budget=3)
    trail = []
    for op, *args in HEALTH_OPS:
        try:
            res = getattr(h, op)(*args)
            trail.append((op, res))
        except ValueError:
            trail.append((op, "ValueError"))
        trail.append(tuple(h.snapshot()[i]["state"]
                           for i in range(h.replicas)))
        trail.append((h.dead_replicas,
                      [h.can_admit(i) for i in range(h.replicas)],
                      [h.is_up(i) for i in range(h.replicas)]))
    return {"trail": trail, "snapshot": h.snapshot(),
            "counters": {n: pkg.counter(reg, n) for n in HEALTH}}


def test_fleet_health_transitions_match_jax(pkgs):
    ref, got = both(pkgs, health_scenario)
    assert_same(got, ref)
    assert ("start_probation", "ValueError") in got["trail"]


def invariant_scenario(pkg):
    C = pkg.scheduler.Completion

    def comp(i, status="ok"):
        return C(id=i, tokens=[], reason=status, prompt_len=1, arrival=0.0,
                 admitted_at=0.0, finished_at=0.0, status=status)

    reqs = [pkg.Request(id=i, prompt=[1, 2], max_new_tokens=2)
            for i in range(3)]
    cases = [[comp(0), comp(1), comp(2)], [comp(0), comp(1)],
             [comp(0), comp(1), comp(2), comp(2)],
             [comp(0), comp(1, "shed"), comp(2, "poisoned"), comp(7)]]
    return {"reports": [pkg.verify_terminal_invariant(reqs, c)
                        for c in cases]}


def test_verify_terminal_invariant_matches_jax(pkgs):
    ref, got = both(pkgs, invariant_scenario)
    assert_same(got, ref)
    assert [r["holds"] for r in got["reports"]] == [True, False, False,
                                                    False]


@pytest.mark.parametrize("env", [
    {}, {"CMN_SERVE_RETRY_BUDGET": "5", "CMN_SERVE_PROBATION_TICKS": "9",
         "CMN_ROUTER_SHED_DEPTH": "7", "CMN_SERVE_DEADLINE_MS": "250"},
    {"CMN_SERVE_RETRY_BUDGET": "junk", "CMN_SERVE_DEADLINE_MS": "0"},
])
def test_env_knobs_match_jax(pkgs, monkeypatch, env):
    for k in ("CMN_SERVE_RETRY_BUDGET", "CMN_SERVE_PROBATION_TICKS",
              "CMN_ROUTER_SHED_DEPTH", "CMN_SERVE_DEADLINE_MS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    vals = [(p.recovery.retry_budget_from_env(),
             p.recovery.probation_ticks_from_env(),
             p.recovery.shed_depth_from_env(),
             p.recovery.deadline_ms_from_env(),
             p.FleetHealth(1).retry_budget) for p in pkgs]
    assert vals[0] == vals[1]


# ------------------------------------------------------ router failures
def router_scenario(pkg, prompts, faults, n=1, max_new=6, capacity=1,
                    router_fault=None, prompt_of=None, **router_kw):
    reg = pkg.MetricsRegistry()
    router = pkg.Router(
        [pkg.engine(capacity=capacity) for _ in faults], registry=reg,
        clock=FixedClock(), faults=[pkg.inj(s) for s in faults],
        fault=pkg.inj(router_fault), **router_kw)
    comps = router.run([pkg.Request(
        id=i, prompt=prompts[(prompt_of or (lambda i: i % 5))(i)],
        max_new_tokens=max_new) for i in range(n)])
    up = [s.engine.decode_compiles for i, s in enumerate(router.schedulers)
          if router.health.is_up(i)]
    return {"statuses": by_id(comps, "status", "reason", "retries",
                              "evictions"),
            "errors": {c.id: error_kind(c.error) for c in comps},
            "assignments": dict(router.assignments),
            "health": _health(pkg, reg, router),
            "recovered_parked": len(router._recovered),
            "survivor_compiles": up,
            "tokens": tokens_of(comps)}


def test_crash_mid_stream_recovery_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, router_scenario, prompts,
                    ["crash@serve_step:3", None], n=4, capacity=2)
    assert_same(got, ref)
    assert got["health"]["states"] == ["dead", "live"]
    assert any(st[2] == 1 for st in got["statuses"].values())
    assert all(st[0] == "ok" for st in got["statuses"].values())
    assert got["survivor_compiles"] == [1]


def test_retry_budget_poisons_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, router_scenario, prompts,
                    ["crash@serve_step:1", "crash@serve_step:1"],
                    retry_budget=2)
    assert_same(got, ref)
    assert got["statuses"] == {0: ("poisoned", "poisoned", 2, 2)}
    assert got["errors"] == {0: "InjectedFault"}


def test_sub_budget_crash_recovers_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, router_scenario, prompts,
                    ["crash@serve_step:2", None], prompt_of=lambda i: 1)
    assert_same(got, ref)
    assert got["statuses"][0][:3] == ("ok", "length", 1)


def test_drop_migrate_redispatch_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, router_scenario, prompts,
                    ["crash@serve_step:2", None],
                    router_fault="drop@migrate:1", prompt_of=lambda i: 2)
    assert_same(got, ref)
    assert got["health"]["counters"]["serve.health.retries"] == 2
    assert got["health"]["counters"]["serve.health.recovered"] == 1


def probation_scenario(pkg, prompts):
    reg = pkg.MetricsRegistry()
    router = pkg.Router(
        [pkg.engine(capacity=1) for _ in range(2)], registry=reg,
        clock=FixedClock(),
        faults=[pkg.inj("crash@serve_step:2"), pkg.inj("crash@serve_step:3")],
        probation_ticks=3, retry_budget=4)
    router.submit(pkg.Request(id=0, prompt=prompts[0], max_new_tokens=8))
    trail = []
    while not router.health.dead_replicas:
        router.tick()
    try:
        router.revive_replica(1, None)
    except ValueError:
        trail.append("refused")
    router.revive_replica(0, pkg.engine(capacity=1))
    trail.append(_health(pkg, reg, router))
    trail.append(router._ranked_replicas(probation_ok=False))
    while router.health.is_up(1):
        if not router.tick():
            break
    trail.append((_health(pkg, reg, router), len(router._recovered),
                  dict(router.assignments)))
    comps = router.run()
    return {"trail": trail, "health": _health(pkg, reg, router),
            "statuses": by_id(comps, "status", "retries"),
            "assignments": dict(router.assignments),
            "tokens": tokens_of(comps)}


def test_probation_circuit_breaker_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, probation_scenario, prompts)
    assert_same(got, ref)
    assert got["trail"][0] == "refused"
    assert got["trail"][-1][1] == 1     # parked, not sent to probation
    assert got["health"]["states"] == ["live", "dead"]


def probation_weight_scenario(pkg, prompts):
    router = pkg.Router(
        [pkg.engine(capacity=1) for _ in range(2)],
        registry=pkg.MetricsRegistry(), clock=FixedClock(),
        faults=[pkg.inj("crash@serve_step:1"), None], probation_ticks=50)
    router.run([pkg.Request(id=0, prompt=prompts[0], max_new_tokens=4)])
    router.revive_replica(0, pkg.engine(capacity=1))
    return {"ranked": router._ranked_replicas(),
            "full_trust": router._ranked_replicas(probation_ok=False)}


def test_probation_reduced_weight_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, probation_weight_scenario, prompts)
    assert_same(got, ref)
    assert got == {"ranked": [1, 0], "full_trust": [1]}


def deadline_scenario(pkg, prompts):
    """A long request with a deadline cancelled mid-stream, a queued one
    past its deadline, on a stepped clock."""
    reg = pkg.MetricsRegistry()
    clock = StepClock()
    eng = pkg.engine(capacity=1)
    sched = pkg.Scheduler(eng, registry=reg, clock=clock)
    sched.submit(pkg.Request(id=0, prompt=prompts[0], max_new_tokens=64,
                             deadline_ms=6e4))
    sched.submit(pkg.Request(id=1, prompt=prompts[1], max_new_tokens=4,
                             deadline_ms=1e3))
    sched.submit(pkg.Request(id=2, prompt=prompts[2], max_new_tokens=4))
    for _ in range(6):
        sched.tick()
    clock.skip_to(3600.0)
    comps = sched.run()
    return {"statuses": by_id(comps, "status", "reason"),
            "lengths": {c.id: len(c.tokens) for c in comps},
            "cancels": pkg.counter(reg, "serve.health.deadline_cancels"),
            "drained": sched.memory.check_drained(eng),
            "tokens": tokens_of(comps)}


def test_deadlines_match_jax(pkgs, prompts):
    ref, got = both(pkgs, deadline_scenario, prompts)
    assert_same(got, ref)
    assert got["statuses"][0][0] == "deadline"
    assert got["statuses"][1] == ("deadline", "deadline")
    assert 0 < got["lengths"][0] < 64 and got["drained"] == 0


def shed_scenario(pkg, prompts):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1)], registry=reg,
                        clock=FixedClock(), max_queue=1, shed_depth=2)
    reqs = [pkg.Request(id=i, prompt=prompts[i % 5], max_new_tokens=4)
            for i in range(8)]
    comps = router.run(reqs)
    report = pkg.verify_terminal_invariant(reqs, comps)
    return {"report": report,
            "statuses": by_id(comps, "status"),
            "shed_errors": sorted({c.error for c in comps
                                   if c.status == "shed"}),
            "shed": pkg.counter(reg, "serve.health.shed"),
            "tokens": tokens_of(comps)}


def test_shed_depth_matches_jax(pkgs, prompts):
    ref, got = both(pkgs, shed_scenario, prompts)
    assert_same(got, ref)
    assert got["report"]["holds"]
    assert sorted(i for i, (s,) in got["statuses"].items()
                  if s == "shed") == [3, 4, 5, 6, 7]


SCHEDULE = {
    "seed": None,
    "replica_faults": ["crash@serve_step:4",
                       "skew@serve_step:2:5ms;crash@serve_step:8", None],
    "router_faults": "drop@migrate:1",
}


def chaos_scenario(pkg, prompts, schedule, seed, n, max_new):
    reg = pkg.MetricsRegistry()
    harness = pkg.ChaosHarness(
        lambda: pkg.engine(capacity=2), replicas=3, seed=seed,
        registry=reg, revive_after=2, schedule=schedule,
        clock=FixedClock())
    reqs = [pkg.Request(id=i, prompt=prompts[i % 5],
                        max_new_tokens=max_new) for i in range(n)]
    report = harness.run(reqs)
    router = harness.router
    comps = router.completions
    return {
        "report": {k: report[k] for k in ("holds", "by_status", "lost",
                                          "duplicated", "revived",
                                          "schedule")},
        "health": _health(pkg, reg, router),
        "statuses": by_id(comps, "status", "retries"),
        "assignments": dict(router.assignments),
        "compiles": [s.engine.decode_compiles
                     for i, s in enumerate(router.schedulers)
                     if router.health.is_up(i) and s._iterations],
        "drained": [s.memory.check_drained(s.engine)
                    for i, s in enumerate(router.schedulers)
                    if router.health.is_up(i)],
        "tokens": tokens_of(comps),
    }


@pytest.mark.parametrize("schedule,seed,n,max_new", [
    (SCHEDULE, 0, 8, 5), (None, 3, 6, 5),
], ids=["explicit", "seeded"])
def test_chaos_harness_terminal_statuses_match_jax(pkgs, prompts, schedule,
                                                   seed, n, max_new):
    ref, got = both(pkgs, chaos_scenario, prompts, schedule, seed, n,
                    max_new)
    assert_same(got, ref)
    assert got["report"]["holds"]
    assert got["report"]["lost"] == [] == got["report"]["duplicated"]
    assert set(got["compiles"]) == {1} and set(got["drained"]) == {0}


# ------------------------------------------------------------ port only
class _Faulty:
    """Wraps an engine so that its decode step raises ``exc`` once."""

    def __init__(self, engine, exc):
        self._engine, self._exc = engine, exc

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self, *a, **kw):
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc
        return self._engine.step(*a, **kw)


DEVICE_ERRORS = [RuntimeError(
    "CUDA error: an illegal memory access was encountered")]
if getattr(torch, "AcceleratorError", None) is not None:
    try:
        DEVICE_ERRORS.append(torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered"))
    except TypeError:  # pragma: no cover - constructor without a message
        pass


@pytest.mark.parametrize("exc", DEVICE_ERRORS,
                         ids=lambda e: type(e).__name__)
def test_cuda_error_escapes_the_fault_boundary(pkgs, prompts, exc):
    """A CUDA error is sticky for the process whose replicas all share
    one context: the boundary re-raises it, no replica is harvested."""
    _, tp = pkgs
    from chainermn_tpu_torch.serving.router import device_fault

    assert device_fault(exc)
    router = tp.Router([_Faulty(tp.engine(), exc), tp.engine()],
                       registry=tp.MetricsRegistry(), clock=FixedClock())
    with pytest.raises(type(exc), match="CUDA error"):
        router.run([tp.Request(id=i, prompt=prompts[i], max_new_tokens=4)
                    for i in range(4)])
    assert router.health.dead_replicas == []
    assert router.health.m_dead.value == 0


def test_host_error_is_harvested_and_engine_released(pkgs, prompts):
    _, tp = pkgs
    from chainermn_tpu_torch.serving.router import device_fault

    exc = RuntimeError("host-side defect")
    assert not device_fault(exc)
    inner = tp.engine()
    router = tp.Router([_Faulty(inner, exc), tp.engine()],
                       registry=tp.MetricsRegistry(), clock=FixedClock())
    comps = router.run([tp.Request(id=i, prompt=prompts[i],
                                   max_new_tokens=4) for i in range(4)])
    assert sorted(c.id for c in comps) == [0, 1, 2, 3]
    assert all(c.status == "ok" for c in comps)
    assert router.health.state(0) == "dead"
    assert router.health.errors[0] == "RuntimeError: host-side defect"
    # The dead engine's device state is gone; its host books stay.
    assert inner.released and all(not layer for layer in inner.pools)
    assert inner.stats()["capacity"] == inner.capacity
    with pytest.raises(RuntimeError, match="released"):
        inner.read_block(1)
