"""The port's serving router against the JAX package's
(``tests/serving_tests/test_router.py``), on the serving test geometry.

Each scenario runs once per package on a fixed clock (``now() == 0``), so
every dispatch decision and every integer is deterministic.  Held
against the JAX run, exactly: ``Router.assignments``; the dispatch,
holdback, backpressure and steal counters; the fleet trace's pids and
each replica's span sequence; the policy plane's admission order, its
fleet-wide per-tenant queue census and the per-tenant ``shed``
holdback; the shared ledger's records.  Tokens are held by the greedy
divergence structure (``torch_fleet_common.assert_same``).
"""

import json

import pytest

from torch_fleet_common import (
    FixedClock,
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

ROUTER_COUNTERS = ("serve.router.dispatched", "serve.router.migrated",
                   "serve.router.backpressure", "serve.router.queue_depth")


@pytest.fixture(scope="module")
def pkgs():
    models = build_models()
    return jax_pkg(models), port_pkg(models)


@pytest.fixture(scope="module")
def prompts():
    return make_prompts()


def _router_counters(pkg, reg):
    out = {n: pkg.counter(reg, n) for n in ROUTER_COUNTERS}
    out["dispatch_ms_count"] = pkg.hcount(reg, "serve.router.dispatch_ms")
    return out


def _trace(router, path):
    """The merged fleet trace without its times: each pid's span names
    and details in order, and the pids each request's spans landed on."""
    summary = router.export_fleet_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, pids = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        detail = e.get("args", {}).get("detail")
        spans.setdefault(e["pid"], []).append((e["name"], detail))
        if isinstance(detail, str) and detail.startswith("req="):
            pids.setdefault(detail, set()).add(e["pid"])
    return {"nranks": summary["nranks"], "spans": summary["spans"],
            "by_pid": spans,
            "pids": {k: sorted(v) for k, v in pids.items()}}


def skewed_scenario(pkg, prompts, policy, trace_dir):
    """Replica 0 pre-loaded with 4 requests behind its one slot; fresh
    arrivals go to replica 1 off the live gauges and the rebalancer
    steals replica 0's backlog once replica 1 idles."""
    reg = pkg.MetricsRegistry()
    plane = None
    if policy:
        plane = pkg.PolicyPlane(
            tenants={"slo": pkg.TenantPolicy("slo", weight=4.0),
                     "adv": pkg.TenantPolicy("adv", weight=1.0)},
            registry=reg)
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=reg, clock=FixedClock(), max_queue=8,
                        policy=plane)
    pre = [pkg.Request(id=100 + i, prompt=prompts[i], max_new_tokens=8,
                       tenant="adv") for i in range(4)]
    for r in pre:
        router.schedulers[0].submit(r)
        router.assignments.setdefault(r.id, []).append(0)
    reqs = [pkg.Request(id=i, prompt=prompts[i % len(prompts)],
                        max_new_tokens=6, tenant="slo" if i % 2 else "adv")
            for i in range(4)]
    comps = router.run(reqs)
    out = {
        "ids": sorted(c.id for c in comps),
        "assignments": dict(router.assignments),
        "counters": _router_counters(pkg, reg),
        "statuses": by_id(comps, "status", "retries", "evictions"),
        "usage": {c.id: c.usage.to_dict() for c in comps},
        "ledger_totals": dict(router.ledger.totals),
        "conservation": router.ledger.verify_conservation(
            pre + reqs)["holds"],
        "trace": _trace(router, trace_dir / f"{pkg.name}.json"),
        "decode_compiles": [s.engine.decode_compiles
                            for s in router.schedulers],
        "tokens": tokens_of(comps),
    }
    if plane is not None:
        out["admission_log"] = [(rid, t) for rid, t, _ in
                                plane.admission_log]
    return out


@pytest.fixture(scope="module", params=["fifo", "policy"])
def skewed(request, pkgs, prompts, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"skewed_{request.param}")
    jp, tp = pkgs
    return tuple(skewed_scenario(p, prompts, request.param == "policy", d)
                 for p in (jp, tp))


def test_skewed_dispatch_and_rebalance_match_jax(skewed):
    ref, got = skewed
    keys = ("ids", "assignments", "counters", "statuses",
            "decode_compiles", "tokens", "admission_log")
    assert_same({k: got[k] for k in keys if k in got},
                {k: ref[k] for k in keys if k in ref})
    # Fresh arrivals went to the unloaded replica first, and the
    # rebalancer moved some of replica 0's backlog.
    assert all(got["assignments"][i][0] == 1 for i in range(4))
    assert got["counters"]["serve.router.migrated"] > 0
    assert got["decode_compiles"] == [1, 1]


def test_fleet_trace_matches_jax(skewed):
    ref, got = skewed
    assert got["trace"] == ref["trace"]
    stolen = [rid for rid, reps in got["assignments"].items()
              if len(set(reps)) > 1]
    assert stolen
    for rid in stolen:
        assert got["trace"]["pids"][f"req={rid}"] == [0, 1]


def test_shared_ledger_matches_jax(skewed):
    ref, got = skewed
    assert got["usage"] == ref["usage"]
    assert got["ledger_totals"] == ref["ledger_totals"]
    assert got["conservation"] and ref["conservation"]


def backpressure_scenario(pkg, prompts):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=1) for _ in range(2)],
                        registry=reg, clock=FixedClock(), max_queue=1)
    comps = router.run([pkg.Request(id=i, prompt=prompts[i % 5],
                                    max_new_tokens=4) for i in range(8)])
    return {"ids": [c.id for c in sorted(comps, key=lambda c: c.id)],
            "n": len(comps), "assignments": dict(router.assignments),
            "counters": _router_counters(pkg, reg),
            "tokens": tokens_of(comps)}


def test_backpressure_matches_jax(pkgs, prompts):
    ref, got = (backpressure_scenario(p, prompts) for p in pkgs)
    assert_same(got, ref)
    assert got["n"] == 8 and got["ids"] == list(range(8))
    assert got["counters"]["serve.router.backpressure"] > 0
    assert got["counters"]["serve.router.queue_depth"] == 0
    assert got["counters"]["dispatch_ms_count"] == 8


def spread_scenario(pkg, prompts):
    reg = pkg.MetricsRegistry()
    router = pkg.Router([pkg.engine(capacity=2) for _ in range(2)],
                        registry=reg, clock=FixedClock())
    comps = router.run([pkg.Request(id=i, prompt=prompts[i % 5],
                                    max_new_tokens=4) for i in range(6)])
    stats = [{k: v for k, v in s.items() if k != "engine"}
             for s in router.replica_stats()]
    return {"stats": stats, "assignments": dict(router.assignments),
            "instruments": sorted(
                n for n in reg.snapshot() if n.startswith("serve.router.")),
            "tokens": tokens_of(comps)}


def test_replica_stats_and_metric_family_match_jax(pkgs, prompts):
    ref, got = (spread_scenario(p, prompts) for p in pkgs)
    assert_same(got, ref)
    assert all(s["served"] > 0 for s in got["stats"])
    assert "serve.router.occupancy_spread" in got["instruments"]


def misfit_scenario(pkg):
    """Heterogeneous fleet: the tiny replica's refusal at dispatch is its
    own problem — the request lands on the big one, and the tiny replica
    then serves what it can hold."""
    tiny = pkg.engine(capacity=1, num_blocks=6)
    big = pkg.engine(capacity=1, num_blocks=24)
    router = pkg.Router([tiny, big], registry=pkg.MetricsRegistry(),
                        clock=FixedClock())
    req = pkg.Request(id=0, prompt=[i % 127 + 1 for i in range(40)],
                      max_new_tokens=16)
    [c] = router.run([req])
    comps = router.run([pkg.Request(id=1, prompt=[5, 6, 7],
                                    max_new_tokens=4)])
    return {"assignments": dict(router.assignments),
            "statuses": by_id(comps, "status"),
            "states": [router.health.state(i) for i in range(2)],
            "tokens": tokens_of(comps)}


def test_dispatch_pool_exhausted_matches_jax(pkgs):
    ref, got = (misfit_scenario(p) for p in pkgs)
    assert_same(got, ref)
    assert got["assignments"] == {0: [1], 1: [0]}


def policy_shed_scenario(pkg, prompts):
    """One capacity-1 replica behind a policy plane: a bursty tenant with
    a per-tenant holdback cap of 2 and an SLO tenant; the census of every
    tick and the shed verdicts."""
    reg = pkg.MetricsRegistry()
    plane = pkg.PolicyPlane(
        tenants={"burst": pkg.TenantPolicy("burst", shed_depth=2),
                 "slo": pkg.TenantPolicy("slo", weight=4.0)},
        registry=reg)
    router = pkg.Router([pkg.engine(capacity=1)], registry=reg,
                        clock=FixedClock(), max_queue=1, policy=plane)
    reqs = [pkg.Request(id=i, prompt=prompts[i % 5], max_new_tokens=3,
                        tenant="burst" if i < 6 else "slo")
            for i in range(8)]
    for r in reqs:
        router.submit(r)
    census = []
    while router.pending:
        router.tick()
        census.append({t: pkg.counter(reg, f"serve.tenant.{t}.queue_depth")
                       for t in ("burst", "slo")})
    router.finish()
    comps = router.completions
    return {"statuses": by_id(comps, "status", "reason"),
            "census": census,
            "shed": pkg.counter(reg, "serve.health.shed"),
            "fleet_flag": plane.fleet,
            "admission_log": [(rid, t) for rid, t, _ in plane.admission_log],
            "conservation": router.ledger.verify_conservation(
                reqs)["holds"],
            "tokens": tokens_of(comps)}


def test_policy_census_and_tenant_shed_match_jax(pkgs, prompts):
    ref, got = (policy_shed_scenario(p, prompts) for p in pkgs)
    assert_same(got, ref)
    assert got["shed"] > 0 and got["fleet_flag"] and got["conservation"]
    assert all(st == ("ok", "length") for rid, st in
               got["statuses"].items() if rid >= 6)


def test_tenant_spec_shed_key_matches_jax(monkeypatch):
    from chainermn_tpu.serving.policy import (
        tenant_spec_from_env as jax_spec,
    )
    from chainermn_tpu_torch.serving.policy import tenant_spec_from_env

    monkeypatch.setenv("CMN_SERVE_TENANT_SPEC",
                       "burst:weight=2,shed=3;slo:priority=1,deadline_ms=50")
    got, want = tenant_spec_from_env(), jax_spec()
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in want.items()}
    assert got["burst"].shed_depth == 3


def test_router_rejects_misfits_and_bad_roles(pkgs):
    _, tp = pkgs
    router = tp.Router([tp.engine(capacity=1)])
    with pytest.raises(tp.PoolExhausted):
        router.submit(tp.Request(id=0, prompt=[1] * 400,
                                 max_new_tokens=400))
    with pytest.raises(ValueError):
        tp.Router([])
    with pytest.raises(ValueError, match="decode-role"):
        tp.Router([tp.engine(), tp.engine()], roles=["decode", "decode"])
    with pytest.raises(ValueError, match="unknown role"):
        tp.Router([tp.engine()], roles=["speculate"])


def test_scheduler_tick_loop_matches_run(pkgs, prompts):
    """``run()`` is a ``tick()`` loop: driving one port scheduler tick by
    tick, as the router does, gives ``run()``'s tokens."""
    _, tp = pkgs
    reqs = [tp.Request(id=i, prompt=prompts[i], max_new_tokens=5)
            for i in range(3)]
    want = tokens_of(tp.Scheduler(tp.engine(), clock=FixedClock()).run(
        reqs))
    sched = tp.Scheduler(tp.engine(), clock=FixedClock())
    for r in reqs:
        sched.submit(r)
    while sched.pending:
        assert sched.tick()
    sched.finish()
    assert tokens_of(sched.completions) == want
    assert not sched.pending and sched.queue_depth == 0
