"""The port's observability planes against the JAX package's, host side:
the same inputs through both modules, on explicit registries and
managers (no process singleton is touched).

* SLO reports equal on the same fed latency sequences;
* the Chrome trace of one lifecycle-event list equal, track for track;
* incident rules firing once, deduplicated, on the same snapshots, and
  the port's bundle round-tripping through its report CLI;
* the ledger's integer books and its usage report equal;
* the policy plane's weighted-fair picks equal the JAX plane's and an
  independent VTC oracle's (the one of
  ``tests/serving_tests/test_serve_policy.py``);
* the capture watch's blame diff equal to the JAX ``signature_diff`` and
  its budget gauge;
* the strict-JSON sanitizer and the Prometheus rendering equal;
* ``IncidentManager.add_rule`` and ``MetricsRegistry.reset`` equal on
  the same sequence of calls;
* a ``PlaneTape``'s record of one replica tick, replayed, equal to the
  same calls made directly on the port's and the JAX plane.
"""

import json
import math

import numpy as np
import pytest

import chainermn_tpu.observability.aggregate as jagg
import chainermn_tpu.observability.device as jdev
import chainermn_tpu.observability.incident as jinc
import chainermn_tpu.observability.ledger as jled
import chainermn_tpu.observability.metrics as jmet
import chainermn_tpu.observability.slo as jslo
import chainermn_tpu.observability.tracing as jtr
import chainermn_tpu.observability.usage as jusage
import chainermn_tpu.serving.policy as jpol
from chainermn_tpu_torch.observability import aggregate as tagg
from chainermn_tpu_torch.observability import device as tdev
from chainermn_tpu_torch.observability import incident as tinc
from chainermn_tpu_torch.observability import ledger as tled
from chainermn_tpu_torch.observability import metrics as tmet
from chainermn_tpu_torch.observability import slo as tslo
from chainermn_tpu_torch.observability import tracing as ttr
from chainermn_tpu_torch.observability import usage as tusage
from chainermn_tpu_torch.serving import policy as tpol
from chainermn_tpu_torch.serving.scheduler import Request

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1


# ------------------------------------------------------------------- SLO
@pytest.mark.parametrize("targets", [None, {"token": 5.0}],
                         ids=["calibrated", "absolute"])
def test_slo_reports_equal_on_same_sequences(targets):
    rng = np.random.RandomState(3)
    kw = dict(window=32, min_samples=8, tolerance=0.5, check_every=4,
              targets=targets)
    jm = jslo.SLOMonitor(registry=jmet.MetricsRegistry(), **kw)
    tm = tslo.SLOMonitor(registry=tmet.MetricsRegistry(), **kw)
    # A steady phase, then a 3x drift on the token stream.
    for i in range(80):
        vals = {"ttft": 40 + 10 * rng.rand(), "queue_wait": 5 * rng.rand(),
                "token": (4 + rng.rand()) * (3.0 if i >= 50 else 1.0)}
        for s, v in vals.items():
            jm.observe(s, v)
            tm.observe(s, v)
        if i % 4 == 3:
            assert tm.check() == jm.check()
    assert tm.last_report["token"]["breached"]
    snap_t = tm._c_breach["token"].value
    assert snap_t == jm._c_breach["token"].value > 0
    assert tslo.rolling_quantile([3.0, 1.0, 2.0], 0.95) == \
        jslo.rolling_quantile([3.0, 1.0, 2.0], 0.95)


# ----------------------------------------------------------------- trace
def _events(mod):
    E = mod.LifecycleEvent
    return [
        E("submit", 0.0, req=0), E("submit", 0.0, req=1),
        E("admit", 0.01, req=0, slot=0),
        E("prefill", 0.011, req=0, slot=0, dur_ms=2.0,
          info={"p0": 0, "end": 16, "final": False}),
        E("admit", 0.012, req=1, slot=1, info={"prefix_tokens": 8}),
        E("prefill", 0.013, req=0, slot=0, dur_ms=1.5,
          info={"p0": 16, "end": 20, "final": True}),
        E("prefill", 0.015, req=1, slot=1, dur_ms=1.0,
          info={"p0": 8, "end": 12, "final": True}),
        E("decode", 0.02, dur_ms=3.0,
          info={"reqs": [(0, 0), (1, 1)], "mixed": True}),
        E("evict", 0.025, req=1, slot=1, info={"carried": 2}),
        E("decode", 0.026, dur_ms=3.0,
          info={"reqs": [(0, 0)], "mixed": False}),
        E("retire", 0.03, req=0, slot=0,
          info={"reason": "length", "tokens": 3}),
        E("admit", 0.031, req=1, slot=0, info={"readmit": True}),
    ]


def test_chrome_trace_equal_and_loads(tmp_path):
    want = jtr.chrome_trace_events(_events(jtr), rank=2)
    got = ttr.chrome_trace_events(_events(ttr), rank=2)
    assert got == want
    path = ttr.write_chrome_trace(str(tmp_path / "t.json"), _events(ttr))
    with open(path) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"queue req 1", "req 0", "prefill", "decode", "evict"} <= names


def test_timeline_ring_mirror_and_span_window():
    ring = ttr.SpanRing(8)
    tl = ttr.RequestTimeline(capacity=4, ring=ring)
    for e in _events(ttr):
        tl.record(e.kind, t=e.t, req=e.req, slot=e.slot, dur_ms=e.dur_ms,
                  info=e.info)
    assert len(tl) == 4 and tl.dropped == len(_events(ttr)) - 4
    spans = ring.snapshot()
    assert [s["op"] for s in spans][-2:] == ["serve.retire", "serve.admit"]
    ev = ttr.chrome_span_events(spans, rank=1)
    assert ev[0]["ph"] == "M" and all(e["pid"] == 1 for e in ev)
    assert [e["name"] for e in ev[1:]] == [s["op"] for s in spans]
    assert min(e["ts"] for e in ev[1:]) == 0.0


# -------------------------------------------------------------- incident
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _drive_rules(mod, reg, directory):
    clock = _Clock()
    mgr = mod.IncidentManager(registry=reg, directory=directory,
                              cooldown_s=10.0, time_fn=clock)
    filed = []
    seq = [("serve.slo.p95_drift", 0.2), ("serve.slo.p95_drift", 0.8),
           ("serve.slo.p95_drift", 0.9), ("serve.slo.p95_drift", 0.1),
           ("serve.slo.p95_drift", 0.7), ("mem.kv.leaked_blocks", 0.0),
           ("mem.kv.leaked_blocks", 3.0), ("compile.budget_exceeded", 1.0),
           ("serve.policy.starved_tenant", 1.0),
           ("serve.policy.starved_tenant", 1.0),
           ("serve.policy.starved_tenant", 1.0)]
    for name, v in seq:
        reg.gauge(name).set(v)
        clock.t += 20.0
        filed += [m["rule"]["name"] for m in mgr.evaluate()]
    return mgr, filed


def test_incident_rules_fire_once_deduplicated(tmp_path):
    jm, jfiled = _drive_rules(jinc, jmet.MetricsRegistry(), None)
    tm, tfiled = _drive_rules(tinc, tmet.MetricsRegistry(),
                              str(tmp_path / "incidents"))
    assert tfiled == jfiled
    # The drift rule fired once: the re-breach after clearing is a dedupe.
    assert tfiled.count("slo_p95_drift") == 1
    assert set(tfiled) == {"slo_p95_drift", "kv_leak", "compile_budget",
                           "tenant_starvation"}
    assert (tm.count, tm.dropped) == (jm.count, jm.dropped)
    assert [r.name for r in tinc.default_rules()] == \
        [r.name for r in jinc.default_rules()]
    report = tinc.load_report(str(tmp_path / "incidents"))
    man = report["manifest"]
    assert man["schema"] == jinc.INCIDENT_SCHEMA
    assert man["clock"] is None
    arts = report["artifacts"]
    assert {"flight", "metrics", "trace", "signals"} <= set(arts)
    assert all(a["present"] and a.get("parses", True)
               for a in arts.values())
    assert tinc.main(["report", str(tmp_path / "incidents"), "--json"]) == 0


def test_incident_add_rule_equal():
    """``IncidentManager.add_rule``: a rule added mid-run starts with a
    fresh streak (it fires at its second breaching evaluation, not at
    once), as the JAX manager's."""
    jreg, treg = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    got = {}
    for name, mod, reg in (("jax", jinc, jreg), ("port", tinc, treg)):
        clock = _Clock()
        mgr = mod.IncidentManager(registry=reg, rules=[], cooldown_s=10.0,
                                  time_fn=clock)
        fired = []
        for i, v in enumerate((9.0, 9.0, 9.0, 9.0, 0.0)):
            if i == 2:
                mgr.add_rule(mod.Watch(name="deep_queue",
                                       metric="serve.router.queue_depth",
                                       predicate="> 4", hysteresis=2))
            reg.gauge("serve.router.queue_depth").set(v)
            clock.t += 20.0
            fired.append([m["rule"]["name"] for m in mgr.evaluate()])
        got[name] = (fired, [r.name for r in mgr.rules], mgr.count)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [[], [], [], ["deep_queue"], []]


def test_metrics_registry_reset_equal():
    """``MetricsRegistry.reset`` drops every instrument and sample: the
    same calls before and after it leave the port's registry as the
    JAX registry."""
    out = {}
    for name, mod in (("jax", jmet), ("port", tmet)):
        reg = mod.MetricsRegistry()
        reg.counter("a").inc(3)
        reg.gauge("b").set(2.0)
        reg.histogram("c").observe(1.5)
        reg.sample(1)
        before = (reg.snapshot(), len(reg.last_samples()))
        reg.reset()
        after = (reg.snapshot(), reg.last_samples(), reg.peek("a"))
        reg.counter("a").inc()
        reg.sample(2)
        out[name] = (before, after, reg.snapshot(),
                     [s["step"] for s in reg.last_samples()])
    assert out["port"] == out["jax"]
    assert out["port"][1] == ({}, [], None)


# ---------------------------------------------------------------- ledger
class _Req:
    def __init__(self, id, tenant, arrival=0.0):
        self.id, self.tenant, self.arrival = id, tenant, arrival


def _book(mod):
    led = mod.CostLedger(registry=None, top_k=2)
    reqs = [_Req(i, t, 0.001 * i) for i, t in
            enumerate(["a", "b", "a", "c", "b"])]
    for r in reqs:
        led.begin(r, r.arrival)
    for step, r in enumerate(reqs):
        led.admitted(r.id, 0.01 + 0.002 * step)
        led.set_blocks(r.id, 2 + step, 0.01 + 0.002 * step)
        led.book(r.id, "prefill_tokens", 16 + step)
        led.book(r.id, "prefix_hit_tokens", 8 * (step % 2))
        for _ in range(3 + step):
            led.book(r.id, "decode_iterations", 1)
            led.book(r.id, "tokens", 1)
        if step == 2:
            led.set_blocks(r.id, 0, 0.05)
            led.book(r.id, "evictions", 1)
            led.set_blocks(r.id, 4, 0.06)
    for step, r in enumerate(reqs):
        led.finalize(r.id, "ok" if step != 3 else "deadline",
                     0.1 + 0.01 * step)
    return led, reqs


def test_ledger_books_and_usage_report_equal(tmp_path):
    jl, jreqs = _book(jled)
    tl, treqs = _book(tled)
    assert tl.totals == jl.totals
    assert tl.aggregate() == jl.aggregate()
    assert tl.top() == jl.top()
    assert [r.to_dict() for r in tl.records] == \
        [r.to_dict() for r in jl.records]
    cons = tl.verify_conservation(treqs)
    assert cons["holds"] and cons == jl.verify_conservation(jreqs)
    tpath = tl.dump(str(tmp_path / "usage.json"))
    got = tusage.load_report(tpath)
    want = jusage.load_report(tpath)
    assert got == want
    assert tusage.main(["report", tpath]) == 0
    assert tusage.main(["report", str(tmp_path / "missing.json")]) == 2


# ---------------------------------------------------------------- policy
def _plane(mod, reg_mod, **kw):
    return mod.PolicyPlane(
        tenants=[mod.TenantPolicy("a", weight=1.0),
                 mod.TenantPolicy("b", weight=3.0),
                 mod.TenantPolicy("slo", weight=4.0, priority=1)],
        registry=reg_mod.MetricsRegistry(), **kw)


def test_vtc_picks_equal_jax_plane_and_oracle():
    jp, tp = _plane(jpol, jmet), _plane(tpol, tmet)
    queue = []
    for i in range(40):
        for t in ("a", "b"):
            queue.append(Request(id=len(queue), prompt=[1], max_new_tokens=1,
                                 tenant=t))
    # An idle tenant joining mid-run is lifted to the busiest floor.
    late = Request(id=999, prompt=[1], max_new_tokens=1, tenant="slo")
    jq, tq = list(queue), list(queue)
    vt = {"a": 0.0, "b": 0.0}
    weights = {"a": 1.0, "b": 3.0}
    served = {"a": 0, "b": 0, "slo": 0}
    for step in range(40):
        if step == 20:
            jq.insert(0, late)
            tq.insert(0, late)
        ji, ti = jp.pick_index(jq, now=0.0), tp.pick_index(tq, now=0.0)
        assert ti == ji
        picked = tq[ti].tenant
        if picked != "slo":
            assert picked == min(vt, key=lambda t: (vt[t], ["a", "b"]
                                                    .index(t)))
            vt[picked] += 10.0 / weights[picked]
        served[picked] += 1
        for plane, q in ((jp, jq), (tp, tq)):
            plane.charge(q.pop(ti).tenant, "prefill_tokens", 10.0)
    assert tp.state() == jp.state()
    assert served["slo"] == 1 and served["b"] > 2 * served["a"]


def test_policy_latch_preempt_and_throttle_equal():
    jp = _plane(jpol, jmet, drift_hysteresis=2, prefill_cap=16)
    tp = _plane(tpol, tmet, drift_hysteresis=2, prefill_cap=16)
    reports = [{"token": {"breached": True}}] * 2 + \
        [{"token": {"breached": False}}] * 2
    for rep in reports:
        jp.on_slo_check(rep)
        tp.on_slo_check(rep)
        assert tp.prefill_budget() == jp.prefill_budget()

    class _Slot:
        def __init__(self, tenant, seq, prio=0):
            self.entry = type("E", (), {})()
            self.entry.req = Request(id=seq, prompt=[1], max_new_tokens=1,
                                     tenant=tenant, priority=prio)
            self.admit_seq = seq

    slots = [_Slot("a", 0), _Slot("b", 1), _Slot("a", 2), _Slot("slo", 3)]
    for plane in (jp, tp):
        v = plane.preempt_pick(slots, 1)
        assert v is slots[2]
        assert plane.preempt_pick(slots, 0) is None
    rated = [tpol.TenantPolicy("r", rate_limit=10.0)]
    jr = jpol.PolicyPlane(tenants=[jpol.TenantPolicy("r", rate_limit=10.0)],
                          registry=jmet.MetricsRegistry())
    tr = tpol.PolicyPlane(tenants=rated, registry=tmet.MetricsRegistry())
    q = [Request(id=0, prompt=[1], max_new_tokens=1, tenant="r")]
    for plane in (jr, tr):
        assert plane.pick_index(q, now=0.0) == 0
        plane.charge("r", "prefill_tokens", 50)
        assert plane.pick_index(q, now=1.0) is None
    assert tr.next_release(q, 1.0) == jr.next_release(q, 1.0) == 5.0


def _replica_calls(plane):
    """One replica tick's calls on its plane, as a scheduler makes them:
    picks, admissions, charges, block levels, a queue wait, an SLO
    verdict, a preemption pick, a deadline and a release bound."""
    q = [Request(id=i, prompt=[1], max_new_tokens=1, tenant=t)
         for i, t in enumerate("abab")]

    class _Slot:
        def __init__(self, req, seq):
            self.entry = type("E", (), {"req": req})()
            self.admit_seq = seq

    plane.pick_index(q, 0.0)
    plane.note_admission(q[0])
    plane.charge("a", "prefill_tokens", 8)
    plane.set_blocks(0, "a", 2, 0.001)
    plane.note_queue_wait("a", 3.0)
    plane.on_slo_check({"token": {"breached": True}})
    plane.charge("b", "decode_iterations", 2)
    plane.pick_index(q[1:], 0.002)
    plane.note_admission(q[1])
    plane.preempt_pick([_Slot(q[0], 0), _Slot(q[1], 1)],
                       plane.effective_priority(q[2]))
    plane.set_blocks(0, "a", 0, 0.003)
    plane.deadline_ms("c")
    plane.next_release(q, 0.004)


def test_plane_tape_replay_equals_direct_calls():
    """A ``PlaneTape`` runs a replica tick's calls against a fork of the
    plane (the plane itself untouched) and records them; the record,
    pickled as the router's gather sends it, replayed on the plane gives
    the state and admission log that the same calls made directly give,
    on the port's plane and on the JAX plane."""
    import pickle

    def make(mod, reg_mod):
        return _plane(mod, reg_mod, drift_hysteresis=1, block_cost_us=0.5)

    direct, jdirect = make(tpol, tmet), make(jpol, jmet)
    _replica_calls(direct)
    _replica_calls(jdirect)
    plane = make(tpol, tmet)
    before = plane.state()
    tape = tpol.PlaneTape(plane)
    tape.begin()
    _replica_calls(tape)
    ops = tape.end()
    assert plane.state() == before and plane.admission_log == []
    plane.replay(pickle.loads(pickle.dumps(ops)))
    assert plane.state() == direct.state() == jdirect.state()
    assert plane.admission_log == direct.admission_log == \
        jdirect.admission_log
    assert plane.prefill_cap_active and plane._m_cap_active.value == 1.0


def test_tenant_spec_env_parse_equal(monkeypatch):
    monkeypatch.setenv("CMN_SERVE_TENANT_SPEC",
                       "slo:weight=4,priority=1,deadline_ms=500;"
                       "batch:weight=1,rate=200,quota=3;bad")
    j, t = jpol.tenant_spec_from_env(), tpol.tenant_spec_from_env()
    assert all(v.shed_depth is None for v in t.values())
    assert {k: vars(v) for k, v in t.items()} == \
        {k: vars(v) for k, v in j.items()}


def test_tenant_spec_refuses_shed_without_router(monkeypatch):
    # The port has the router now: ``shed`` (its per-tenant holdback
    # depth) parses as the JAX package's does, and a plane built from
    # the spec answers the router's ``shed_depth`` query alike.
    monkeypatch.setenv("CMN_SERVE_TENANT_SPEC",
                       "slo:weight=4;batch:weight=1,shed=2")
    assert jpol.tenant_spec_from_env()["batch"].shed_depth == 2
    assert tpol.tenant_spec_from_env()["batch"].shed_depth == 2
    jp = jpol.PolicyPlane(registry=jmet.MetricsRegistry())
    tp = tpol.PolicyPlane(registry=tmet.MetricsRegistry())
    for plane in (jp, tp):
        assert plane.shed_depth("batch") == 2
        assert plane.shed_depth("slo") is None
        assert plane.fleet is False
    assert tpol.TenantPolicy("t").shed_depth is None


# ---------------------------------------------------------- capture watch
def test_capture_watch_blame_and_budget_gauge():
    reg = tmet.MetricsRegistry()
    w = tdev.CompileWatch(registry=reg)
    wp = w.register("decode_step", budget=1)
    assert reg.snapshot()["compile.budget_exceeded"]["value"] == 0
    S, M = 4, 16
    a = {"tokens": np.zeros(S, np.int32), "pos": np.zeros(S, np.int32),
         "tables": np.zeros((S, M), np.int32), "active": np.zeros(S, bool),
         "model": "m"}
    b = {**a, "tables": np.zeros((S, M + 1), np.int32)}
    w.record(wp, "k1", a, 0.5, "capture")
    assert not wp.over_budget and not w.blames()
    w.record(wp, "k2", b, 0.25, "capture")
    assert wp.compiles == 2 and wp.over_budget
    assert reg.snapshot()["compile.budget_exceeded"]["value"] == 1
    blame = w.blames()[-1]
    want = jdev.signature_diff(
        {k: jdev._leaf_signature(v) for k, v in a.items()},
        {k: jdev._leaf_signature(v) for k, v in b.items()})
    assert blame["diff"] == want
    assert blame["diff"] == [{"arg": "tables",
                              "before": {"shape": [S, M],
                                         "dtype": "int32"},
                              "after": {"shape": [S, M + 1],
                                        "dtype": "int32"},
                              "axes": [1]}]
    assert blame["budget_exceeded"] is True
    sec = w.flight_section()
    assert sec["budget_violations"] == 1
    assert sec["programs"][0]["compiles"] == 2


def test_roofline_and_mfu():
    cost = {"flops": 2e9, "bytes accessed": 4e8,
            "kv_bytes_per_position": 1e3,
            "attention_flops_per_position": 1e4}
    r = tdev.roofline(cost, 1e-3, kv_positions=1000.0,
                      device_kind="NVIDIA H100 80GB HBM3")
    assert r["tflops_per_device"] == pytest.approx(2.01e9 / 1e-3 / 1e12)
    assert r["mfu_pct"] == pytest.approx(100 * 2.01e9 / 1e-3 / 989e12)
    assert r["arithmetic_intensity"] == pytest.approx(2.01e9 / 4.01e8)
    assert tdev.mfu_pct(1e9, 1e-3, device_kind="cpu") is None
    assert tdev.attention_core_flops(2, 8, 1, 64, kv_len=100,
                                     n_backward=0) == \
        jdev.attention_core_flops(2, 8, 1, 64, kv_len=100, n_backward=0)


# ------------------------------------------------------- json/prometheus
def test_sanitize_and_prometheus_equal():
    obj = {"a": [1.0, math.nan, {"b": math.inf}], "c": (2, -math.inf)}
    assert tagg.sanitize_json(obj) == jagg.sanitize_json(obj)
    for mod, agg in ((tmet, tagg), (jmet, jagg)):
        reg = mod.MetricsRegistry()
        reg.counter("serve.tokens").inc(7)
        reg.gauge("serve.queue_depth").set(math.nan)
        h = reg.histogram("serve.decode_ms")
        for v in (0.3, 4.0, 12.0, 40000.0):
            h.observe(v)
        if mod is tmet:
            got = agg.render_prometheus(reg.snapshot())
        else:
            want = agg.render_prometheus(reg.snapshot())
    assert got == want and "cmn_serve_decode_ms_bucket" in got
