"""The port's serving planes against the JAX package's, through the
Scheduler, on the serving test geometry of ``test_torch_serving.py``
(vocab 257, 2 layers, d_model 64, capacity 4, fp32, Flax parameters
carried across with ``params_from_flax``).

One JAX engine is built per module and serves every JAX run.  Both
schedulers run on a fixed clock (``now() == 0``), so every decision and
every integer the ledger books is deterministic; no test reads a
wall-clock latency.  Held against the JAX run:

* the per-request lifecycle event kinds and their order, the Chrome
  trace's track and slice structure;
* the ledger's records, every dimension, and its conservation;
* the SLO streams' sample counts;
* the policy plane's admission order and preemptions;
* prefix quotas recycling only the quota tenant's own leaves.

And on the port alone: ``CMN_OBS=0`` building no plane, the default
planes and the flight record (``serving``/``memory`` sections, a
dropped scheduler released), the capture watch's blame and budget gauge
under slot churn, the device roofline feed, and the drift incident
filed once (against an SLO target no step can meet) with its unfaulted
twin filing none.
"""

import gc
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from chainermn_tpu.observability.tracing import RequestTimeline as JaxTimeline
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu.serving import PolicyPlane as JaxPlane
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import TenantPolicy as JaxTenant
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.observability import device as odev
from chainermn_tpu_torch.observability import flight as oflight
from chainermn_tpu_torch.observability.incident import IncidentManager
from chainermn_tpu_torch.observability.metrics import MetricsRegistry
from chainermn_tpu_torch.observability.slo import SLOMonitor
from chainermn_tpu_torch.observability.tracing import (
    RequestTimeline,
    chrome_trace_events,
)
from chainermn_tpu_torch.serving import (
    DecodeEngine,
    PolicyPlane,
    Request,
    Scheduler,
    TenantPolicy,
)
from chainermn_tpu_torch.utils import params_from_flax

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

KW = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope")
ENG = dict(capacity=4, num_blocks=40, block_len=8, prefill_chunk=16)
SHAPES = [(5, 7), (20, 12), (33, 3), (9, 20), (14, 6), (26, 9)]
TENANTS = ["acme", "bluesky", "acme", "carol", "bluesky", "acme"]


class FixedClock:
    """A scheduler clock that never moves: every decision and every
    integer the ledger books is independent of the host's speed."""

    def now(self):
        return 0.0

    def skip_to(self, t):
        pass


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**KW, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(**KW, dtype=torch.float32, decode_attention="fused",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def jax_engine(models):
    jm, params, _ = models
    return JaxEngine(jm, params, **ENG)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [(rng.randint(1, 257, size=n).tolist(), m) for n, m in SHAPES]


def _engine(tm, **over):
    return DecodeEngine(tm, **{**ENG, **over}, device="cpu")


def _reqs(cls, prompts, **kw):
    return [cls(id=i, prompt=p, max_new_tokens=m, tenant=TENANTS[i], **kw)
            for i, (p, m) in enumerate(prompts)]


def _by_req(events):
    out = {}
    for e in events:
        if e.req is not None:
            out.setdefault(e.req, []).append(e.kind)
        for _, rid in (e.info or {}).get("reqs", ()):
            out.setdefault(rid, []).append(e.kind)
    return out


def _structure(chrome):
    """The trace's tracks and slices without their times."""
    return [(e["name"], e.get("cat"), e["ph"], e.get("tid"),
             (e.get("args") or {}).get("req")) for e in chrome]


@pytest.fixture(scope="module")
def both_runs(models, jax_engine, prompts):
    """The same requests through the JAX and the port scheduler, planes
    on (explicit registries: no process singleton)."""
    _, _, tm = models
    jax_engine.drop_prefix_cache()
    jt = JaxTimeline()
    js = JaxScheduler(jax_engine, registry=JaxRegistry(), clock=FixedClock(),
                      timeline=jt)
    jc = {c.id: c for c in js.run(_reqs(JaxRequest, prompts))}
    jax_engine.drop_prefix_cache()
    eng = _engine(tm)
    reg = MetricsRegistry()
    tt = RequestTimeline()
    ts = Scheduler(eng, registry=reg, clock=FixedClock(), timeline=tt)
    tc = {c.id: c for c in ts.run(_reqs(Request, prompts))}
    return (js, jc, jt), (ts, tc, tt, eng, reg)


def test_tokens_and_lifecycle_match_jax(both_runs):
    (js, jc, jt), (ts, tc, tt, eng, _) = both_runs
    for i in jc:
        assert tc[i].tokens == jc[i].tokens, f"request {i}"
        assert tc[i].evictions == jc[i].evictions
    got, want = _by_req(tt.events()), _by_req(jt.events())
    assert got == want
    for kinds in got.values():
        assert kinds[0] == "submit" and kinds[-1] == "retire"
    assert eng.decode_compiles == 1


def test_chrome_trace_structure_matches_jax(both_runs, tmp_path):
    (_, _, jt), (ts, _, tt, _, _) = both_runs
    from chainermn_tpu.observability.tracing import (
        chrome_trace_events as jax_chrome,
    )

    assert _structure(chrome_trace_events(tt.events())) == \
        _structure(jax_chrome(jt.events()))
    path = ts.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["name"] == "thread_name"}
    assert "queue" in tracks and "slot 0" in tracks


def test_ledger_records_match_jax_and_conserve(both_runs, prompts):
    (js, jc, _), (ts, tc, _, _, reg) = both_runs
    for i in jc:
        assert tc[i].usage.to_dict() == jc[i].usage.to_dict(), f"req {i}"
        assert tc[i].usage.tokens == len(tc[i].tokens)
    cons = ts.ledger.verify_conservation(_reqs(Request, prompts))
    assert cons["holds"], cons
    agg = ts.ledger.aggregate()
    for dim, total in ts.ledger.totals.items():
        assert sum(t[dim] for t in agg.values()) == total
    assert ts.ledger.totals == js.ledger.totals
    snap = reg.snapshot()
    assert snap["serve.tenant.acme.tokens"]["value"] == \
        sum(len(tc[i].tokens) for i in tc if TENANTS[i] == "acme")


def test_slo_streams_match_jax(both_runs):
    (js, _, _), (ts, _, _, _, _) = both_runs
    got, want = ts.slo.last_report, js.slo.last_report
    assert set(got) == {"ttft", "queue_wait", "token"}
    assert {s: r["n"] for s, r in got.items()} == \
        {s: r["n"] for s, r in want.items()}


def _policy_run(sched_cls, req_cls, plane, eng, prompts):
    reqs = _reqs(req_cls, prompts)
    for r in reqs:
        if r.tenant == "carol":
            r.priority = 1
    comps = {c.id: c for c in sched_cls(
        eng, registry=plane._reg, clock=FixedClock(), policy=plane,
    ).run(reqs)}
    return comps


def test_policy_admission_order_matches_jax(models, jax_engine, prompts):
    _, _, tm = models

    def tenants(mod_tenant):
        return [mod_tenant("acme", weight=1.0),
                mod_tenant("bluesky", weight=3.0),
                mod_tenant("carol", weight=1.0)]

    jax_engine.drop_prefix_cache()
    jp = JaxPlane(tenants=tenants(JaxTenant), registry=JaxRegistry())
    jc = _policy_run(JaxScheduler, JaxRequest, jp, jax_engine, prompts)
    jax_engine.drop_prefix_cache()
    tp = PolicyPlane(tenants=tenants(TenantPolicy),
                     registry=MetricsRegistry())
    eng = _engine(tm, capacity=2)
    tp2 = PolicyPlane(tenants=tenants(TenantPolicy),
                      registry=MetricsRegistry())
    tc = _policy_run(Scheduler, Request, tp, _engine(tm), prompts)
    assert [(i, t) for i, t, _ in tp.admission_log] == \
        [(i, t) for i, t, _ in jp.admission_log]
    assert tp.state() == jp.state()
    for i in jc:
        assert tc[i].tokens == jc[i].tokens and tc[i].status == "ok"
    # Capacity 2: the priority tenant preempts a running slot through the
    # recompute path, and the preempted request still completes.
    comps = _policy_run(Scheduler, Request, tp2, eng, prompts)
    assert tp2.preemptions >= 1
    assert sum(c.evictions for c in comps.values()) >= tp2.preemptions
    assert all(c.status == "ok" for c in comps.values())
    assert eng.decode_compiles == 1


def test_prefix_quota_recycles_own_leaves(models, jax_engine):
    """Tenant "q" may pin 2 trie blocks; "free" has no quota.  After both
    serve long prompts, "q" holds at most 2 and "free" keeps every block
    it cached — exactly as in the JAX engine."""
    _, _, tm = models
    rng = np.random.RandomState(5)
    plan = [("free", rng.randint(1, 257, size=40).tolist())] + [
        ("q", rng.randint(1, 257, size=40).tolist()) for _ in range(3)]

    def run(sched_cls, req_cls, plane_cls, tenant_cls, reg_cls, eng):
        plane = plane_cls(tenants=[tenant_cls("q", prefix_quota=2)],
                          registry=reg_cls())
        sched = sched_cls(eng, registry=reg_cls(), clock=FixedClock(),
                          policy=plane)
        sched.run([req_cls(id=i, prompt=p, max_new_tokens=2, tenant=t)
                   for i, (t, p) in enumerate(plan)])
        return dict(eng.prefix._owner_count)

    jax_engine.drop_prefix_cache()
    want = run(JaxScheduler, JaxRequest, JaxPlane, JaxTenant, JaxRegistry,
               jax_engine)
    jax_engine.drop_prefix_cache()
    jax_engine.prefix.quotas = {}
    eng = _engine(tm)
    got = run(Scheduler, Request, PolicyPlane, TenantPolicy,
              MetricsRegistry, eng)
    assert got == want
    assert got["q"] <= 2 and got["free"] == 40 // 8


def test_obs_off_builds_no_plane(models, monkeypatch, tmp_path):
    _, _, tm = models
    monkeypatch.setenv("CMN_OBS", "0")
    eng = _engine(tm)
    sched = Scheduler(eng)
    for plane in ("slo", "timeline", "memory", "incidents", "ledger"):
        assert getattr(sched, plane) is None, plane
    assert sched._dev_enabled is False
    comps = sched.run([Request(id=0, prompt=[3, 4, 5], max_new_tokens=4)])
    assert comps[0].usage is None and len(comps[0].tokens) == 4
    assert sched.export_trace(str(tmp_path / "t.json")) is None
    assert eng.decode_compiles == 1
    assert not eng._step.watched


def test_default_planes_and_flight_record(models, tmp_path):
    _, _, tm = models
    eng = _engine(tm)
    sched = Scheduler(eng)
    for plane in ("slo", "timeline", "memory", "incidents", "ledger"):
        assert getattr(sched, plane) is not None, plane
    sched.run([Request(id=i, prompt=[7 + i] * (5 + i), max_new_tokens=6)
               for i in range(3)])
    rec = oflight.FlightRecorder(str(tmp_path), rank=0)
    path = rec.record("sigusr1")
    with open(path) as f:
        entry = json.loads(f.readlines()[-1])
    res = entry["resilience"]
    assert res["serving"]["completions"] == 3
    assert res["serving"]["engine"]["decode_compiles"] == 1
    assert res["memory"]["device"]["source"] == "host_rss"
    assert res["memory"]["kv"]["used_blocks"] == eng.pool.allocator.used_blocks
    assert res["usage"]["requests"] == 3
    assert any(p["program"] == "decode_step" for p in
               res["compile"]["programs"])
    assert any(s["op"] == "serve.decode" for s in entry["spans"])
    assert sched.memory.check_drained(eng) == 0
    del sched
    gc.collect()
    rec.record("sigusr1")
    with open(path) as f:
        entry = json.loads(f.readlines()[-1])
    assert entry["resilience"]["serving"] == {"released": True}


def test_capture_watch_blame_and_budget_under_churn(models, prompts,
                                                    monkeypatch):
    _, _, tm = models
    reg = MetricsRegistry()
    monkeypatch.setattr(odev, "_watch", odev.CompileWatch(registry=reg))
    # 14 blocks for 4 slots: the churn evicts and re-admits.
    eng = _engine(tm, num_blocks=14)
    comps = Scheduler(eng, registry=MetricsRegistry()).run(
        _reqs(Request, prompts))
    assert sum(c.evictions for c in comps) > 0
    assert eng.decode_compiles == 1 and eng.cow_compiles <= 1
    assert reg.snapshot()["compile.budget_exceeded"]["value"] == 0
    assert "compile_over_budget" not in eng.stats()
    S, M = eng.capacity, eng.max_blocks
    z = np.zeros(S, np.int32)
    eng.step(z, z, np.zeros((S, M + 1), np.int32), np.zeros(S, bool))
    assert eng.decode_compiles == 2
    assert reg.snapshot()["compile.budget_exceeded"]["value"] == 1
    blame = [r for r in odev.watch().blames()
             if r["program"] == "decode_step"][-1]
    changed = [c for c in blame["diff"] if c.get("axes") == [1]]
    assert [c["arg"] for c in changed] == ["tables"]
    assert changed[0]["before"]["shape"] == [S, M]
    assert changed[0]["after"]["shape"] == [S, M + 1]
    assert eng.stats()["compile_over_budget"] == ["decode_step"]


def test_device_roofline_feed(models, monkeypatch):
    _, _, tm = models
    monkeypatch.setattr(odev, "_watch", odev.CompileWatch(
        registry=MetricsRegistry()))
    eng = _engine(tm)
    reg = MetricsRegistry()
    sched = Scheduler(eng, registry=reg,
                      slo=SLOMonitor(registry=reg, check_every=4))
    sched.run([Request(id=0, prompt=[1, 2, 3], max_new_tokens=11)])
    snap = reg.snapshot()
    assert snap["device.decode_step.tflops"]["value"] > 0
    assert snap["device.decode_step.ai"]["value"] > 0
    assert "device.decode_step.mfu_pct" not in snap  # no CPU peak
    cost = eng.hot_program.cost_analysis(capture=False)
    assert cost["flops"] > 0 and cost["kv_bytes_per_position"] == \
        2 * KW["n_layers"] * 64 * 4  # k + v, KH x Dh fp32 per layer


@pytest.mark.parametrize("target_ms,filed", [(1e-6, 1), (1e6, 0)],
                         ids=["unmeetable", "unfaulted"])
def test_drift_incident_filed_once(models, tmp_path, target_ms, filed):
    """Against an SLO target of 1 ns every clean step breaches; against
    1000 s none can.  The drift rule files once (deduplicated over every
    later check) or never."""
    _, _, tm = models
    reg = MetricsRegistry()
    inc = IncidentManager(registry=reg, directory=str(tmp_path / "inc"))
    slo = SLOMonitor(registry=reg, check_every=4, min_samples=2,
                     targets={"token": target_ms})
    sched = Scheduler(_engine(tm), registry=reg, slo=slo, incidents=inc)
    sched.run([Request(id=i, prompt=[9, 8, 7 + i], max_new_tokens=14)
               for i in range(2)])
    names = [m["rule"]["name"] for m in inc.incidents]
    assert names == ["slo_p95_drift"] * filed
    if filed:
        bundle = inc.incidents[0]["bundle"]
        with open(f"{bundle}/signals.json") as f:
            signals = json.load(f)
        assert signals["slo"]["report"]["token"]["breached"]
        assert signals["serving"]["iterations"] > 0
        assert signals["usage"]["requests"] == 2
