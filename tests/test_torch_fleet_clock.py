"""The port's fleet clock, merged trace and trace analyzer against the JAX
package's (``chainermn_tpu/observability/fleet.py`` and ``analyze.py``;
``tests/observability_tests/test_fleet.py``).

Against the JAX package on the same inputs, exactly: ``ntp_offset`` on
seeded round trips; ``FleetClock`` offsets, RTTs and the sentinel
protocol over an in-process pair whose two sides read fake clocks 10 s
apart (each probe's four readings scripted); ``collective_occurrences``,
``attribute_straggler``, ``critical_path`` and ``analyze`` on the same
trace dicts.  On the port, the JAX test file's behaviour cases, the
one-process ``export_fleet_trace``, the incident manifest's ``clock``
section once a clock is noted, and ``MetricsReport(fleet_trace=)``
writing the merged trace at finalize.
"""

import json
import queue
import threading

import numpy as np
import pytest

from chainermn_tpu.observability import analyze as jax_analyze
from chainermn_tpu.observability import fleet as jax_fleet
from chainermn_tpu.observability import metrics as jax_metrics
from chainermn_tpu_torch.observability import analyze as oanalyze
from chainermn_tpu_torch.observability import fleet as ofleet
from chainermn_tpu_torch.observability import metrics as omet
from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1


# ------------------------------------------------------------ offset math
def test_ntp_offset_recovers_known_offset():
    off, rtt = ofleet.ntp_offset(100.0, 110.002, 110.003, 100.005)
    assert off == pytest.approx(10.0, abs=1e-9)
    assert rtt == pytest.approx(0.004, abs=1e-9)


def test_ntp_offset_error_bounded_by_asymmetry():
    off, rtt = ofleet.ntp_offset(100.0, 110.001, 110.001, 100.004)
    assert abs(off - 10.0) <= rtt / 2


def test_ntp_offset_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        t = np.cumsum(rng.uniform(0.0, 0.01, size=4)) + rng.uniform(0, 100)
        skew = rng.uniform(-5, 5)
        args = (t[0], t[1] + skew, t[2] + skew, t[3])
        assert ofleet.ntp_offset(*args) == jax_fleet.ntp_offset(*args)


# ------------------------------------------------- in-process clock sync
class _PairComm:
    """Two ranks over queues: the p2p surface FleetClock needs (with
    HostComm's ``op=`` keyword)."""

    def __init__(self, rank, q_to_peer, q_from_peer):
        self.rank, self.size = rank, 2
        self._out, self._in = q_to_peer, q_from_peer

    def send_obj(self, obj, dest, op="send_obj"):
        self._out.put(obj)

    def recv_obj(self, source, op="recv_obj"):
        return self._in.get(timeout=30)


def test_fleet_clock_sync_same_host_offset_near_zero():
    a, b = queue.Queue(), queue.Queue()
    clock0 = ofleet.FleetClock(_PairComm(0, a, b), probes=5)
    clock1 = ofleet.FleetClock(_PairComm(1, b, a), probes=999)
    t = threading.Thread(target=clock1.sync, daemon=True)
    t.start()
    offsets = clock0.sync()
    t.join(timeout=30)
    assert not t.is_alive(), "the peer never saw the sentinel"
    assert set(offsets) == {0, 1}
    est = offsets[1]
    assert est.probes == 5 and est.rtt_s < 0.5
    assert abs(est.offset_s) <= max(est.rtt_s, 1e-3)
    assert clock0.offsets_s()[1] == est.offset_s
    assert clock1.synced_at is not None and clock1.offsets is None


def test_fleet_clock_single_rank_identity():
    clock = ofleet.FleetClock(None)
    assert clock.sync() == {0: ofleet.ClockOffset(0, 0.0, 0.0, 0)}
    assert clock.offsets_s() == {0: 0.0}
    with pytest.raises(ValueError):
        ofleet.FleetClock(None, probes=0)


def _fake_clock_sync(mod, probes, seed):
    """``mod.FleetClock.sync`` over a pair whose rank 1 reads a clock 10 s
    ahead with seeded one-way delays: every reading is scripted."""
    rng = np.random.RandomState(seed)
    reads0, reads1 = [], []
    t = 50.0
    for _ in range(probes):
        out, back = rng.uniform(1e-4, 3e-3, size=2)
        t0 = t
        t1 = t0 + out + 10.0
        t2 = t1 + rng.uniform(1e-5, 1e-4)
        t3 = t2 - 10.0 + back
        reads0 += [t0, t3]
        reads1 += [t1, t2]
        t = t3 + 1e-3
    reads0 += [t + 1.0]
    reads1 += [t + 11.0]
    a, b = queue.Queue(), queue.Queue()
    c0, c1 = _PairComm(0, a, b), _PairComm(1, b, a)
    clocks = {threading.get_ident(): iter(reads0)}
    real = mod.time.perf_counter

    def fake():
        it = clocks.get(threading.get_ident())
        return next(it) if it is not None else real()

    mod.time.perf_counter = fake
    try:
        peer = mod.FleetClock(c1, probes=probes)

        def run_peer():
            clocks[threading.get_ident()] = iter(reads1)
            peer.sync()

        th = threading.Thread(target=run_peer, daemon=True)
        th.start()
        offsets = mod.FleetClock(c0, probes=probes).sync()
        th.join(timeout=30)
    finally:
        mod.time.perf_counter = real
    return {r: (o.offset_s, o.rtt_s, o.probes) for r, o in offsets.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_clock_offsets_over_fake_clock_match_jax(seed):
    got = _fake_clock_sync(ofleet, 6, seed)
    assert got == _fake_clock_sync(jax_fleet, 6, seed)
    off, rtt, probes = got[1]
    assert abs(off - 10.0) <= rtt / 2 and probes == 6


# ------------------------------------------------------ pairing + verdict
def _span(op, seq, t, ms=5.0, ok=True):
    return {"op": op, "seq": seq, "t_mono": t, "ms": ms, "ok": ok}


def _dumps(skew_s=0.025, n=6, from_k=3):
    d0 = {"rank": 0, "spans": [_span("allreduce_obj", k, 10.0 + k, 30.0)
                               for k in range(n)]}
    d1 = {"rank": 1, "spans": [
        _span("allreduce_obj", k,
              10.0 + k + (skew_s if k >= from_k else 2e-4))
        for k in range(n)]}
    return [d0, d1]


def _seeded_dumps(seed, nranks=3, n=8):
    rng = np.random.RandomState(seed)
    ops = ("barrier", "allgather_obj", "allreduce_obj", "send_obj")
    out = []
    for r in range(nranks):
        spans = []
        for k in range(n):
            op = ops[k % len(ops)]
            spans.append(_span(op, k // len(ops), 10.0 + k
                               + float(rng.uniform(0, 0.04)),
                               float(rng.uniform(1, 20))))
        out.append({"rank": r, "spans": spans})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_occurrences_critical_path_and_analyze_match_jax(seed):
    dumps = _seeded_dumps(seed)
    offsets = {1: 0.002 * (seed + 1), 2: -0.001}
    occ = ofleet.collective_occurrences(dumps, offsets)
    assert occ == jax_fleet.collective_occurrences(dumps, offsets)
    assert ofleet.attribute_straggler(occ, min_skew_ms=5.0) == \
        jax_fleet.attribute_straggler(occ, min_skew_ms=5.0)
    assert oanalyze.critical_path(occ) == jax_analyze.critical_path(occ)
    trace = jax_fleet.merge_fleet_trace(
        dumps, registry=jax_metrics.MetricsRegistry())["payload"]
    assert oanalyze.analyze(trace) == jax_analyze.analyze(trace)
    trace.pop("cmn_fleet")
    assert oanalyze.occurrences_from_trace(trace) == \
        jax_analyze.occurrences_from_trace(trace)


def test_collective_occurrences_pair_by_seq_and_measure_skew():
    occ = ofleet.collective_occurrences(_dumps())
    assert [o["seq"] for o in occ] == list(range(6))
    assert all(o["last_rank"] == 1 for o in occ[3:])
    assert occ[3]["skew_ms"] == pytest.approx(25.0, rel=1e-6)
    assert occ[0]["skew_ms"] == pytest.approx(0.2, rel=1e-6)


def test_collective_occurrences_survive_ring_eviction():
    d0, d1 = _dumps()
    d1["spans"] = d1["spans"][4:]
    occ = ofleet.collective_occurrences([d0, d1])
    assert [o["seq"] for o in occ] == [4, 5]
    assert all(o["last_rank"] == 1 for o in occ)


def test_collective_occurrences_apply_clock_offsets():
    d0, d1 = _dumps()
    for s in d1["spans"]:
        s["t_mono"] += 100.0
    occ = ofleet.collective_occurrences([d0, d1], offsets_s={1: 100.0})
    assert occ[3]["skew_ms"] == pytest.approx(25.0, rel=1e-6)
    assert occ[0]["last_rank"] == 1 and occ[0]["skew_ms"] < 1.0


def test_attribute_straggler_names_dominant_rank():
    verdict = ofleet.attribute_straggler(
        ofleet.collective_occurrences(_dumps()))
    assert verdict["straggler_rank"] == 1
    assert verdict["charged_collectives"] == 3
    assert verdict["total_stall_ms"] == pytest.approx(75.0, rel=1e-5)


def test_attribute_straggler_noise_names_nobody():
    verdict = ofleet.attribute_straggler(
        ofleet.collective_occurrences(_dumps(skew_s=2e-4, from_k=0)))
    assert verdict["straggler_rank"] is None
    assert verdict["charged_collectives"] == 0


def test_attribute_straggler_split_blame_names_nobody():
    d0 = {"rank": 0, "spans": [
        _span("barrier", k, 10.0 + k + (0.02 if k % 2 else 0.0))
        for k in range(6)]}
    d1 = {"rank": 1, "spans": [
        _span("barrier", k, 10.0 + k + (0.0 if k % 2 else 0.02))
        for k in range(6)]}
    verdict = ofleet.attribute_straggler(
        ofleet.collective_occurrences([d0, d1]), min_share=0.6)
    assert verdict["straggler_rank"] is None
    assert set(verdict["stall_ms_by_rank"]) == {"0", "1"}


# ------------------------------------------------------------ trace merge
def test_merge_fleet_trace_payload_and_metrics():
    reg = omet.MetricsRegistry()
    merged = ofleet.merge_fleet_trace(_dumps(), registry=reg)
    payload, summary = merged["payload"], merged["summary"]
    evs = json.loads(json.dumps(payload))["traceEvents"]
    assert {"process_name", "allreduce_obj"} <= {e["name"] for e in evs}
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {0, 1}
    assert min(e["ts"] for e in evs if e["ph"] == "X") == 0.0
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(instants) == 3 and all(e["pid"] == 1 for e in instants)
    assert summary["straggler_rank"] == 1
    snap = reg.snapshot()
    assert snap["fleet.collective_skew_ms"]["count"] == 6
    assert snap["fleet.straggler_rank"]["value"] == 1


def test_merge_fleet_trace_unfaulted_gauges_minus_one():
    reg = omet.MetricsRegistry()
    ofleet.merge_fleet_trace(_dumps(skew_s=2e-4, from_k=0), registry=reg)
    assert reg.snapshot()["fleet.straggler_rank"]["value"] == -1


def test_export_fleet_trace_single_process(tmp_path):
    from chainermn_tpu_torch.observability import tracing as otrace

    with otrace.tracer().span("barrier"):
        pass
    path = str(tmp_path / ofleet.MERGED_TRACE)
    summary = ofleet.export_fleet_trace(None, path=path)
    assert summary["path"] == path and summary["nranks"] == 1
    blob = json.load(open(path))
    assert {"traceEvents", "cmn_fleet"} <= set(blob)
    assert summary["straggler_rank"] is None


def test_incident_manifest_carries_the_noted_clock(tmp_path):
    from chainermn_tpu_torch.observability import incident

    reg = omet.MetricsRegistry()
    mgr = incident.IncidentManager(
        directory=str(tmp_path), registry=reg,
        rules=[incident.Watch("t", "x.count", "> 0")])
    clock = ofleet.FleetClock(None)
    clock.sync()
    mgr.note_fleet_clock(clock)
    reg.counter("x.count").inc()
    mgr.evaluate()
    (man,) = mgr.incidents
    assert man["clock"] == {"synced": True, "offsets_s": {"0": 0.0},
                            "worst_rtt_ms": 0.0}
    stats = incident.run_stats()
    assert set(stats) == {"count", "dropped", "newest"}


# -------------------------------------------------------------- analyzer
def test_analyzer_critical_path_bounds_steps_on_last_rank():
    merged = ofleet.merge_fleet_trace(_dumps(),
                                      registry=omet.MetricsRegistry())
    report = oanalyze.analyze(merged["payload"])
    assert report["straggler_rank"] == 1
    assert report["bounded_steps_by_rank"]["1"] >= 3
    skewed = [s for s in report["steps"] if s["seq"] >= 3]
    assert all(s["bound_rank"] == 1 for s in skewed)
    assert all(s["wait_ms"] == pytest.approx(25.0, rel=1e-5)
               for s in skewed)
    assert all(900.0 < s["bound_phase_ms"] < 1100.0
               for s in report["steps"][1:] if s["bound_rank"] == 1)


def test_analyzer_cli_human_and_json(tmp_path, capsys):
    merged = ofleet.merge_fleet_trace(_dumps(),
                                      registry=omet.MetricsRegistry())
    path = str(tmp_path / "t.json")
    json.dump(merged["payload"], open(path, "w"))
    assert oanalyze.main([path]) == 0
    out = capsys.readouterr().out
    assert "straggler: rank 1" in out and "bounded by rank" in out
    assert oanalyze.main([path, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["straggler_rank"] == 1 and len(rep["steps"]) == 6


# ------------------------------------------------ MetricsReport(fleet_trace)
def test_metrics_report_writes_the_merged_trace(tmp_path):
    """One rank: the clock syncs at the first tick and is noted on the
    incident manager, and finalize writes the merged trace with the
    communicator's object-plane collectives in it."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import make_synthetic_classification
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.observability import incident
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )
    from chainermn_tpu_torch.training import (
        Extension,
        MetricsReport,
        Trainer,
    )

    comm = create_communicator("naive", device="cpu")
    model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu")
    opt = create_multi_node_optimizer(sgd(0.1), comm)
    path = str(tmp_path / "trace.merged.json")
    rep = MetricsReport(comm, trigger=(2, "iteration"),
                        out_dir=str(tmp_path / "obs"), fleet_trace=path)
    tr = Trainer(opt, opt.init(model), classification_loss(model),
                 SerialIterator(make_synthetic_classification(
                     128, 8, 4, seed=1), 16, shuffle=True, seed=0),
                 stop=(4, "iteration"), has_aux=True, extensions=[
                     rep, Extension(lambda t: comm.allgather_obj(
                         t.iteration), (1, "iteration"))])
    tr.run()
    assert rep._fleet_clock is not None and \
        rep._fleet_clock.synced_at is not None
    assert incident.manager()._fleet_clock() is rep._fleet_clock
    assert rep.fleet_summary["path"] == path
    blob = json.load(open(path))
    names = {e["name"] for e in blob["traceEvents"] if e["ph"] == "X"}
    assert "allgather_obj" in names  # the communicator's, traced
