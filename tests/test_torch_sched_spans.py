"""The serving scheduler's phase spans and counters, on the port alone
(no JAX), on the serving test geometry of ``test_torch_serving.py``
(vocab 257, 2 layers, d_model 64, capacity 4, fp32, the model's own
seeded weights).

Held here:

* the spans tile ``Scheduler.tick``: each tick's phases observe once,
  and what a tick takes outside its phases (``serve.admit``,
  ``serve.prefill_round``, ``serve.decode_prep``, the engine step,
  ``serve.emit``, ``serve.planes``) is under 5% of it, for one scheduler
  and for the router's replicas;
* with ``CMN_OBS=0`` no phase instrument is built, no clock is read for
  a phase and no profiler range opens, even under a profiler;
* the ``serve.*`` ranges open only while a ``torch.profiler`` records,
  and nest ``serve.tick`` ⊃ phases ⊃ ``serve.engine.*``; none enters the
  span ring;
* ``serve.prefill.tokens`` and ``serve.prefill.padded_tokens`` agree
  with the request timeline's prefill chunks.
"""

import time
import types

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.observability import metrics as omet
from chainermn_tpu_torch.observability import tracing as otrace
from chainermn_tpu_torch.observability.metrics import MetricsRegistry
from chainermn_tpu_torch.observability.tracing import (
    RequestTimeline,
    SpanRing,
)
from chainermn_tpu_torch.serving import DecodeEngine, Request, Router
from chainermn_tpu_torch.serving import Scheduler

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

KW = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope")
ENG = dict(capacity=4, num_blocks=40, block_len=8, prefill_chunk=16)
#: prompt lengths over the ladder (several chunks, a ladder tail) and
#: output lengths; 14 blocks of 8 for 4 slots makes the pool evict.
SHAPES = [(5, 7), (20, 12), (33, 3), (9, 20), (14, 6), (26, 9), (41, 5)]
PHASES = ("serve.admit", "serve.prefill_round", "serve.decode_prep",
          "serve.emit", "serve.planes")
ENGINE_SPANS = ("serve.engine.prefill", "serve.engine.step")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return TransformerLM(**KW, dtype=torch.float32,
                         decode_attention="fused", device="cpu")


def _engine(model, **over):
    return DecodeEngine(model, **{**ENG, **over}, device="cpu")


def _requests(n=len(SHAPES)):
    rng = np.random.RandomState(0)
    return [Request(id=i, prompt=rng.randint(1, 257, size=p).tolist(),
                    max_new_tokens=m)
            for i, (p, m) in enumerate(SHAPES[:n])]


def _drain(sched, requests):
    """Submit ``requests`` and tick until nothing is pending; returns the
    ticks run and their time (ms), from a clock around each call."""
    for r in requests:
        sched.submit(r)
    ticks, ms = 0, 0.0
    while sched.pending:
        t0 = time.perf_counter()
        sched.tick()
        ms += (time.perf_counter() - t0) * 1e3
        ticks += 1
    return ticks, ms


def _sum(reg, name):
    h = reg.peek(name)
    return h.to_dict()["sum"] if h is not None else 0.0


def _residue(reg, tick):
    """The ticks' time (``tick`` ms) outside their phases and the engine
    step, as a share of it."""
    inside = sum(_sum(reg, p + "_ms") for p in PHASES)
    inside += _sum(reg, "serve.decode_ms") + _sum(reg, "serve.mixed_ms")
    return (tick - inside) / tick


def test_spans_tile_the_tick(model):
    reg = MetricsRegistry()
    sched = Scheduler(_engine(model), registry=reg)
    ticks, ms = _drain(sched, _requests())
    assert len(sched.completions) == len(SHAPES)
    # One observation a tick of each phase but the planes, which observe
    # a second time in a tick with a decode step, and the emit, once a
    # step.
    for p in ("serve.admit", "serve.prefill_round", "serve.decode_prep"):
        assert reg.peek(p + "_ms").count == ticks, p
    steps = reg.peek("serve.decode_ms").count + reg.peek(
        "serve.mixed_ms").count
    assert reg.peek("serve.emit_ms").count == steps > 0
    assert reg.peek("serve.planes_ms").count == ticks + steps
    # The phases nest inside the tick, and the engine's prefill inside
    # the prefill round.
    assert _sum(reg, "serve.prefill_ms") <= _sum(reg, "serve.prefill_round_ms")
    assert 0.0 <= _residue(reg, ms) < 0.05


def test_router_replicas_tile_their_ticks(model):
    router = Router([_engine(model), _engine(model)],
                    registry=MetricsRegistry())
    counts, ms = [0, 0], [0.0, 0.0]
    for i, s in enumerate(router.schedulers):
        def counted(i=i, tick=s.tick):
            counts[i] += 1
            t0 = time.perf_counter()
            out = tick()
            ms[i] += (time.perf_counter() - t0) * 1e3
            return out
        s.tick = counted
    router.run(_requests())
    assert sum(len(s.completions) for s in router.schedulers) == len(SHAPES)
    for i, reg in enumerate(router.replica_registries):
        assert reg.peek("serve.admit_ms").count == counts[i] > 0
        assert 0.0 <= _residue(reg, ms[i]) < 0.05


def test_phase_span_observes_and_closes_its_range(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            self.name, self.closed = name, False
            opened.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.closed = True

    monkeypatch.setattr(otrace, "named_scope", Range)
    reg = MetricsRegistry()
    span = otrace.PhaseSpan("loop.phase", reg.histogram("loop.phase_ms"))
    range_only = otrace.PhaseSpan("loop.range_only")
    with span:
        pass
    assert reg.peek("loop.phase_ms").count == 1 and not opened
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span:
                raise ValueError("boom")
        assert reg.peek("loop.phase_ms").count == 2
        assert [r.name for r in opened] == ["loop.phase"]
        assert opened[0].closed
        with range_only:
            pass
    assert opened[-1].name == "loop.range_only" and opened[-1].closed
    # A range-only span builds no histogram.
    assert reg.peek("loop.range_only_ms") is None


def test_obs_off_builds_no_phase_instrument(model, monkeypatch):
    monkeypatch.setenv("CMN_OBS", "0")
    fresh = MetricsRegistry()
    monkeypatch.setattr(omet, "_registry", fresh)
    calls = {"scope": 0, "clock": 0}
    real = otrace.named_scope

    def scope(name):
        calls["scope"] += 1
        return real(name)

    def clock():
        calls["clock"] += 1
        return 0.0

    monkeypatch.setattr(otrace, "named_scope", scope)
    monkeypatch.setattr(otrace, "time",
                        types.SimpleNamespace(perf_counter=clock))
    sched = Scheduler(_engine(model))
    for name in ("tick", "admit", "prefill_round", "eng_prefill",
                 "decode_prep", "eng_step", "emit", "planes"):
        assert getattr(sched, "_sp_" + name) is otrace.NOOP_SPAN, name
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _drain(sched, _requests(3))
    assert len(sched.completions) == 3
    assert calls == {"scope": 0, "clock": 0}
    for name in ("serve.admit_ms", "serve.prefill_round_ms",
                 "serve.decode_prep_ms", "serve.emit_ms", "serve.planes_ms",
                 "serve.prefill.tokens", "serve.prefill.padded_tokens"):
        assert fresh.peek(name) is None, name


def _ranges(prof):
    """The profile's ``serve.*`` host ranges, ``(name, start, end)``,
    in start order."""
    out = []
    for e in prof.events():
        if e.name.startswith("serve.") and \
                getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_ranges_only_while_a_profiler_records_and_they_nest(
        model, monkeypatch):
    opened = []
    real = otrace.named_scope

    def scope(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(otrace, "named_scope", scope)
    reg = MetricsRegistry()
    ring = SpanRing(4096)
    sched = Scheduler(_engine(model), registry=reg,
                      timeline=RequestTimeline(ring=ring))
    reqs = _requests()
    for r in reqs:
        sched.submit(r)
    for _ in range(3):
        sched.tick()
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ticks = 0
        while sched.pending and ticks < 12:
            sched.tick()
            ticks += 1
    assert opened.count("serve.tick") == ticks
    after = len(opened)
    if sched.pending:
        sched.tick()
    assert len(opened) == after
    ranges = _ranges(prof)
    ticks_r = [r for r in ranges if r[0] == "serve.tick"]
    assert len(ticks_r) == ticks
    phases = [r for r in ranges if r[0] in PHASES]
    engine = [r for r in ranges if r[0] in ENGINE_SPANS]
    assert {r[0] for r in phases} >= set(PHASES)
    assert {r[0] for r in engine} == set(ENGINE_SPANS)
    for r in phases + engine:
        assert any(_inside(r, t) for t in ticks_r), r
    rounds = [r for r in phases if r[0] == "serve.prefill_round"]
    for r in engine:
        if r[0] == "serve.engine.prefill":
            assert any(_inside(r, p) for p in rounds), r
        else:
            # Between its tick's decode inputs and its tokens' emit,
            # inside no phase.
            assert not any(_inside(r, p) for p in phases), r
            t = next(t for t in ticks_r if _inside(r, t))
            mine = [p for p in phases if _inside(p, t)]
            prep = [p for p in mine if p[0] == "serve.decode_prep"]
            emit = [p for p in mine if p[0] == "serve.emit"]
            assert prep[-1][2] <= r[1] and r[2] <= emit[0][1]
    # Phases are siblings: none lies inside another.
    for a in phases:
        for b in phases:
            if a is not b:
                assert not _inside(a, b) or a[1:] == b[1:], (a, b)
    # The span ring holds the lifecycle's spans only.
    ops = {s["op"] for s in ring.snapshot()}
    assert not ops & {"serve.tick", "serve.prefill_round",
                      "serve.decode_prep", "serve.emit", "serve.planes",
                      *ENGINE_SPANS}


def test_prefill_counters_agree_with_the_timeline(model):
    reg = MetricsRegistry()
    tl = RequestTimeline()
    # A small pool: admissions evict the cache and re-admissions count.
    sched = Scheduler(_engine(model, num_blocks=14), registry=reg,
                      timeline=tl)
    _drain(sched, _requests())
    events = tl.events()
    chunks = [e.info for e in events if e.kind == "prefill"]
    ladder = sched.engine.prefill_ladder
    tokens = sum(c["end"] - c["p0"] for c in chunks)
    padded = sum(sched._ladder_size(c["end"] - c["p0"]) if c["final"]
                 else ladder[-1] for c in chunks)
    assert all(c["final"] or c["end"] - c["p0"] == ladder[-1]
               for c in chunks)
    assert reg.peek("serve.prefill.tokens").value == tokens
    assert reg.peek("serve.prefill.padded_tokens").value == padded
    assert tokens < padded
    assert reg.peek("serve.prefill_ms").count == len(chunks)
