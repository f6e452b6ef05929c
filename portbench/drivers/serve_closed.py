"""Serving cells with a closed loop of clients: the port's
``Scheduler.tick`` over a ``DecodeEngine``.

Set-up makes the weights from the seed, builds the engine with a pool
that covers every slot's whole context (nothing is evicted), warms the
decode step's graph and every prefill geometry (copied from the port's
chip smoke, ``warm_engine``), then starts the clients: each sends its
next request when its last one completes, and the loop runs until
``preroll_completions`` requests have completed, so that the window
starts in a steady state: by then the prefix cache has filled the pool
with the finished prompts' blocks, and each admission evicts.

The window ticks the scheduler for ``--seconds``.  A request that
completes inside it counts its output tokens toward
``serve_tokens_per_s``, and its time per output token after the first,
(last token's time - first token's time) / (tokens - 1), toward
``serve_tpot_p95_ms``: the first token's time is the end of its final
prefill chunk in the scheduler's request timeline, the last its
retirement.  The window's quarters are logged on standard error (ticks,
host and decode milliseconds a tick, tokens a second, the pool's free
and cached blocks), so that a drift within it shows.  A traced run ticks
``trace_ticks`` more under a profiler of the device alone, and as many
again under one of the host and the device, which names the idle gaps.

Once the window has closed the engine is freed, and the plain reference
runs once over a sample of the finished requests, drawn from the seed
with the longest among them: every served token's reference logit
against the reference's best at its position.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from portbench import generate, judge
from portbench.reference import exact_fp32
from portbench.roofline import paged_decode_bound
from portbench.trace import kernel_seconds, profile_cost, profiled
from portbench.weights import make_weights, sub_seed

#: the scheduler's step histograms the per-layer metrics read.
HISTOGRAMS = ("serve.decode_ms", "serve.mixed_ms", "serve.prefill_ms")


def warm_engine(eng, vocab: int, seed: int) -> None:
    """One request of 20 new tokens (the decode step's capture), then
    prompts whose last chunks take every prefill geometry of the ladder,
    so that each prefill graph is captured before the window; the
    prefix cache is emptied after."""
    from chainermn_tpu_torch.serving import Request, Scheduler

    rng = np.random.RandomState(sub_seed(seed, "sample") % (1 << 32))
    Scheduler(eng).run([Request(id=0, prompt=rng.randint(
        0, vocab, size=64).tolist(), max_new_tokens=20)])
    top = max(eng.prefill_ladder)
    Scheduler(eng).run([
        Request(id=i, prompt=rng.randint(0, vocab, size=top + c).tolist(),
                max_new_tokens=2)
        for i, c in enumerate(eng.prefill_ladder)])
    eng.drop_prefix_cache()


class ClosedLoop:
    """``clients`` clients over one scheduler; each sends its next
    request when its last one completes.  ``tick()`` runs one scheduler
    tick inside the loop's own span and then lets the clients whose
    requests completed send again."""

    def __init__(self, sched, requests: generate.Requests, clients: int):
        self.sched, self.requests, self.clients = sched, requests, clients
        self.sent = 0
        self.seen = 0
        self.prompt_len: Dict[int, int] = {}
        self.tick_s = 0.0
        self.ticks = 0

    def _send(self) -> None:
        from chainermn_tpu_torch.serving import Request

        k = self.sent
        prompt, n_out = self.requests.request(k)
        self.sched.submit(Request(id=k, prompt=prompt, max_new_tokens=n_out,
                                  arrival=self.sched.clock.now()))
        self.prompt_len[k] = len(prompt)
        self.sent += 1

    def start(self) -> None:
        for _ in range(self.clients):
            self._send()

    def tick(self) -> None:
        t0 = time.perf_counter()
        self.sched.tick()
        self.tick_s += time.perf_counter() - t0
        self.ticks += 1
        while self.seen < len(self.sched.completions):
            self.seen += 1
            self._send()


class Quarter:
    """The loop's counts at one moment of the window."""

    def __init__(self, loop, reg, eng, w0: float):
        self.t = loop.sched.clock.now()
        self.ticks, self.tick_s, self.hist = loop.ticks, loop.tick_s, _hist(reg)
        self.tokens = sum(len(c.tokens) for c in loop.sched.completions
                          if c.finished_at >= w0 and c.status == "ok")
        st = eng.stats()
        self.free = st["free_blocks"]
        self.cached = st.get("prefix_cached_blocks", 0)

    def since(self, q0: "Quarter") -> str:
        n = max(1, self.ticks - q0.ticks)
        inside = sum(self.hist[k][0] - q0.hist[k][0] for k in HISTOGRAMS)
        dec = self.hist["serve.decode_ms"]
        dec0 = q0.hist["serve.decode_ms"]
        return (f"ticks {self.ticks - q0.ticks} tick_ms "
                f"{(self.tick_s - q0.tick_s) * 1e3 / n:.3f} host_ms "
                f"{((self.tick_s - q0.tick_s) * 1e3 - inside) / n:.3f} "
                f"decode_ms {(dec[0] - dec0[0]) / max(1, dec[1] - dec0[1]):.3f}"
                f" tokens_per_s "
                f"{(self.tokens - q0.tokens) / max(1e-9, self.t - q0.t):.1f}"
                f" free_blocks {self.free} cached_blocks {self.cached}")


def _hist(reg) -> Dict[str, tuple]:
    out = {}
    for name in HISTOGRAMS:
        h = reg.peek(name)
        d = h.to_dict() if h is not None else {"sum": 0.0, "count": 0}
        out[name] = (d["sum"], d["count"])
    return out


def positions(events, prompt_len: Dict[int, int]):
    """Walk the request timeline: for each decode step, its clock time
    and the positions its live requests attend (the position it writes,
    plus one); for each request, when its first token came."""
    nxt: Dict[int, int] = {}
    first: Dict[int, float] = {}
    steps = []
    prefills = []
    for ev in events:
        if ev.kind == "prefill":
            info = ev.info or {}
            prefills.append((ev.t, ev.req, info["p0"], info["end"],
                             bool(info.get("final"))))
            if info.get("final"):
                nxt[ev.req] = info["end"]
                first.setdefault(ev.req, ev.t + ev.dur_ms / 1e3)
        elif ev.kind == "decode":
            valid = []
            for _, req in ev.info["reqs"]:
                p = nxt.get(req, prompt_len.get(req, 0))
                valid.append(p + 1)
                nxt[req] = p + 1
            steps.append((ev.t, valid))
    return steps, prefills, first


def model_flops(cfg: dict, fam, steps, prefills, t0: float, t1: float
                ) -> float:
    """Model FLOPs of the work started in ``[t0, t1)``: two a matmul
    parameter per token processed, the head once per token sampled, and
    attention's two products, 4·Dh a (query, attended position) pair."""
    d = fam.reference.dims(cfg)
    head = 2.0 * d["D"] * d["V"]
    body = 2.0 * (fam.matmul_params(cfg) - d["D"] * d["V"])
    attn = 4.0 * d["Dh"] * d["H"] * d["L"]
    total = 0.0
    for t, _, p0, end, final in prefills:
        if t0 <= t < t1:
            n = end - p0
            total += body * n + attn * (n * p0 + n * (n + 1) / 2)
            total += head if final else 0.0
    for t, valid in steps:
        if t0 <= t < t1:
            total += (body + head) * len(valid) + attn * sum(valid)
    return total


def reference_gaps(run, picks, prompts, served, rnd=None) -> List[float]:
    """The widest gap of each picked request's served tokens under the
    reference (``rnd``: the control's precision, whose own first choice
    at each position is judged in place of the served token)."""
    torch, cell = run.torch, run.cell
    fam, cfg = cell.family, cell.config
    w = make_weights(fam.weight_specs(cfg), run.seed, run.device, torch)
    gaps = []
    with torch.no_grad(), exact_fp32(torch):
        for k in picks:
            toks = prompts[k] + served[k][:-1]
            ids = torch.tensor([toks], device=run.device)
            logits = fam.reference.forward(w, cfg, ids)[0, len(prompts[k]) - 1:]
            if rnd is None:
                want = torch.tensor(served[k], device=run.device)
            else:
                want = fam.reference.forward(w, cfg, ids, rnd)[
                    0, len(prompts[k]) - 1:].argmax(-1)
            gaps.append(judge.logit_gap(logits, want))
    return gaps


def run(run) -> dict:
    """One run of a closed-loop serving cell."""
    from chainermn_tpu_torch.observability import tracing
    from chainermn_tpu_torch.observability.metrics import registry
    from chainermn_tpu_torch.serving import DecodeEngine, Scheduler

    torch, cell, dev = run.torch, run.cell, run.device
    fam, cfg, traffic = cell.family, cell.config, cell.traffic
    e = traffic["engine"]
    vocab = fam.reference.dims(cfg)["V"]
    weights = make_weights(fam.weight_specs(cfg), run.seed, dev, torch)
    model = fam.serving_model(cfg, dev)
    fam.load(cfg, model, weights)
    del weights
    mb = e["positions_per_slot"] // e["block_len"]
    eng = DecodeEngine(model, capacity=e["capacity"],
                       num_blocks=1 + e["capacity"] * mb,
                       block_len=e["block_len"], max_blocks_per_slot=mb,
                       prefill_chunk=e["prefill_chunk"],
                       prefix_cache=e["prefix_cache"], device=dev)
    run.log("engine built")
    warm_engine(eng, vocab, run.seed)
    run.log("engine warm")
    reqs = generate.Requests(traffic, run.seed, vocab)
    timeline = tracing.RequestTimeline(capacity=1 << 20,
                                       ring=tracing.tracer().ring)
    sched = Scheduler(eng, timeline=timeline)
    loop = ClosedLoop(sched, reqs, traffic["clients"])
    loop.start()
    while len(sched.completions) < traffic["preroll_completions"]:
        loop.tick()
    eng.sync()
    setup_s = run.since_start()
    run.log("set-up done")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reg = registry()
    h0, span0, ticks0 = _hist(reg), loop.tick_s, loop.ticks
    w0, t0 = sched.clock.now(), time.perf_counter()
    quarters = [Quarter(loop, reg, eng, w0)]
    while time.perf_counter() - t0 < run.seconds:
        loop.tick()
        if len(quarters) < 4 and \
                time.perf_counter() - t0 >= len(quarters) * run.seconds / 4:
            quarters.append(Quarter(loop, reg, eng, w0))
    w1 = sched.clock.now()
    h1, span1, ticks1 = _hist(reg), loop.tick_s, loop.ticks
    quarters.append(Quarter(loop, reg, eng, w0))
    for q0, q1 in zip(quarters, quarters[1:]):
        run.log("quarter " + q1.since(q0))
    rec = {"kind": "serve", "family": cfg["family"], "chips": 1,
           "setup_s": setup_s, "window_s": w1 - w0}
    if run.trace and dev.type == "cuda":
        marks = []

        def ticks():
            marks.append(sched.clock.now())
            for _ in range(traffic["trace_ticks"]):
                loop.tick()
            marks.append(sched.clock.now())

        rec["trace"] = profiled(torch, ticks)
        rec["trace_clock"] = (marks[0], marks[1])
        run.log(profile_cost(rec["trace"], (span1 - span0) / (ticks1 - ticks0),
                             traffic["trace_ticks"], "tick"))
    run.log("window done")
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                if dev.type == "cuda" else 0)
    done = [c for c in sched.completions if w0 <= c.finished_at <= w1]
    ok = [c for c in done if c.status == "ok"]
    steps, prefills, first = positions(timeline.events(), loop.prompt_len)
    tpot = [(c.finished_at - first[c.id]) / (len(c.tokens) - 1) * 1e3
            for c in ok if len(c.tokens) > 1]
    tpot += [float("inf")] * (len(done) - len(ok))
    rec["e2e"] = {
        "serve_tokens_per_s": sum(len(c.tokens) for c in ok) / (w1 - w0),
        "serve_tpot_p95_ms": (float(np.percentile(tpot, 95))
                              if tpot else float("inf")),
        "setup_s": setup_s}
    rec["attempted"], rec["failed"] = len(done), len(done) - len(ok)
    hd = {k: (h1[k][0] - h0[k][0], h1[k][1] - h0[k][1]) for k in HISTOGRAMS}
    rec["ticks"] = ticks1 - ticks0
    rec["tick_s"] = span1 - span0
    rec["hist_ms"] = hd
    rec["model_flops"] = model_flops(cfg, fam, steps, prefills, w0, w1)
    if "trace" in rec:
        d = fam.reference.dims(cfg)
        c0, c1 = rec["trace_clock"]
        rec["paged_bound_s"] = sum(
            d["L"] * paged_decode_bound(valid, e["capacity"], d["H"], d["H"],
                                        d["Dh"], e["block_len"])[0]
            for t, valid in steps if c0 <= t < c1)
        # K4 runs once a layer a decode step: the trace must hold them all.
        n_steps = sum(1 for t, _ in steps if c0 <= t < c1)
        k4 = kernel_seconds(rec["trace"], "decode_paged")[1]
        run.log(f"K4 runs in the trace {k4}"
                f", decode steps x layers {n_steps * d['L']}")
    # The sample: the longest finished request, and others drawn from
    # the seed.
    served = {c.id: list(c.tokens) for c in ok}
    prompts = {k: reqs.request(k)[0] for k in served}
    ids = sorted(served)
    picks = []
    if ids:
        longest = max(ids, key=lambda k: len(prompts[k]) + len(served[k]))
        rest = [k for k in ids if k != longest]
        rng = np.random.RandomState(sub_seed(run.seed, "sample") % (1 << 32))
        n = min(len(rest), traffic["check_requests"] - 1)
        picks = [longest] + [rest[i] for i in rng.choice(len(rest), n,
                                                         replace=False)]
    if run.fault_tokens is not None:
        run.fault_tokens(served, picks)
    eng.release()
    del eng, sched, loop, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = reference_gaps(run, picks, prompts, served)
    run.log("reference done")
    rec["numbers"] = {"logit_gap": max(gaps) if gaps else float("inf")}
    rec["where"] = {"requests": picks,
                    "served_tokens": sum(len(served[k]) for k in picks)}
    rec["sample"] = (picks, prompts, served)
    return rec
