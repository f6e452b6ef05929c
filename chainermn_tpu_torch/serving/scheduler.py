"""Iteration-level scheduler: admission, interleaved prefill, eviction.

Continuous batching (Yu et al. 2022, *Orca*): scheduling decisions happen
every *iteration* (one engine decode step), not once per batch.  A request
joins the running step the moment a slot and enough pool blocks free up,
and leaves the instant it emits EOS or its token budget.

Loop shape (one :meth:`Scheduler.tick`):

1. **Deadlines** — cancel live and queued requests past their deadline.
2. **Admit** — FIFO over arrived requests (weighted-fair under a policy
   plane) while a slot is free and the allocator covers the first
   prefill chunk.
3. **Prefill one chunk per prefilling slot** (oldest first; chunked on
   the engine's ladder so a long prompt cannot stall running decodes).
4. **Decode step** (or speculative round) for every live slot, then
   retire finished ones and recycle their blocks.

**Prefix sharing**: admission asks the engine's prefix trie for the
longest cached prefix of ``prompt + carried`` and maps those physical
blocks into the new slot's table (one refcount each); prefill resumes at
the first unmatched token.  A partial match lends the leading tokens of a
cached block: the slot copies that block on its first write into it
(:meth:`~chainermn_tpu_torch.serving.engine.DecodeEngine.cow_copy`), so
the cached original is never mutated.  Full prompt blocks are inserted
when prefill finishes, full ``prompt + generated`` blocks at retirement.

**Backpressure**: blocks are allocated lazily.  When the free list runs
dry the scheduler first drains the prefix cache (LRU leaves nobody else
holds), then evicts the youngest-admitted slot: its references return to
the allocator and the request re-queues at the front carrying the tokens
it already generated (recompute-style preemption).

Metrics publish into the port's registry (``serve.queue_depth``,
``serve.slot_occupancy``, ``serve.tokens``, ``serve.prefill_ms``,
``serve.decode_ms``, ``serve.mixed_ms``, ``serve.prefix.*``,
``serve.spec.*``, ``serve.health.deadline_cancels``).  A decode step
reads its tokens back, so it is timed end to end; a non-final prefill
chunk is queued only, so a decode step that follows such chunks books to
``serve.mixed_ms`` and ``serve.decode_ms`` holds only clean decode
iterations.  Phase spans tile each tick (``serve.admit_ms``,
``serve.prefill_round_ms``, ``serve.decode_prep_ms``, ``serve.emit_ms``,
``serve.planes_ms``; profiler ranges only while a profiler records,
:meth:`Scheduler.tick`), with the counters ``serve.prefill.tokens`` and
``serve.prefill.padded_tokens`` at the prefill chunks.

**The planes**, all riding the ``CMN_OBS`` master switch as in the JAX
package (each explicit argument wins; ``ledger=False`` forces the ledger
off):

* every lifecycle transition (submitted → admitted → each prefill chunk
  → eviction/readmission → per-iteration decode → retired) lands in a
  :class:`~chainermn_tpu_torch.observability.tracing.RequestTimeline`
  mirrored into the process span ring; :meth:`Scheduler.export_trace`
  writes the run as Chrome trace-event JSON (Perfetto-loadable);
* a :class:`~chainermn_tpu_torch.observability.slo.SLOMonitor` tracks
  TTFT, queue wait and per-token latency, checked every
  ``slo.check_every`` decode iterations;
* a :class:`~chainermn_tpu_torch.observability.memory.MemoryMonitor`
  samples device watermarks and the KV pool on the same cadence;
* a :class:`~chainermn_tpu_torch.observability.ledger.CostLedger` books
  every request's cost (``CMN_OBS_LEDGER=0`` turns it off);
* the process :class:`~chainermn_tpu_torch.observability.incident.
  IncidentManager` evaluates its watch rules on that cadence and at
  drain;
* the device feed publishes ``device.<program>.*`` roofline gauges for
  the engine's hot program (``CMN_OBS_DEVICE=0`` turns just this off);
* the scheduler registers a ``"serving"`` flight-record provider (held
  by weakref) and arms the env-configured flight recorder.

A :class:`~chainermn_tpu_torch.serving.policy.PolicyPlane` (``policy=``)
replaces FIFO admission with weighted-fair admission, adds priority
preemption, per-tenant rate limits, deadlines and prefix quotas, and the
drift-latched prefill cap.

The decode step is a fault hook (site ``serve_step``, counted by decode
iteration): ``skew@serve_step:N:ms`` stretches every step from iteration
N on — the deterministic way to test that the SLO drift detector fires.

**Router seams**: :meth:`Scheduler.submit_entry` re-enqueues an entry
moved from a peer replica (carried tokens, retries and ledger record
ride along), :meth:`Scheduler.steal_queued` gives up queued work for a
rebalance, :meth:`Scheduler.ready_slots` names the decode-ready slots a
KV migration may ship, and :meth:`Scheduler.harvest_entries` strips a
dead or draining replica into recompute entries.  The
:class:`~chainermn_tpu_torch.serving.router.Router` interleaves
:meth:`Scheduler.tick` across replicas on one shared clock.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

import chainermn_tpu_torch.observability as _obs
from chainermn_tpu_torch.observability import device as _odevice
from chainermn_tpu_torch.observability import flight as _flight
from chainermn_tpu_torch.observability import incident as _oincident
from chainermn_tpu_torch.observability import ledger as _oledger
from chainermn_tpu_torch.observability import tracing as _tracing
from chainermn_tpu_torch.observability.memory import (
    MemoryMonitor,
    kv_pool_sample,
)
from chainermn_tpu_torch.observability.metrics import (
    DEFAULT_MS_EDGES,
    NoopInstrument as _NoopInstrument,
    registry as global_registry,
)
from chainermn_tpu_torch.observability.slo import SLOMonitor
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.serving.kv_pool import PoolExhausted, blocks_for
from chainermn_tpu_torch.serving.recovery import deadline_ms_from_env


@dataclass
class Request:
    """One generation request."""

    id: int
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token: Optional[int] = None
    #: arrival time on the scheduler clock (0 = available immediately).
    arrival: float = 0.0
    #: per-request sampling seed.
    seed: int = 0
    #: optional deadline, milliseconds after ``arrival``: a request still
    #: unfinished past it is cancelled (``Completion.status ==
    #: "deadline"``).  None defers to ``CMN_SERVE_DEADLINE_MS``.
    deadline_ms: Optional[float] = None
    #: tenant label: prefix-trie ownership, cost attribution in the usage
    #: ledger (``serve.tenant.*``), the policy plane's fair share.
    tenant: str = "default"
    #: priority class: under a
    #: :class:`~chainermn_tpu_torch.serving.policy.PolicyPlane`, a
    #: strictly higher class may preempt a running lower-class slot
    #: through the recompute-requeue path; 0 defers to the tenant's
    #: default class.
    priority: int = 0


@dataclass
class Completion:
    """A finished request: generated tokens + latency accounting.

    ``first_admitted_at`` is when the request first started service;
    ``admitted_at`` the final admission (they differ only after an
    eviction).  ``prefix_hit_tokens`` counts prompt+carried tokens served
    from the prefix cache over every admission; ``spec_proposed`` /
    ``spec_accepted`` are this request's draft bookkeeping.
    """

    id: int
    tokens: List[int]
    reason: str  # "eos" | "length" | "deadline"
    prompt_len: int
    arrival: float
    admitted_at: float
    finished_at: float
    evictions: int = 0
    first_admitted_at: float = 0.0
    prefix_hit_tokens: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: ``"ok"`` for a normal completion, else the terminal verdict.
    status: str = "ok"
    error: Optional[str] = None
    retries: int = 0
    #: the finalized :class:`~chainermn_tpu_torch.observability.ledger.
    #: UsageRecord` for this request; None when the ledger is off.
    usage: Optional[object] = None


@dataclass
class _QueueEntry:
    req: Request
    #: tokens generated before an eviction — re-prefilled and kept.
    carried: List[int] = field(default_factory=list)
    evictions: int = 0
    #: when the request first entered a slot (survives evictions).
    first_admit: Optional[float] = None
    prefix_hit_tokens: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    retries: int = 0
    last_error: Optional[str] = None


def terminal_completion(entry: _QueueEntry, status: str, now: float,
                        error: Optional[str] = None) -> Completion:
    """The one Completion shape for requests that end without serving to
    completion (deadline here; poisoned/shed with the router)."""
    return Completion(
        id=entry.req.id,
        tokens=list(entry.carried),
        reason=status,
        prompt_len=len(entry.req.prompt),
        arrival=entry.req.arrival,
        admitted_at=(
            entry.first_admit if entry.first_admit is not None else now
        ),
        finished_at=now,
        evictions=entry.evictions,
        first_admitted_at=entry.first_admit or 0.0,
        prefix_hit_tokens=entry.prefix_hit_tokens,
        spec_proposed=entry.spec_proposed,
        spec_accepted=entry.spec_accepted,
        status=status,
        error=error if error is not None else entry.last_error,
        retries=entry.retries,
    )


class _Slot:
    def __init__(self, idx: int, entry: _QueueEntry, max_blocks: int,
                 admit_time: float, admit_seq: int):
        self.idx = idx
        self.entry = entry
        self.text = list(entry.req.prompt) + list(entry.carried)
        self.table = np.zeros((max_blocks,), np.int32)
        self.blocks: List[int] = []
        self.pos = 0                    # positions prefilled so far
        self.generated: List[int] = []  # this admission's new tokens
        self.last_token: int = 0
        self.prefilling = True
        self.admit_time = admit_time
        self.admit_seq = admit_seq
        #: table index of a borrowed PARTIAL prefix block (copy-on-write
        #: pending: resolved before this slot's first write into it).
        self.cow_idx: Optional[int] = None

    @property
    def total_generated(self) -> int:
        return len(self.entry.carried) + len(self.generated)


class _Clock:
    """Real seconds since construction, with idle gaps skippable."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._skew = 0.0

    def now(self) -> float:
        return time.perf_counter() - self._t0 + self._skew

    def skip_to(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            self._skew += delta


class _AgreedClock:
    """The clock of model rank 0 on every model rank of a
    tensor-parallel engine: each rank runs its own scheduler over the
    same requests, and their decisions (admission, deadlines, eviction,
    block allocation) must come out the same or the ranks' collectives
    pair the wrong layers.  ``latch()`` (each tick, every rank) reads rank
    0's ``inner`` clock once and hands it to all (one object broadcast);
    ``now()`` returns the latched time."""

    def __init__(self, inner, comm):
        self.inner, self.comm = inner, comm
        self._now = 0.0
        self.latch()

    def latch(self) -> float:
        t = self.inner.now() if self.comm.rank == 0 else None
        self._now = float(self.comm.bcast_obj(t, root=0))
        return self._now

    def now(self) -> float:
        return self._now

    def adopt(self, t: float) -> None:
        """Take ``t``, rank 0's reading carried by another collective
        every rank makes (the router's per-tick gather)."""
        self._now = float(t)

    def skip_to(self, t: float) -> None:
        self.inner.skip_to(t)
        self.latch()


def steal_index(queue: Sequence[_QueueEntry], policy, now: float
                ) -> Optional[int]:
    """The entry a rebalance takes from ``queue``: the youngest arrived
    one (FIFO), or under a policy plane its weighted-fair head; None when
    there is none.  :meth:`Scheduler.steal_queued` and the router's view
    of a replica held by other ranks both pick through here."""
    if not queue:
        return None
    if policy is not None:
        return policy.steal_index([e.req for e in queue], now)
    idx = len(queue) - 1
    return None if queue[idx].req.arrival > now else idx


def next_arrival(queue: Sequence[_QueueEntry], policy, now: float
                 ) -> Optional[float]:
    """The next time an admission from ``queue`` can unblock, or None on
    an empty queue (:meth:`Scheduler.next_arrival`)."""
    if not queue:
        return None
    if policy is None:
        return queue[0].req.arrival
    cands = [e.req.arrival for e in queue if e.req.arrival > now]
    rel = policy.next_release([e.req for e in queue], now)
    if rel is not None:
        cands.append(rel)
    if not cands:
        # Everything has arrived and nobody is throttled — the old
        # contract (an already-past time: no skip, admission is gated on
        # slots, not the clock).
        return min(e.req.arrival for e in queue)
    return min(cands)


class Scheduler:
    """Admission queue + iteration-level scheduling over a
    :class:`~chainermn_tpu_torch.serving.engine.DecodeEngine`.

    Over a tensor-parallel engine of several model ranks (``engine.mesh``)
    every rank runs a scheduler over the same requests, and every
    decision must come out the same on every rank, or the ranks'
    collectives pair the wrong layers.  Each decision reads rank 0's
    clock (:class:`_AgreedClock`), and under a policy plane the drift
    latch follows rank 0's SLO verdict, broadcast on the check cadence
    (:meth:`_agreed_report`); each rank's own monitors only observe."""

    def __init__(self, engine, registry=None, clock: Optional[_Clock] = None,
                 slo=None, timeline=None, memory=None, incidents=None,
                 fault=None, deadline_ms: Optional[float] = None,
                 ledger=None, policy=None):
        self.engine = engine
        self.clock = clock or _Clock()
        mesh = getattr(engine, "mesh", None)
        #: the engine's model ranks when there are several: the group
        #: whose decisions must agree.
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        #: whether :meth:`tick` latches the clock: a router over
        #: tensor-parallel replicas hands in its own agreed clock, which
        #: it moves once per fleet tick.
        self._latches = False
        if self._mesh is not None and not isinstance(self.clock,
                                                     _AgreedClock):
            self.clock = _AgreedClock(self.clock, mesh)
            self._latches = True
        #: SLO verdicts broadcast from model rank 0 to the drift latch,
        #: and their summed wall time (ms).
        self.verdict_broadcasts = 0
        self.verdict_ms_total = 0.0
        self._queue: List[_QueueEntry] = []
        self._slots: List[Optional[_Slot]] = [None] * engine.capacity
        self._admit_seq = 0
        self.completions: List[Completion] = []
        self._iterations = 0
        #: True while non-final prefill chunks queued since the last device
        #: readback may still be running (the ``serve.mixed_ms`` tag).
        self._unsynced_prefill = False
        #: fault-injection seam: an explicit injector wins; default is
        #: the process-wide ``CMN_FAULT`` injector.
        self._fault = (
            fault if fault is not None else _faults.process_injector()
        )
        #: default deadline (ms past arrival) for requests that carry
        #: none of their own; explicit arg wins over
        #: ``CMN_SERVE_DEADLINE_MS`` (None there too = no deadline).
        self._default_deadline_ms = (
            deadline_ms if deadline_ms is not None
            else deadline_ms_from_env()
        )
        #: Multi-tenant policy plane: consulted at every admission and
        #: eviction decision.  None keeps FIFO admission bit for bit.
        #: The router passes ONE fleet plane into every replica (revivals
        #: and scale-ups included), so the fair-share clocks and rate
        #: limits are fleet-coherent, like the shared ledger.
        self.policy = policy
        if policy is not None and engine.prefix is not None:
            # The prefix trie enforces per-tenant block quotas at insert
            # time — hand it the plane's live quota view (one dict,
            # shared by reference).
            engine.prefix.quotas = policy.prefix_quotas
        enabled = _obs.enabled()
        # An explicitly passed registry always publishes; the process
        # registry rides the CMN_OBS master switch (latched here).
        if registry is None and not enabled:
            noop = _NoopInstrument()
            self._m_queue = self._m_occ = self._m_tokens = noop
            self._m_prefill = self._m_decode = self._m_mixed = noop
            self._m_px_lookups = self._m_px_hit = self._m_px_rate = noop
            self._m_px_cached = self._m_px_cow = noop
            self._m_px_evicted = self._m_mig_install = noop
            self._m_spec_prop = self._m_spec_acc = noop
            self._m_spec_rate = self._m_deadline = noop
            self._m_pf_tokens = self._m_pf_padded = noop
            reg = None
            (self._sp_tick, self._sp_admit, self._sp_prefill_round,
             self._sp_eng_prefill, self._sp_decode_prep, self._sp_eng_step,
             self._sp_emit, self._sp_planes) = (_tracing.NOOP_SPAN,) * 8
        else:
            reg = registry if registry is not None else global_registry()
            self._m_queue = reg.gauge("serve.queue_depth")
            self._m_occ = reg.gauge("serve.slot_occupancy")
            self._m_tokens = reg.counter("serve.tokens")
            self._m_prefill = reg.histogram("serve.prefill_ms",
                                            edges=DEFAULT_MS_EDGES)
            self._m_decode = reg.histogram("serve.decode_ms",
                                           edges=DEFAULT_MS_EDGES)
            self._m_mixed = reg.histogram("serve.mixed_ms",
                                          edges=DEFAULT_MS_EDGES)
            self._m_px_lookups = reg.counter("serve.prefix.lookups")
            self._m_px_hit = reg.counter("serve.prefix.hit_tokens")
            self._m_px_rate = reg.gauge("serve.prefix.hit_rate")
            self._m_px_cached = reg.gauge("serve.prefix.cached_blocks")
            self._m_px_cow = reg.counter("serve.prefix.cow_copies")
            self._m_px_evicted = reg.counter("serve.prefix.evicted_blocks")
            self._m_mig_install = reg.histogram(
                "serve.migration.install_ms", edges=DEFAULT_MS_EDGES
            )
            self._m_spec_prop = reg.counter("serve.spec.proposed")
            self._m_spec_acc = reg.counter("serve.spec.accepted")
            self._m_spec_rate = reg.gauge("serve.spec.accept_rate")
            self._m_deadline = reg.counter(
                "serve.health.deadline_cancels"
            )
            self._m_pf_tokens = reg.counter("serve.prefill.tokens")
            self._m_pf_padded = reg.counter("serve.prefill.padded_tokens")
            # The tick's phase spans (see tick()): each bound here to its
            # histogram.  The tick's and the engine calls' spans are
            # ranges only: the engine's time already lands in
            # serve.prefill_ms / decode_ms / mixed_ms.
            span = _tracing.PhaseSpan
            self._sp_tick = span("serve.tick")
            self._sp_admit = span("serve.admit", reg.histogram(
                "serve.admit_ms", edges=DEFAULT_MS_EDGES))
            self._sp_prefill_round = span(
                "serve.prefill_round", reg.histogram(
                    "serve.prefill_round_ms", edges=DEFAULT_MS_EDGES))
            self._sp_decode_prep = span(
                "serve.decode_prep", reg.histogram(
                    "serve.decode_prep_ms", edges=DEFAULT_MS_EDGES))
            self._sp_emit = span("serve.emit", reg.histogram(
                "serve.emit_ms", edges=DEFAULT_MS_EDGES))
            # Two intervals a tick with a decode step (the step's booking
            # and cadence, then the closing gauges), one without: its sum
            # a tick is the planes' time, its count is not the ticks.
            self._sp_planes = span("serve.planes", reg.histogram(
                "serve.planes_ms", edges=DEFAULT_MS_EDGES))
            self._sp_eng_prefill = span("serve.engine.prefill")
            self._sp_eng_step = span("serve.engine.step")
        #: lifetime host-side accounting (``chip_smoke.py`` reads these).
        self.prefix_lookup_tokens = 0
        self.prefix_hit_tokens = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: decode iterations run, and their summed wall time (ms).
        self.decode_iterations = 0
        self.decode_ms_total = 0.0
        #: Usage ledger: an explicit ledger always wins and
        #: ``ledger=False`` forces it off; otherwise cost attribution
        #: follows the scheduler's publishing decision, gated by
        #: ``CMN_OBS_LEDGER``.  Host-side dict arithmetic only.
        #: The router passes ONE fleet ledger into every replica, so a
        #: request moved across replicas keeps one record, and
        #: ``ledger=False`` when the fleet's decision is off.
        if ledger is False:
            self.ledger = None
        elif ledger is not None:
            self.ledger = ledger
        elif reg is not None and _oledger.ledger_enabled():
            self.ledger = _oledger.CostLedger(registry=reg)
        else:
            self.ledger = None
        #: SLO monitor: an explicit one always wins; otherwise it shares
        #: the scheduler's publishing decision.
        self.slo = slo if slo is not None else (
            SLOMonitor(registry=reg) if reg is not None else None
        )
        #: Device-memory monitor (watermarks + KV-pool occupancy /
        #: fragmentation timeline), sampled on the SLO check cadence —
        #: a handful of gauge sets off allocator counters, never a device
        #: sync.
        self.memory = memory if memory is not None else (
            MemoryMonitor(registry=reg, device=engine.device)
            if reg is not None else None
        )
        self._mem_every = (
            self.slo.check_every if self.slo is not None else 16
        )
        #: Incident manager: explicit wins; otherwise the process manager
        #: rides the process-registry publishing decision (an explicit
        #: registry's gauges live where the process rules cannot see
        #: them, so no default there).  Rules evaluate on the SLO-check
        #: cadence and at drain.
        if incidents is not None:
            self.incidents = incidents
        elif registry is None and enabled:
            self.incidents = _oincident.manager()
        else:
            self.incidents = None
        # Weakref'd sources and providers: the planes never pin a
        # dropped scheduler (and through it the engine's device pools).
        ref = weakref.ref(self)
        if self.incidents is not None:
            self.incidents.register_source(
                "serving",
                lambda: (
                    s._flight_state() if (s := ref()) is not None
                    else {"released": True}
                ),
            )
            self.incidents.register_source(
                "slo",
                lambda: (
                    {"report": s.slo.last_report}
                    if (s := ref()) is not None and s.slo is not None
                    else {"released": True}
                ),
            )
            if self.ledger is not None:
                self.incidents.register_source(
                    "usage",
                    lambda: (
                        s.ledger.usage_state()
                        if (s := ref()) is not None
                        and s.ledger is not None
                        else {"released": True}
                    ),
                )
        #: Device-plane roofline gauges: on the memory cadence, publish
        #: achieved TFLOP/s / MFU / arithmetic intensity for the engine's
        #: hot program from its cost model, the mean clean decode
        #: iteration time and the mean attended positions since the last
        #: publish.  ``CMN_OBS_DEVICE=0`` turns just this feed off.
        self._dev_enabled = (
            reg is not None
            and os.environ.get("CMN_OBS_DEVICE", "1") != "0"
        )
        self._dev_reg = reg
        self._dev_ms_sum = 0.0
        self._dev_kv_sum = 0
        self._dev_ms_n = 0
        #: Request-lifecycle timeline: explicit wins; else ride the
        #: master switch, mirroring events into the process span ring.
        if timeline is not None:
            self.timeline = timeline
        elif enabled:
            self.timeline = _tracing.RequestTimeline(
                ring=_tracing.tracer().ring
            )
        else:
            self.timeline = None
        # Flight-record provider — ungated by CMN_OBS, like the recorder
        # itself (it answers only to CMN_OBS_FLIGHT*).  Keyed, so the
        # newest scheduler replaces a finished one's state.
        _flight.register_provider(
            "serving",
            lambda: (
                s._flight_state() if (s := ref()) is not None
                else {"released": True}
            ),
        )
        # Arm the env-configured recorder: a pure serving process would
        # otherwise never install the SIGUSR1 live-snapshot handler (the
        # signal's default action kills the process).  No-op when
        # CMN_OBS_FLIGHT_DIR is unset.
        _flight.recorder()

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        """Enqueue; raises :class:`PoolExhausted` if the request could
        never fit the pool/slot geometry even running alone."""
        self.check_fit(req)
        self._queue.append(_QueueEntry(req))
        if self.ledger is not None:
            self.ledger.begin(req, self.clock.now())
        if self.timeline is not None:
            # Stamped at the request's logical availability (its arrival
            # on the scheduler clock) — the same origin the queue-wait
            # metric uses, so the queue slice and the histogram agree.
            self.timeline.record(
                "submit", t=float(req.arrival), req=req.id,
                info={"prompt_len": len(req.prompt),
                      "max_new": req.max_new_tokens},
            )

    def check_fit(self, req: Request) -> None:
        """The submit-time geometry gate, callable without enqueueing."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.id}: max_new_tokens < 1")
        eng = self.engine
        cap = eng.max_blocks * eng.block_len
        total = plen + req.max_new_tokens
        # A speculative round writes up to spec_k positions past the final
        # generated token (the verify chunk).
        probe_end = total + eng.spec_k
        # Worst-case padded prefill end over every possible (re-)admission
        # text length (carried grows to max_new - 1 under eviction): the
        # padded tail must stay inside the block table and, for learned
        # positions, inside the position table.
        worst_end = self._worst_prefill_end(plen, total - 1)
        if max(probe_end, worst_end) > cap:
            raise PoolExhausted(
                f"request {req.id}: {plen}+{req.max_new_tokens} tokens "
                f"(worst padded prefill end {worst_end}, speculative "
                f"probe end {probe_end}) exceeds the per-slot cap {cap} "
                f"(max_blocks={eng.max_blocks} x "
                f"block_len={eng.block_len})"
            )
        if blocks_for(probe_end, eng.block_len) > eng.pool.num_blocks - 1:
            raise PoolExhausted(
                f"request {req.id}: needs "
                f"{blocks_for(probe_end, eng.block_len)} blocks, pool has "
                f"{eng.pool.num_blocks - 1} allocatable"
            )
        if eng.model.pos_enc == "learned" and \
                max(probe_end, worst_end) > eng.model.max_len:
            raise ValueError(
                f"request {req.id}: worst padded prefill end {worst_end} "
                f"(speculative probe end {probe_end}) exceeds the learned "
                f"position table ({eng.model.max_len}); use a rope model "
                "or shorter requests"
            )

    # ------------------------------------------------- router integration
    def submit_entry(self, entry: _QueueEntry) -> None:
        """Re-enqueue an entry moved from a peer replica (rebalance,
        recovery, drain): carried tokens, eviction counts, retries and
        prefix/spec accounting ride along, so this engine recomputes the
        carried text through its own prefill and prefix trie and the
        request continues where it left off.  Geometry was validated at
        the original :meth:`submit`."""
        self._queue.append(entry)
        if self.ledger is not None:
            # Idempotent by id: on the fleet-shared ledger the record
            # exists already; a role-split destination with its own
            # ledger opens one here.
            self.ledger.begin(entry.req, self.clock.now())
        if self.timeline is not None:
            self.timeline.record(
                "submit", t=self.clock.now(), req=entry.req.id,
                info={"migrated": True, "carried": len(entry.carried)},
            )

    def steal_queued(self) -> Optional[_QueueEntry]:
        """Pop the YOUNGEST arrived queued entry for a less-loaded
        replica (router rebalance), or None.  The head is the oldest
        waiter (possibly an evicted re-admission) and keeps its place.
        Under a policy plane the victim is the weighted-fair head
        instead — the entry this scheduler would serve next — so a
        backlogged tenant cannot ride a rebalance past an SLO tenant."""
        idx = steal_index(self._queue, self.policy, self.clock.now())
        if idx is None:
            return None
        entry = self._queue.pop(idx)
        if self.timeline is not None:
            self.timeline.record(
                "steal", t=self.clock.now(), req=entry.req.id,
            )
        return entry

    def ready_slots(self) -> List["_Slot"]:
        """Live DECODE-READY slots (prefill finished): what a KV
        migration may ship with live blocks.  Still-prefilling slots
        and the queue travel as recompute entries
        (:meth:`harvest_entries`)."""
        return [
            s for s in self._slots if s is not None and not s.prefilling
        ]

    def harvest_entries(self) -> List[_QueueEntry]:
        """Strip everything this replica holds — live slots (oldest
        admission first), then queued entries — into recompute entries,
        for the router's fault boundary or a drain.  Live slots fold
        their generated tokens into ``carried`` exactly as an eviction,
        so a survivor's continuation is greedy-identical.  Block
        releases are host-side bookkeeping and best-effort: a corrupted
        allocator must not lose the harvest."""
        out: List[_QueueEntry] = []
        now = self.clock.now()
        for slot in sorted(
            (s for s in self._slots if s is not None),
            key=lambda s: s.admit_seq,
        ):
            try:
                self.engine.release_blocks(slot.blocks)
            except Exception:
                pass
            slot.entry.carried = (
                list(slot.entry.carried) + list(slot.generated)
            )
            slot.entry.evictions += 1
            if self.ledger is not None:
                # The occupancy until now was real: settle it, and book
                # the recompute-requeue.
                self.ledger.set_blocks(slot.entry.req.id, 0, now)
                self.ledger.book(slot.entry.req.id, "evictions", 1)
            if self.policy is not None:
                self.policy.set_blocks(
                    slot.entry.req.id, slot.entry.req.tenant, 0, now
                )
            self._slots[slot.idx] = None
            out.append(slot.entry)
            if self.timeline is not None:
                self.timeline.record(
                    "evict", t=now, req=slot.entry.req.id,
                    slot=slot.idx,
                    info={"harvested": True,
                          "carried": len(slot.entry.carried)},
                )
        out.extend(self._queue)
        self._queue = []
        return out

    def complete_terminal(self, entry: _QueueEntry, status: str,
                          error: Optional[str] = None) -> Completion:
        """Terminate ``entry`` without serving it (deadline, poisoned,
        shed): one definite Completion carrying
        whatever tokens were generated before.  The entry must already be
        off the queue and out of any slot."""
        now = self.clock.now()
        comp = terminal_completion(entry, status, now, error=error)
        if self.ledger is not None:
            comp.usage = self.ledger.finalize(entry.req.id, status, now)
        self.completions.append(comp)
        if self.timeline is not None:
            self.timeline.record(
                "retire", t=now, req=entry.req.id,
                info={"reason": status},
            )
        return comp

    # ----------------------------------------------------------- deadline
    def _deadline_s(self, req: Request) -> Optional[float]:
        # Specificity order: the request's own deadline, then its
        # tenant's policy default, then the process default.
        dl = req.deadline_ms
        if dl is None and self.policy is not None:
            dl = self.policy.deadline_ms(req.tenant)
        if dl is None:
            dl = self._default_deadline_ms
        return dl / 1e3 if dl is not None and dl > 0 else None

    def _cancel_deadlines(self) -> bool:
        """Cancel every over-deadline request — live slots (blocks
        freed) and queued entries (they would only get staler waiting).
        Terminal: ``status="deadline"``, counted by
        ``serve.health.deadline_cancels``."""
        now = self.clock.now()
        progressed = False
        for slot in [s for s in self._slots if s is not None]:
            dl = self._deadline_s(slot.entry.req)
            if dl is None or now - slot.entry.req.arrival <= dl:
                continue
            self.engine.release_blocks(slot.blocks)
            if self.policy is not None:
                self.policy.set_blocks(
                    slot.entry.req.id, slot.entry.req.tenant, 0, now
                )
            self._slots[slot.idx] = None
            slot.entry.carried = (
                list(slot.entry.carried) + list(slot.generated)
            )
            self.complete_terminal(slot.entry, "deadline")
            self._m_deadline.inc()
            progressed = True
        kept = []
        for entry in self._queue:
            dl = self._deadline_s(entry.req)
            if dl is not None and now - entry.req.arrival > dl:
                self.complete_terminal(entry, "deadline")
                self._m_deadline.inc()
                progressed = True
            else:
                kept.append(entry)
        if len(kept) != len(self._queue):
            self._queue = kept
        return progressed

    @property
    def pending(self) -> bool:
        """Work outstanding: anything queued or resident in a slot."""
        return bool(
            self._queue or any(s is not None for s in self._slots)
        )

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def slot_occupancy(self) -> float:
        """Live slots / capacity."""
        return (
            sum(s is not None for s in self._slots)
            / self.engine.capacity
        )

    @property
    def has_free_slot(self) -> bool:
        return any(s is None for s in self._slots)

    def next_arrival(self) -> Optional[float]:
        """The next time an admission can unblock, or None on an empty
        queue.  FIFO: the head entry's arrival (the head is the only
        entry whose arrival can unblock anything).  Under a policy
        plane any queued entry is pickable, so the bound is the min
        future arrival — and when every ARRIVED tenant is
        rate-throttled, the earliest throttle release (otherwise an
        idle-skip loop would jump to an already-past arrival and
        spin)."""
        return next_arrival(self._queue, self.policy, self.clock.now())

    def _worst_prefill_end(self, lo: int, hi: int) -> int:
        """Max padded prefill end over admission text lengths in
        ``[lo, hi]``.  The end is residue-monotone in the text length, so
        scanning the top ``prefill_chunk`` lengths covers every residue's
        maximum."""
        C = self.engine.prefill_ladder[-1]
        return max(
            self._padded_end(0, t)
            for t in range(max(lo, hi - C + 1), hi + 1)
        )

    def _try_admit(self) -> bool:
        if not self._queue:
            return False
        now = self.clock.now()
        if self.policy is None:
            entry = self._queue[0]
            if entry.req.arrival > now:
                return False
        else:
            # Weighted-fair pick: the first-queued entry of
            # the arrived, un-throttled tenant with the smallest
            # virtual service clock.  None = nothing arrived, or every
            # arrived tenant is rate-throttled this instant.
            qidx = self.policy.pick_index(
                [e.req for e in self._queue], now
            )
            if qidx is None:
                return False
            entry = self._queue[qidx]
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            if self.policy is None:
                return False
            # Priority preemption: a strictly higher class may evict
            # the lowest-class (youngest among equals) running slot
            # through the recompute-requeue path.  The victim re-queues
            # at the GLOBAL head, which is its tenant's head too — it
            # was admitted before anything still queued from its tenant
            # (per-tenant FIFO) — and `retries` is untouched (that
            # counter means replica deaths, not scheduling decisions).
            victim = self.policy.preempt_pick(
                [s for s in self._slots if s is not None],
                self.policy.effective_priority(entry.req),
            )
            if victim is None:
                return False
            self._evict_slot(victim, preempted=True)
            self.policy.note_preemption(victim.entry.req.tenant)
            free = [i for i, s in enumerate(self._slots) if s is None]
        eng = self.engine
        BL = eng.block_len
        text = list(entry.req.prompt) + list(entry.carried)
        # Match BEFORE the allocator gate: a hot fully-cached prompt
        # borrows nearly all its blocks from the trie, so gating on the
        # unmatched requirement would refuse exactly the admissions
        # sharing makes nearly free.  (The match only touches LRU
        # stamps; references are shared below, after admission commits.)
        matched, blocks, first = self._admission_plan(text)
        if not eng.pool.allocator.can_alloc(first):
            # The free list may be empty only because the prefix trie is
            # hoarding retired blocks — reuse potential never blocks a
            # live admission.
            if eng.prefix is None:
                return False
            need = first - eng.pool.allocator.free_blocks
            self._m_px_evicted.inc(eng.prefix.evict(need))
            # The eviction may have released blocks the match above
            # returned (they were only trie-held) — re-plan against the
            # surviving trie before trusting any block id.
            matched, blocks, first = self._admission_plan(text)
            if not eng.pool.allocator.can_alloc(first):
                return False
        # Remove by identity: a preemption above re-queued its victim
        # at index 0, so the picked entry's index may have shifted.
        self._queue.remove(entry)
        if self.policy is not None:
            self.policy.note_admission(entry.req)
        if entry.first_admit is None:
            entry.first_admit = now
            wait_ms = (now - entry.req.arrival) * 1e3
            if self.slo is not None:
                self.slo.observe("queue_wait", wait_ms)
            if self.policy is not None:
                self.policy.note_queue_wait(entry.req.tenant, wait_ms)
            if self.ledger is not None:
                # First admission only: re-admissions after an eviction
                # never re-book queue wait.
                self.ledger.admitted(entry.req.id, now)
        slot = _Slot(free[0], entry, eng.max_blocks, now,
                     self._admit_seq)
        self._admit_seq += 1
        self._slots[free[0]] = slot
        # Prefix-cache hit: map the matched blocks (borrowed references,
        # never copies) and resume prefill at the first unmatched token.
        # The match was capped at len(text) - 1 — the final prefill chunk
        # must keep at least one real token, whose logits sample the
        # first output — and then shortened until the remainder's padded
        # prefill end fits the slot/table geometry (the submit() bound
        # only covered the unmatched start).
        if eng.prefix is not None:
            if matched:
                eng.pool.allocator.share(blocks)
                for i, b in enumerate(blocks):
                    slot.table[i] = b
                slot.blocks = list(blocks)
                slot.pos = matched
                if matched % BL:
                    # The last mapped block is partially ours: this
                    # slot's first write into it copy-on-writes first.
                    slot.cow_idx = matched // BL
                entry.prefix_hit_tokens += matched
                self._m_px_hit.inc(matched)
                if self.ledger is not None:
                    # Credit/charge split: the SAVED tokens credit the
                    # hitting request; the mapped blocks' pool pressure
                    # charges it too (set_blocks below counts borrowed
                    # references — the pinner pays for occupancy).
                    self.ledger.book(
                        entry.req.id, "prefix_hit_tokens", matched
                    )
            self._m_px_lookups.inc()
            self.prefix_lookup_tokens += len(text)
            self.prefix_hit_tokens += matched
            self._m_px_rate.set(
                self.prefix_hit_tokens
                / max(self.prefix_lookup_tokens, 1)
            )
            self._m_px_cached.set(eng.prefix.cached_blocks)
        if self.ledger is not None:
            # Occupancy integration starts at admission — shared prefix
            # blocks included (each referencing slot pays full freight;
            # sharing saves COMPUTE, the pool pressure is real).
            self.ledger.set_blocks(
                entry.req.id, len(slot.blocks), now
            )
        if self.policy is not None:
            self.policy.set_blocks(
                entry.req.id, entry.req.tenant, len(slot.blocks), now
            )
        self.engine.seed_slot(free[0], entry.req.seed,
                              entry.req.temperature)
        if self.timeline is not None:
            info = {}
            if entry.evictions:
                info["readmit"] = True
            if matched:
                info["prefix_tokens"] = matched
            self.timeline.record(
                "admit", t=now, req=entry.req.id, slot=free[0],
                info=info or None,
            )
        return True

    def _ladder_size(self, remaining: int) -> int:
        """The prefill chunk geometry for ``remaining`` tokens: full-size
        chunks while more than ``prefill_chunk`` remains, then the
        smallest ladder size covering the tail.  The one definition of
        the ladder policy."""
        ladder = self.engine.prefill_ladder
        if remaining >= ladder[-1]:
            return ladder[-1]
        return next(c for c in ladder if c >= remaining)

    def _padded_end(self, start: int, text_len: int) -> int:
        """Padded prefill end for a prefill that starts at ``start``."""
        remaining = text_len - start
        if remaining <= 0:
            return start
        r = remaining % self.engine.prefill_ladder[-1]
        if r == 0:
            return text_len
        return text_len - r + self._ladder_size(r)

    def _admission_plan(self, text):
        """``(matched, blocks, first_fresh)`` for ``text`` against the
        current trie: the capped prefix match, its table blocks, and the
        fresh blocks the first prefill chunk needs net of the mapped
        prefix (+1 for the copy of a partial block)."""
        eng = self.engine
        BL = eng.block_len
        matched, blocks, n_tbl = 0, [], 0
        if eng.prefix is not None:
            blocks, matched = eng.prefix.match(text, limit=len(text) - 1)
            matched = self._cap_match(matched, len(text))
            n_tbl = (matched + BL - 1) // BL
            blocks = blocks[:n_tbl]
        end1 = min(
            matched + self._ladder_size(len(text) - matched), len(text)
        )
        first = max(
            blocks_for(end1, BL) - n_tbl + (1 if matched % BL else 0), 0
        )
        return matched, blocks, first

    def _cap_match(self, matched: int, text_len: int) -> int:
        """Largest usable prefix match <= ``matched``: the remainder's
        padded prefill end must stay inside the block table and, for
        learned positions, the position table."""
        eng = self.engine
        cap = eng.max_blocks * eng.block_len
        if eng.model.pos_enc == "learned":
            cap = min(cap, eng.model.max_len)
        while matched > 0 and self._padded_end(matched, text_len) > cap:
            matched -= 1
        return matched

    # ----------------------------------------------------------- eviction
    def _evict_slot(self, victim: _Slot, preempted: bool = False) -> None:
        """Evict ``victim`` through the recompute-requeue path — THE one
        eviction discipline, shared by pool-pressure eviction and
        priority preemption: generated tokens fold into
        ``carried``, the entry re-queues at the head (its tenant's head
        too — it predates everything still queued from its tenant), and
        the re-admission re-matches its own just-cached prefix, so the
        continuation is greedy-identical and nearly free."""
        self.engine.release_blocks(victim.blocks)
        victim.entry.carried = (
            list(victim.entry.carried) + list(victim.generated)
        )
        victim.entry.evictions += 1
        self._queue.insert(0, victim.entry)
        self._slots[victim.idx] = None
        now = self.clock.now()
        if self.ledger is not None:
            # Settle the occupancy integral at release; the re-admission
            # restarts it (recompute cost books as fresh prefill tokens).
            self.ledger.set_blocks(victim.entry.req.id, 0, now)
            self.ledger.book(victim.entry.req.id, "evictions", 1)
        if self.policy is not None:
            self.policy.set_blocks(
                victim.entry.req.id, victim.entry.req.tenant, 0, now
            )
        if self.timeline is not None:
            info = {"carried": len(victim.entry.carried)}
            if preempted:
                info["preempted"] = True
            self.timeline.record(
                "evict", t=now, req=victim.entry.req.id,
                slot=victim.idx, info=info,
            )

    def _evict_youngest(self) -> bool:
        live = [s for s in self._slots if s is not None]
        if not live:
            return False
        self._evict_slot(max(live, key=lambda s: s.admit_seq))
        return True

    def _alloc_blocks(self, slot: _Slot, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks for ``slot`` under pool pressure: drain the
        prefix cache first, then evict the youngest slot (possibly
        ``slot`` itself, in which case ``None`` is returned)."""
        eng = self.engine
        while True:
            if self._slots[slot.idx] is not slot:
                # Already evicted by a co-slot's allocation this step;
                # growing it now would orphan the new blocks.
                return None
            got = eng.alloc_blocks(n)
            if got is not None:
                return got
            if eng.prefix is not None:
                need = n - eng.pool.allocator.free_blocks
                released = eng.prefix.evict(need)
                if released:
                    self._m_px_evicted.inc(released)
                    continue
            live = [s for s in self._slots if s is not None]
            if len(live) == 1 and live[0] is slot:
                raise PoolExhausted(
                    f"request {slot.entry.req.id} cannot fit the pool "
                    "even running alone: grow num_blocks"
                )
            self._evict_youngest()

    def _alloc_for(self, slot: _Slot, n_needed: int) -> None:
        """Grow ``slot`` to ``n_needed`` blocks, evicting under pressure."""
        grew = False
        while len(slot.blocks) < n_needed:
            got = self._alloc_blocks(slot, n_needed - len(slot.blocks))
            if got is None:
                return  # the needy slot evicted itself; re-queued
            for b in got:
                slot.table[len(slot.blocks)] = b
                slot.blocks.append(b)
            grew = True
        if grew:
            if self.ledger is not None:
                # New occupancy level from here on (piecewise-constant
                # integration: the old level was settled up to now).
                self.ledger.set_blocks(
                    slot.entry.req.id, len(slot.blocks), self.clock.now()
                )
            if self.policy is not None:
                self.policy.set_blocks(
                    slot.entry.req.id, slot.entry.req.tenant,
                    len(slot.blocks), self.clock.now(),
                )

    def _resolve_cow(self, slot: _Slot) -> None:
        """Copy-on-write the slot's borrowed PARTIAL prefix block before
        its first write into it: fresh block, one whole-block copy
        (target + draft pools), borrowed reference dropped.  The cached
        original is never mutated."""
        if slot.cow_idx is None:
            return
        got = self._alloc_blocks(slot, 1)
        if got is None:
            return  # evicted itself under pressure; moot
        idx = slot.cow_idx
        src = slot.blocks[idx]
        self.engine.cow_copy(src, got[0])
        slot.table[idx] = got[0]
        slot.blocks[idx] = got[0]
        self.engine.release_blocks([src])
        slot.cow_idx = None
        self._m_px_cow.inc()
        if self.ledger is not None:
            self.ledger.book(slot.entry.req.id, "cow_copies", 1)

    # ------------------------------------------------------------ prefill
    def _prefill_round(self) -> bool:
        """One chunk for EVERY currently-prefilling slot (oldest first).

        One chunk per slot per iteration keeps the interleave bound — a
        long prompt still cannot stall running decodes for its whole
        length — while refilled slots rejoin the decode step as fast as
        the chunking allows.  Prefilling only one slot per iteration
        would serialize re-admissions: after a near-simultaneous batch of
        retirements (common when similar-length requests were admitted
        together), the decode step would run under-occupied for several
        extra iterations.
        """
        progressed = False
        # Drift-driven chunked-prefill budget (Sarathi-style):
        # while the policy's SLO latch is engaged, cap the prefill
        # tokens started per iteration.  The FIRST candidate always
        # runs (prefill can never wedge — progress is guaranteed even
        # with a cap below one chunk), and the cap is chunk-granular:
        # the final chunk that crosses it completes.
        budget = (
            self.policy.prefill_budget() if self.policy is not None
            else None
        )
        spent, first = 0, True
        for slot in sorted(
            (s for s in self._slots if s is not None and s.prefilling),
            key=lambda s: s.admit_seq,
        ):
            if self._slots[slot.idx] is not slot:
                continue  # evicted by an earlier candidate's allocation
            if budget is not None and not first and spent >= budget:
                self.policy.note_prefill_capped()
                break
            p_before = slot.pos
            progressed = self._prefill_chunk(slot) or progressed
            # The slot object survives retirement/eviction, and an
            # eviction-under-pressure bails before advancing pos — the
            # delta is exactly the tokens this chunk computed.
            spent += max(0, slot.pos - p_before)
            first = False
        return progressed

    def _prefill_chunk(self, slot: _Slot) -> bool:
        eng = self.engine
        p0 = slot.pos
        # Ladder policy (one definition: _ladder_size): full-size chunks
        # while more than prefill_chunk tokens remain, then the smallest
        # ladder geometry covering the tail — one final call with
        # minimal padded compute instead of a full prefill_chunk of
        # mostly-pad forward.
        size = self._ladder_size(len(slot.text) - p0)
        end = min(p0 + size, len(slot.text))
        self._alloc_for(slot, blocks_for(end, eng.block_len))
        if self._slots[slot.idx] is not slot:
            return True  # evicted itself under pressure; progress made
        # First write into a borrowed partial prefix block → COW now.
        self._resolve_cow(slot)
        if self._slots[slot.idx] is not slot:
            return True
        chunk = np.zeros((size,), np.int32)
        chunk[: end - p0] = slot.text[p0:end]
        last = end == len(slot.text)
        tc = self.clock.now()
        with self._sp_eng_prefill:
            t0 = time.perf_counter()
            tok = eng.prefill(
                slot.idx, chunk, p0, slot.table,
                last_idx=(end - p0 - 1) if last else -1,
            )
            dur_ms = (time.perf_counter() - t0) * 1e3
        self._m_prefill.observe(dur_ms)
        # Tokens computed, and the ladder geometry launched for them.
        self._m_pf_tokens.inc(end - p0)
        self._m_pf_padded.inc(size)
        if self.ledger is not None:
            # Tokens actually COMPUTED this chunk (pad positions are
            # geometry, not work anyone is billed for).  Eviction-
            # recompute naturally re-books here — recompute is real cost.
            self.ledger.book(
                slot.entry.req.id, "prefill_tokens", end - p0
            )
        if self.policy is not None:
            # The fair-share clock charges the SAME computed-token count
            # the ledger books — net of prefix hits by construction
            # (p0 starts past the matched prefix).
            self.policy.charge(
                slot.entry.req.tenant, "prefill_tokens", end - p0
            )
        # A final chunk's first-token readback waits for every queued
        # operation; a non-final chunk is queued only, and its compute
        # lands in the next synced op (the mixed-iteration tag).
        self._unsynced_prefill = not last
        if self.timeline is not None:
            self.timeline.record(
                "prefill", t=tc, req=slot.entry.req.id, slot=slot.idx,
                dur_ms=dur_ms,
                info={"p0": p0, "end": end, "final": last},
            )
        slot.pos = end
        if last:
            slot.prefilling = False
            # The full text is now in cache — register its full blocks
            # with the prefix trie so concurrent and future requests map
            # instead of recompute (dedupes against existing chains).
            if eng.prefix is not None:
                eng.prefix.insert(
                    slot.text,
                    slot.blocks[: len(slot.text) // eng.block_len],
                    owner=slot.entry.req.tenant,
                )
                self._m_px_cached.set(eng.prefix.cached_blocks)
            first_token_ever = not slot.entry.carried
            self._emit(slot, int(tok))
            if first_token_ever and self.slo is not None:
                self.slo.observe(
                    "ttft",
                    (self.clock.now() - slot.entry.req.arrival) * 1e3,
                )
        return True

    # ------------------------------------------------------------- decode
    def _decode_step(self) -> bool:
        """One decode step (or speculative round) for every live slot,
        in the tick's phases: the step's inputs (``serve.decode_prep``),
        the engine call (``serve.engine.step``), its bookkeeping and the
        planes' cadence (``serve.planes``), then each slot's tokens
        (``serve.emit``)."""
        with self._sp_decode_prep:
            live = [
                s for s in self._slots if s is not None and not s.prefilling
            ]
            if not live:
                return False
            S = self.engine.capacity
            k = self.engine.spec_k
            tokens = np.zeros((S,), np.int32)
            pos = np.zeros((S,), np.int32)
            tables = np.zeros((S, self.engine.max_blocks), np.int32)
            active = np.zeros((S,), bool)
            for s in live:
                # The step writes position `pos` (a speculative round writes
                # through `pos + spec_k`) — make sure those blocks exist.
                self._alloc_for(
                    s, blocks_for(s.pos + 1 + k, self.engine.block_len)
                )
            live = [
                s for s in self._slots if s is not None and not s.prefilling
            ]
            if not live:
                return True  # everything evicted itself; still progress
            for s in live:
                tokens[s.idx] = s.last_token
                pos[s.idx] = s.pos
                tables[s.idx] = s.table
                active[s.idx] = True
            mixed = self._unsynced_prefill
            self._iterations += 1
            tc = self.clock.now()
        n_accept = None
        with self._sp_eng_step:
            t0 = time.perf_counter()
            if self._fault is not None:
                # ``skew@serve_step:N:ms`` — inside the timed window, so an
                # injected stretch lands in this iteration's histogram
                # exactly like a real slowdown would.
                self._fault.hook("serve_step", count=self._iterations)
            if k:
                out, n_accept = self.engine.spec_step(
                    tokens, pos, tables, active
                )
            else:
                out = self.engine.step(tokens, pos, tables, active)
            dur_ms = (time.perf_counter() - t0) * 1e3
        with self._sp_planes:
            self._book_step(live, mixed, tc, dur_ms, pos, active)
        with self._sp_emit:
            self._emit_step(live, out, n_accept)
        return True

    def _book_step(self, live, mixed, tc, dur_ms, pos, active) -> None:
        """A decode step's histograms, timeline event and the planes'
        cadence (SLO check, policy latch, incidents, memory sample,
        device publish)."""
        # The token readback above drained the queued work: any prefill
        # work queued before this step has now been absorbed into dur_ms
        # — book the contaminated iteration separately so
        # serve.decode_ms (and the SLO token stream) stay clean.
        self._unsynced_prefill = False
        self.decode_iterations += 1
        self.decode_ms_total += dur_ms
        if mixed:
            self._m_mixed.observe(dur_ms)
        else:
            self._m_decode.observe(dur_ms)
            if self.slo is not None:
                self.slo.observe("token", dur_ms)
            if self._dev_enabled:
                self._dev_ms_sum += dur_ms
                # Positions the step attended: each live slot's context
                # including the position it writes.
                self._dev_kv_sum += int(pos[active].sum()) + len(live)
                self._dev_ms_n += 1
        if self.timeline is not None:
            self.timeline.record(
                "decode", t=tc, dur_ms=dur_ms,
                info={"reqs": [(s.idx, s.entry.req.id) for s in live],
                      "mixed": mixed},
            )
        if self.slo is not None and \
                self._iterations % self.slo.check_every == 0:
            self.slo.check()
            if self.policy is not None:
                # Feed the fresh verdict into the drift latch on the
                # check cadence — hysteresis counts CHECKS, not
                # iterations.
                self.policy.on_slo_check(self._agreed_report())
        if self.incidents is not None and \
                self._iterations % self._mem_every == 0:
            # Watch-rule evaluation on the SLO-check cadence, AFTER the
            # check refreshed the drift gauge: a breach captures its
            # bundle while the registry still shows the breach.
            self.incidents.evaluate()
        if self.memory is not None and \
                self._iterations % self._mem_every == 0:
            self.memory.sample(kv=self._kv_sample())
        if self._dev_enabled and \
                self._iterations % self._mem_every == 0:
            # capture=False: live requests are between decode steps
            # right here — the one-time cost model build runs an eager
            # step and belongs at drain, never mid-traffic.
            self._publish_device(capture=False)

    def _emit_step(self, live, out, n_accept) -> None:
        """Book and emit each live slot's tokens from a decode step or
        speculative round: ledger and policy charges, ``_emit``
        (retirement, prefix insert, block release)."""
        k = self.engine.spec_k
        for s in live:
            if self.ledger is not None:
                # Booked AFTER the step completed: a crash at serve_step
                # raises before reaching here, so no request is billed
                # for an iteration that produced nothing.
                self.ledger.book(
                    s.entry.req.id, "decode_iterations", 1
                )
            if self.policy is not None:
                self.policy.charge(
                    s.entry.req.tenant, "decode_iterations", 1
                )
            if k:
                # One speculative round: emit the accepted drafts plus
                # the target's correction/bonus, token by token — EOS or
                # the budget can retire the slot mid-round, and the
                # over-accepted tail is simply dropped (its K/V is
                # causally masked and rewritten by later steps: rollback
                # is the position not advancing, nothing is copied).
                na = int(n_accept[s.idx])
                emitted = 0
                for j in range(na + 1):
                    s.pos += 1
                    self._emit(s, int(out[s.idx, j]))
                    emitted += 1
                    if self._slots[s.idx] is not s:
                        break  # retired mid-round (EOS / budget)
                if s.entry.req.temperature <= 0:
                    # Acceptance capped at what was EMITTED: a mid-run
                    # retirement leaves the tail drafts unused — neither
                    # accepted nor rejected — while a full emission
                    # (correction/bonus included) adjudicated all k.
                    acc = min(emitted, na)
                    prop = acc if emitted <= na else k
                    entry = s.entry
                    entry.spec_proposed += prop
                    entry.spec_accepted += acc
                    self.spec_proposed += prop
                    self.spec_accepted += acc
                    self._m_spec_prop.inc(prop)
                    self._m_spec_acc.inc(acc)
                    if self.ledger is not None:
                        self.ledger.book(
                            entry.req.id, "spec_proposed", prop
                        )
                        self.ledger.book(
                            entry.req.id, "spec_accepted", acc
                        )
                    self._m_spec_rate.set(
                        self.spec_accepted / max(self.spec_proposed, 1)
                    )
            else:
                s.pos += 1
                self._emit(s, int(out[s.idx]))

    def _agreed_report(self) -> dict:
        """The SLO verdict the drift latch follows: this scheduler's own,
        or over a tensor-parallel engine model rank 0's, broadcast over
        the model ranks (one object broadcast per check; every rank
        checks at the same agreed iteration).  Each rank measures its own
        step times, and a rank whose latch followed them would budget
        prefill apart from the others."""
        report = self.slo.last_report
        if self._mesh is None:
            return report
        t0 = time.perf_counter()
        report = self._mesh.bcast_obj(
            report if self._mesh.rank == 0 else None, root=0
        )
        self.verdict_ms_total += (time.perf_counter() - t0) * 1e3
        self.verdict_broadcasts += 1
        return report

    def _emit(self, slot: _Slot, tok: int) -> None:
        """Account one generated token; retire the slot when done."""
        self._m_tokens.inc()
        slot.generated.append(tok)
        slot.last_token = tok
        req = slot.entry.req
        if self.ledger is not None:
            self.ledger.book(req.id, "tokens", 1)
        reason = None
        if req.eos_token is not None and tok == req.eos_token:
            reason = "eos"
        elif slot.total_generated >= req.max_new_tokens:
            reason = "length"
        if reason is None:
            return
        eng = self.engine
        if eng.prefix is not None:
            # Multi-turn reuse: cache the full blocks of prompt +
            # generated history (positions [0, pos) are written — the
            # last emitted token's K/V never is, and a speculative
            # round's rejected tail lies past pos).  The next turn's
            # prompt embeds this text verbatim and maps it.
            seq = slot.text + slot.generated
            eng.prefix.insert(
                seq[: slot.pos],
                slot.blocks[: slot.pos // eng.block_len],
                owner=req.tenant,
            )
            self._m_px_cached.set(eng.prefix.cached_blocks)
        eng.release_blocks(slot.blocks)
        self._slots[slot.idx] = None
        now = self.clock.now()
        if self.policy is not None:
            self.policy.set_blocks(req.id, req.tenant, 0, now)
        usage = (
            self.ledger.finalize(req.id, "ok", now)
            if self.ledger is not None else None
        )
        self.completions.append(Completion(
            id=req.id,
            tokens=list(slot.entry.carried) + list(slot.generated),
            reason=reason,
            prompt_len=len(req.prompt),
            arrival=req.arrival,
            admitted_at=slot.admit_time,
            finished_at=now,
            evictions=slot.entry.evictions,
            first_admitted_at=slot.entry.first_admit,
            prefix_hit_tokens=slot.entry.prefix_hit_tokens,
            spec_proposed=slot.entry.spec_proposed,
            spec_accepted=slot.entry.spec_accepted,
            retries=slot.entry.retries,
            usage=usage,
        ))
        if self.timeline is not None:
            self.timeline.record(
                "retire", t=now, req=req.id, slot=slot.idx,
                info={"reason": reason,
                      "tokens": slot.total_generated},
            )

    # --------------------------------------------------------------- run
    def tick(self) -> bool:
        """ONE scheduling iteration — admit while possible, one prefill
        chunk per refilling slot, one decode step — plus the queue/
        occupancy gauge refresh.  Returns whether anything progressed
        (False = idle: the queue head hasn't arrived yet, or there is no
        work at all).  :meth:`run` is a tick loop over one scheduler;
        the router interleaves ticks across replicas on a shared clock.

        Phase spans tile the tick (``serve.tick`` around it all):
        ``serve.admit`` (deadlines and admissions), ``serve.prefill_round``
        (with ``serve.engine.prefill`` around each engine call),
        ``serve.decode_prep``, ``serve.engine.step``, ``serve.emit``, and
        ``serve.planes`` (the step's bookkeeping and the planes' cadence,
        then the closing gauges: two observations of ``serve.planes_ms``
        in a tick with a decode step, so only its sum reads a tick's
        planes).  Each phase adds its time to ``<span>_ms``; under a
        recording profiler each span, ``serve.tick`` included, is also a
        range."""
        progressed = False
        with self._sp_tick:
            if self._latches:
                self.clock.latch()
            with self._sp_admit:
                if self._cancel_deadlines():
                    progressed = True
                while self._try_admit():
                    progressed = True
            with self._sp_prefill_round:
                if self._prefill_round():
                    progressed = True
            if self._decode_step():
                progressed = True
            with self._sp_planes:
                self._m_queue.set(len(self._queue))
                self._m_occ.set(self.slot_occupancy)
                if self.policy is not None and not self.policy.fleet:
                    # Standalone: this queue IS the fleet view.  Under a
                    # router (``policy.fleet``) the router publishes the
                    # fleet-wide census; per-replica publishes would
                    # thrash its gauges.
                    self.policy.publish_queue(
                        [e.req.tenant for e in self._queue]
                    )
        return progressed

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[Completion]:
        """Submit ``requests`` (optional) and drain queue + slots."""
        for r in requests or ():
            self.submit(r)
        while self.pending:
            if not self.tick():
                if not any(s is not None for s in self._slots):
                    # Idle: jump the clock to the next admission-
                    # unblocking time.  FIFO: the HEAD entry's arrival
                    # (the head is the only entry whose arrival can
                    # unblock anything; skipping to a later entry's
                    # earlier arrival would leave the loop spinning
                    # until the head's time on the real clock).  Policy:
                    # the min future arrival OR the earliest throttle
                    # release — a fully-throttled queue must advance
                    # the clock, never spin (next_arrival covers both).
                    nxt = self.next_arrival()
                    if nxt is None or nxt <= self.clock.now():
                        raise RuntimeError(
                            "scheduler made no progress on arrived work"
                        )
                    self.clock.skip_to(nxt)
                else:  # pragma: no cover - defensive
                    raise RuntimeError(
                        "scheduler made no progress with live slots"
                    )
        self.finish()
        return list(self.completions)

    def finish(self) -> None:
        """The drain epilogue: closing gauge/SLO/memory/incident/device
        publishes."""
        self._m_queue.set(0)
        self._m_occ.set(0.0)
        if self.slo is not None:
            self.slo.check()
        if self.memory is not None:
            # Closing sample: the drained pool state (prefix pins only)
            # is the baseline the leak detector measures against.
            self.memory.sample(kv=self._kv_sample())
        if self.incidents is not None:
            # Closing evaluation AFTER the final SLO check and memory
            # sample: a breach that developed after the last on-cadence
            # check (short drains, the final iterations) is judged
            # against the freshest gauges, not one-cadence-stale ones.
            self.incidents.evaluate()
        if self._dev_enabled and self._iterations >= self._mem_every:
            # Closing publish — but only for runs long enough to have
            # meant it (the check cadence): a three-iteration unit drain
            # must not pay the one-time cost model's eager step.
            self._publish_device()

    # ------------------------------------------------------- observability
    def _publish_device(self, capture: bool = True) -> None:
        """``device.*`` roofline gauges for the engine's hot program at
        the mean clean-decode iteration time and mean attended positions
        accumulated since the last publish.  Best-effort: any failure must
        never sink a serving loop.  ``capture=True`` (the drain path) may
        pay the ONE-TIME cost model build — one eager step under
        ``FlopCounterMode``, memoized process-wide per signature; the
        on-cadence path passes False so live traffic never stalls behind
        it (the first run of an engine therefore publishes its gauges at
        drain, and every later run on the cadence too, off the memoized
        model)."""
        if not self._dev_ms_n:
            return
        try:
            _odevice.watch().publish_roofline(
                self.engine.hot_program,
                self._dev_ms_sum / self._dev_ms_n,
                kv_positions=self._dev_kv_sum / self._dev_ms_n,
                registry=self._dev_reg, capture=capture,
            )
        except Exception:
            pass
        self._dev_ms_sum = 0.0
        self._dev_kv_sum = 0
        self._dev_ms_n = 0

    def _kv_sample(self) -> dict:
        """KV-pool accounting sample for the memory monitor — live
        slots' written positions vs held capacity feed the
        fragmentation number."""
        return kv_pool_sample(
            self.engine,
            [(s.pos, len(s.blocks))
             for s in self._slots if s is not None],
        )

    def _flight_state(self) -> dict:
        """The ``"serving"`` flight-record section: what this engine is
        serving *right now* — readable even while :meth:`run` is live
        (every field is a host-side scalar or small list; worst case a
        torn read shows one admission ago)."""
        slots = []
        for i, s in enumerate(self._slots):
            if s is None:
                slots.append(None)
                continue
            slots.append({
                "req": s.entry.req.id,
                "pos": int(s.pos),
                "prefilling": bool(s.prefilling),
                "generated": len(s.generated),
                "carried": len(s.entry.carried),
                "blocks": len(s.blocks),
                "retries": s.entry.retries,
            })
        by_status: Dict[str, int] = {}
        for c in self.completions:
            by_status[c.status] = by_status.get(c.status, 0) + 1
        state = {
            "iterations": self._iterations,
            "queue_depth": len(self._queue),
            "queued_requests": [e.req.id for e in self._queue[:64]],
            "in_flight_requests": [
                s["req"] for s in slots if s is not None
            ],
            "slots": slots,
            "completions": len(self.completions),
            "completions_by_status": by_status,
            "clock": round(self.clock.now(), 6),
            "engine": self.engine.stats(),
        }
        if self.engine.prefix is not None:
            state["prefix"] = {
                "hit_tokens": self.prefix_hit_tokens,
                "lookup_tokens": self.prefix_lookup_tokens,
                "cached_blocks": self.engine.prefix.cached_blocks,
            }
        if self.engine.spec_k:
            state["spec"] = {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
            }
        if self.slo is not None and self.slo.last_report:
            state["slo"] = self.slo.last_report
        if self.ledger is not None:
            state["usage"] = self.ledger.usage_state()
        if self.timeline is not None:
            state["timeline_events"] = len(self.timeline)
            state["timeline_dropped"] = self.timeline.dropped
        return state

    def export_trace(self, path: str, rank: int = 0) -> Optional[str]:
        """Write this run's request timeline as Chrome trace-event JSON
        (Perfetto-loadable); returns the path, or None when lifecycle
        tracing is off (``CMN_OBS=0`` and no explicit timeline)."""
        if self.timeline is None:
            return None
        return _tracing.write_chrome_trace(path, self.timeline.events(),
                                           rank=rank)
