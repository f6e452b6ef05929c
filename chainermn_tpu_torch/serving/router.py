"""Multi-replica serving router: N engines behind one queue.

The :class:`Router` puts N in-process replicas behind **least-loaded
dispatch**, so the fleet serves one request stream.  Each replica is a
full :class:`~chainermn_tpu_torch.serving.Scheduler` over its own
:class:`~chainermn_tpu_torch.serving.DecodeEngine` (its own paged pool,
allocator, prefix trie and captured decode step) plus its own metrics
registry and span ring; the replicas may share one model's weights on
one card.  The router is host-side glue:

* **Dispatch** reads each replica's live gauges — ``serve.slot_occupancy``
  and ``serve.queue_depth`` for load, ``mem.kv.occupancy`` as the
  tie-break — plus a count of its own dispatches since the gauges last
  refreshed, so a burst between ticks still spreads.
* **Backpressure** is per-replica admission: a replica whose queue is at
  ``max_queue`` (``CMN_ROUTER_MAX_QUEUE``, default ``2 × capacity``)
  takes no new work; when every replica is saturated the request waits
  in the router's holdback queue (``serve.router.queue_depth``, the
  ``router_backlog`` incident rule's signal).  Nothing is dropped.
* **Rebalance** (``CMN_ROUTER_REBALANCE``, default on): when one replica
  has arrived work queued behind full slots while another idles, the
  router steals a queued entry for the idle one — carried tokens and
  accounting ride along (:meth:`Scheduler.steal_queued` /
  :meth:`Scheduler.submit_entry`).  The moved request's lifecycle spans
  land on both replicas' span rings, and :meth:`Router.export_fleet_trace`
  merges the rings (one replica = one pid) into one Perfetto trace.
* **Failure plane** (:mod:`~chainermn_tpu_torch.serving.recovery`): a
  fault boundary per replica tick, retry budgets, probation, deadlines
  and load shedding; and the elastic seams (add / drain / retire /
  revive / deregister) that :mod:`~chainermn_tpu_torch.serving.elastic`
  drives.  An engine that leaves the fleet (dead, retired, deregistered)
  releases its device state (:meth:`DecodeEngine.release`).

Clock: all replicas share ONE scheduler clock, so cross-replica
timestamps (and the merged trace) are coherent and idle gaps skip once
for the whole fleet.  Replicas tick one after another on the host, so on
one card an added replica buys slots, not parallel compute.

**Tensor-parallel replicas** (``Router(engine, comm=world)``): N
replicas of M model ranks each, one process per rank, N × M ranks in
all.  Replica ``i`` is the group of ranks ``[i·M, (i+1)·M)`` that
:func:`~chainermn_tpu_torch.serving.sharding.serving_mesh` cuts, and each
rank passes its own engine (``DecodeEngine(model, mesh=serving_mesh(M,
world))``) and the world communicator.  Every rank runs the same router
and comes to the same dispatch, holdback, steal and idle-skip decisions;
a rank steps only its own replica's scheduler, and sees every other one
through a :class:`_ReplicaView`:

* after the replicas tick, one object all-gather carries each replica's
  summary from model rank 0 of its group: its gauges, live slots, queue
  (whole entries, so a steal moves the entry itself; no device buffer
  moves), the tick's completions and, under a policy plane, the tape of
  the tick's plane calls (:class:`~chainermn_tpu_torch.serving.policy.
  PlaneTape`), replayed in replica order on every rank;
* the router's clock is world rank 0's: its reading rides the same
  gather, and every rank's rebalance and next tick read it (an idle
  skip latches it anew with one object broadcast);
* :meth:`Router.run` returns the same completions on every rank.

A replica's tick sees the fleet plane as the tick found it plus its own
calls (the one-process router ticks replicas one after another, each
seeing the calls of those before it).  Not over tensor-parallel
replicas: the failure plane (a replica's error propagates), the elastic
seams, roles other than ``"mixed"``, the fleet ledger and the merged
fleet trace.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from chainermn_tpu_torch.observability.metrics import (
    MetricsRegistry,
    NoopInstrument as _NoopInstrument,
)
from chainermn_tpu_torch.serving.kv_pool import PoolExhausted
from chainermn_tpu_torch.serving.scheduler import (
    Completion,
    Request,
    Scheduler,
    _AgreedClock,
    _Clock,
    _QueueEntry,
    next_arrival,
    steal_index,
    terminal_completion,
)

#: the replica gauges the router's decisions read.
_GAUGES = ("serve.slot_occupancy", "serve.queue_depth", "mem.kv.occupancy")


def device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` reports a CUDA error.  Such an error is sticky
    for the whole process, and every replica of an in-process fleet
    shares its CUDA context, so no survivor could serve a harvest: the
    fault boundary re-raises it instead of harvesting the replica."""
    err = getattr(torch, "AcceleratorError", None)
    if err is not None and isinstance(exc, err):
        return True
    return isinstance(exc, RuntimeError) and \
        str(exc).startswith("CUDA error")


class _ReplicaCapacity:
    """The part of a replica's engine the router reads from a view."""

    def __init__(self, capacity: int):
        self.capacity = capacity

    def stats(self) -> None:
        return None


class _ReplicaView:
    """A replica of a tensor-parallel fleet held by other ranks, as this
    rank sees it: the host books its group's model rank 0 sent in the
    last gather (:meth:`apply`), kept current through this tick's
    dispatches and steals, which every rank makes alike.  It answers the
    :class:`Scheduler` calls the router makes, and picks a steal and the
    next arrival through the scheduler's own functions."""

    def __init__(self, capacity: int, fit, clock, policy):
        self.engine = _ReplicaCapacity(capacity)
        self.check_fit = fit
        self.clock, self.policy = clock, policy
        self.registry = MetricsRegistry()
        self.completions: List[Completion] = []
        self._queue: List[_QueueEntry] = []
        self._live = 0

    def apply(self, summary: dict) -> None:
        self._queue = summary["queue"]
        self._live = summary["live"]
        self.completions.extend(summary["done"])
        for name, v in summary["gauges"].items():
            if v is not None:
                self.registry.gauge(name).set(v)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def slot_occupancy(self) -> float:
        return self._live / self.engine.capacity

    @property
    def has_free_slot(self) -> bool:
        return self._live < self.engine.capacity

    @property
    def pending(self) -> bool:
        return bool(self._queue) or self._live > 0

    def submit(self, req: Request) -> None:
        self.check_fit(req)
        self._queue.append(_QueueEntry(req))

    def submit_entry(self, entry: _QueueEntry) -> None:
        self._queue.append(entry)

    def steal_queued(self) -> Optional[_QueueEntry]:
        idx = steal_index(self._queue, self.policy, self.clock.now())
        return None if idx is None else self._queue.pop(idx)

    def next_arrival(self) -> Optional[float]:
        return next_arrival(self._queue, self.policy, self.clock.now())

    def finish(self) -> None:
        pass


class Router:
    """Least-loaded dispatch over N scheduler replicas.

    The fault boundary differs from the JAX package's in one way: it
    harvests a replica whose tick raised a host-side exception (an
    injected ``crash@serve_step``, a Python error), but re-raises a CUDA
    error (:func:`device_fault`: ``torch.AcceleratorError``, or a
    ``RuntimeError`` whose message starts with ``CUDA error``).  On the
    card such an error poisons the CUDA context that every replica of
    the process shares, so harvesting onto a "survivor" would hide a
    dead device; the run fails instead.

    Args:
      engines: one :class:`~chainermn_tpu_torch.serving.DecodeEngine` per
        replica.
        Replicas are assumed geometry-homogeneous: any replica's
        :meth:`Scheduler.check_fit` gate speaks for all.
      registry: where the ``serve.router.*`` family publishes.  Same
        contract as the Scheduler: an explicit registry always
        publishes; ``None`` rides the ``CMN_OBS`` master switch on the
        ambient global registry.  (Each REPLICA always gets its own
        private :class:`MetricsRegistry` regardless — the router's
        dispatch signals must exist even with observability off, and
        per-replica instruments must not collide in one registry.)
      clock: injectable shared clock (tests/benchmarks).
      max_queue: per-replica admission cap (requests queued at one
        replica).  Default ``CMN_ROUTER_MAX_QUEUE``, else
        ``2 × capacity``.
      rebalance: steal queued work from a blocked replica for an idle
        one.  Default ``CMN_ROUTER_REBALANCE`` (on).
      roles: optional per-replica role (``"mixed"`` | ``"prefill"`` |
        ``"decode"``, default all mixed) — the disaggregated fleet's
        dispatch rule: fresh requests go only to admitting
        replicas (mixed/prefill), and rebalance steals only between
        them; ``"decode"`` replicas take migrated slots through the
        :mod:`~chainermn_tpu_torch.serving.disagg` plane, never the router
        queue.  Resolve a launch-wide spec with
        :func:`~chainermn_tpu_torch.serving.disagg.roles_from_env`
        (``CMN_DISAGG_ROLES``).
      comm: the world communicator of a fleet of tensor-parallel
        replicas (module docstring): ``engines`` is then this rank's own
        engine (or a one-element list), whose ``mesh`` is its replica's
        group of ``M`` consecutive ranks, and the fleet has
        ``comm.size / M`` replicas.  Every rank constructs the router
        and calls the same methods in the same order.
    """

    def __init__(self, engines, registry=None,
                 clock: Optional[_Clock] = None,
                 max_queue: Optional[int] = None,
                 rebalance: Optional[bool] = None,
                 roles: Optional[Sequence[str]] = None,
                 faults: Optional[Sequence] = None,
                 fault=None,
                 retry_budget: Optional[int] = None,
                 probation_ticks: Optional[int] = None,
                 shed_depth: Optional[int] = None,
                 ledger=None, policy=None, comm=None):
        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability.metrics import (
            DEFAULT_MS_EDGES,
            registry as global_registry,
        )
        from chainermn_tpu_torch.observability.tracing import (
            RequestTimeline,
            SpanRing,
        )
        from chainermn_tpu_torch.resilience import faults as _faults
        from chainermn_tpu_torch.serving.recovery import (
            FleetHealth,
            shed_depth_from_env,
        )

        self.comm = comm
        if comm is not None:
            engines = self._tensor_parallel_fleet(
                engines, roles, faults, ledger
            )
        engines = list(engines)
        if not engines:
            raise ValueError("router needs at least one engine")
        if roles is None:
            roles = ["mixed"] * len(engines)
        roles = [str(r) for r in roles]
        if len(roles) != len(engines):
            raise ValueError(
                f"roles ({len(roles)}) must match engines ({len(engines)})"
            )
        from chainermn_tpu_torch.serving.disagg import ROLES as _ROLES

        for r in roles:
            if r not in _ROLES:
                raise ValueError(f"unknown role {r!r} (one of {_ROLES})")
        if all(r == "decode" for r in roles):
            raise ValueError(
                "every replica is decode-role — nobody can admit; a "
                "disaggregated fleet needs >= 1 mixed/prefill replica"
            )
        self.roles = roles
        #: replica indices fresh requests may be dispatched to.
        self._admitting = [
            i for i, r in enumerate(roles) if r != "decode"
        ]
        self.clock = clock or _Clock()
        if comm is not None:
            self.clock = _AgreedClock(self.clock, comm)
        #: per-replica span rings: each replica is one "rank" in the
        #: merged fleet trace (the timeline mirrors every lifecycle
        #: event as a ``serve.<kind>`` span carrying ``req=<id>``).
        self.rings = [SpanRing(4096) for _ in engines]
        self.replica_registries = [MetricsRegistry() for _ in engines]
        if faults is None:
            faults = [None] * len(engines)
        faults = list(faults)
        if len(faults) != len(engines):
            raise ValueError(
                f"faults ({len(faults)}) must match engines "
                f"({len(engines)})"
            )
        #: Usage ledger: ONE fleet ledger shared by every
        #: replica (revivals included), so a request migrated or
        #: harvested across replicas keeps one record and per-tenant
        #: sums stay fleet-coherent.  Explicit wins; otherwise
        #: construction follows the router's own publishing latch
        #: (explicit registry always, ``None`` rides the ``CMN_OBS``
        #: master switch) gated by ``CMN_OBS_LEDGER``.  The resolved
        #: decision is FORCED onto every replica (``False`` = off) —
        #: a replica must never self-build a private ledger the fleet
        #: books would then miss.
        from chainermn_tpu_torch.observability import ledger as _oledger

        if comm is not None:
            self.ledger = None
        elif ledger is not None:
            self.ledger = ledger
        elif (registry is not None or _obs.enabled()) \
                and _oledger.ledger_enabled():
            self.ledger = _oledger.CostLedger(registry=registry)
        else:
            self.ledger = None
        #: Multi-tenant policy plane: ONE fleet plane shared
        #: by the router's own dispatch pick and every replica (revivals
        #: and scale-ups included), so the fair-share clocks, rate
        #: limits and prefix quotas are fleet-coherent — exactly the
        #: shared-ledger discipline.  ``fleet`` flips so replicas defer
        #: the per-tenant queue-depth census to the router's fleet-wide
        #: one.  None keeps FIFO dispatch bit-for-bit.
        self.policy = policy
        if policy is not None:
            policy.fleet = True
        #: over tensor-parallel replicas, the plane this rank's replica
        #: ticks against (recorded, then replayed fleet-wide).
        self._tape = None
        if comm is not None and policy is not None:
            from chainermn_tpu_torch.serving.policy import PlaneTape

            self._tape = PlaneTape(policy)
        self.schedulers: List[Scheduler] = [
            Scheduler(
                eng, registry=reg, clock=self.clock,
                timeline=RequestTimeline(ring=ring), fault=fi,
                ledger=(
                    self.ledger if self.ledger is not None else False
                ),
                policy=self._tape or policy,
            ) if eng is not None else None
            for eng, reg, ring, fi in zip(
                engines, self.replica_registries, self.rings, faults
            )
        ]
        if comm is not None:
            self._attach_views()
        if max_queue is None:
            env = os.environ.get("CMN_ROUTER_MAX_QUEUE", "")
            max_queue = (
                int(env) if env.isdigit() and int(env) > 0
                else 2 * max(e.capacity for e in engines if e is not None)
            )
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        self.rebalance = (
            rebalance if rebalance is not None
            else os.environ.get("CMN_ROUTER_REBALANCE", "1") != "0"
        )
        #: router holdback queue (FIFO by submission; the traffic
        #: generators submit in arrival order, same as the Scheduler).
        self._queue: List[Request] = []
        #: request id -> replica indices it was dispatched to, in order
        #: (len > 1 = migrated) — the dispatch audit trail tests and
        #: benchmarks read.
        self.assignments: Dict[int, List[int]] = {}
        #: dispatches since each replica's gauges last refreshed — the
        #: burst corrector added onto the gauge-read load score.
        self._since_gauge = [0] * len(engines)
        #: per-replica occupancy accumulation (benchmark's spread
        #: headline: mean occupancy per replica over the run).
        self._occ_sum = [0.0] * len(engines)
        self._occ_n = 0
        #: host-side dispatch latencies, ms (the histogram's raw feed;
        #: kept for the benchmark's percentile report).
        self.dispatch_ms: List[float] = []
        self._ticks = 0
        enabled = _obs.enabled()
        if registry is None and not enabled:
            noop = _NoopInstrument()
            self._m_disp = self._m_migr = self._m_bp = noop
            self._m_rq = self._m_spread = self._m_disp_ms = noop
            health_reg = None
        else:
            reg = registry if registry is not None else global_registry()
            self._m_disp = reg.counter("serve.router.dispatched")
            self._m_migr = reg.counter("serve.router.migrated")
            self._m_bp = reg.counter("serve.router.backpressure")
            self._m_rq = reg.gauge("serve.router.queue_depth")
            self._m_spread = reg.gauge("serve.router.occupancy_spread")
            self._m_disp_ms = reg.histogram(
                "serve.router.dispatch_ms", edges=DEFAULT_MS_EDGES
            )
            health_reg = reg
        #: The failure plane: per-replica live/probation/dead
        #: state + the serve.health.* instruments; the fault boundary in
        #: :meth:`tick` drives it.
        self.health = FleetHealth(
            len(engines), registry=health_reg,
            retry_budget=retry_budget, probation_ticks=probation_ticks,
        )
        #: router-level fault hook — the recovery re-dispatch path is a
        #: ``migrate`` fault site (``drop@migrate`` loses one re-dispatch
        #: "frame"; the entry stays router-held, is detected immediately
        #: and retried — the chaos harness's wire-loss arm).
        self._fault = (
            fault if fault is not None else _faults.process_injector()
        )
        self.shed_depth = (
            shed_depth if shed_depth is not None else shed_depth_from_env()
        )
        #: terminal completions the ROUTER produced (poisoned requests
        #: quarantined at the fault boundary, shed overflow) — replicas
        #: never saw these finish, so they live here and merge in
        #: :attr:`completions`.
        self._router_completions: List[Completion] = []
        #: harvested entries waiting for a survivor (only while NO live
        #: full-trust replica can take them; drained first each tick).
        self._recovered: List = []
        #: Incident plane: same resolution as the Scheduler — the
        #: process manager rides the ambient-registry publishing
        #: decision (an explicit registry's gauges live where the
        #: process rules cannot see them); evaluated on a tick cadence
        #: + once at finish, so a sustained ``serve.router.queue_depth``
        #: backlog trips the ``router_backlog`` default rule.
        if registry is None and enabled:
            from chainermn_tpu_torch.observability import incident as _oincident

            self.incidents = _oincident.manager()
        else:
            self.incidents = None
        self._inc_every = 16

    # ------------------------------------------- tensor-parallel replicas
    def _tensor_parallel_fleet(self, engines, roles, faults, ledger):
        """Check this rank's engine against the world communicator and
        return the fleet's engine list: this rank's engine at its
        replica's index, None at the others'.  Every replica's geometry
        must be this one's (one all-gather)."""
        from chainermn_tpu_torch.serving.sharding import mesh_model_size

        if isinstance(engines, (list, tuple)):
            if len(engines) != 1:
                raise ValueError(
                    "over tensor-parallel replicas each rank passes its "
                    f"own engine, got {len(engines)}")
            engines = engines[0]
        eng, comm = engines, self.comm
        M = mesh_model_size(eng.mesh)
        if comm.size % M or (M > 1 and eng.mesh.rank != comm.rank % M):
            raise ValueError(
                f"the engine's mesh ({M} ranks, model rank "
                f"{getattr(eng.mesh, 'rank', 0)}) is not the group "
                f"serving_mesh({M}, comm) cuts for rank {comm.rank} of "
                f"{comm.size}")
        for what, given in (("roles", roles and set(roles) != {"mixed"}),
                            ("faults", faults), ("a ledger", ledger)):
            if given:
                raise ValueError(
                    f"{what} over tensor-parallel replicas is not ported: "
                    "the failure plane, the roles and the fleet ledger "
                    "are the one-process fleet's")
        geometry = (M, eng.capacity, eng.max_blocks, eng.block_len,
                    eng.pool.num_blocks, tuple(eng.prefill_ladder),
                    eng.spec_k)
        if len(set(comm.allgather_obj(geometry))) != 1:
            raise ValueError(
                "tensor-parallel replicas must share one geometry (model "
                "ranks, capacity, blocks, ladder, spec_k): any replica's "
                "check_fit speaks for all")
        #: this rank's replica, its model rank, and ranks per replica.
        self._local, self._model_rank, self._M = (
            comm.rank // M, comm.rank % M, M
        )
        #: the router's per-tick gathers: count and summed ms (waits for
        #: the slowest replica's tick included).
        self.exchanges, self.exchange_ms_total = 0, 0.0
        self._sent = 0
        out = [None] * (comm.size // M)
        out[self._local] = eng
        return out

    def _attach_views(self) -> None:
        local = self.schedulers[self._local]
        for j, s in enumerate(self.schedulers):
            if s is None:
                view = _ReplicaView(local.engine.capacity, local.check_fit,
                                    self.clock, self.policy)
                self.schedulers[j] = view
                self.replica_registries[j] = view.registry
                self.rings[j] = None

    def _tick_tensor_parallel(self) -> bool:
        """Tick this rank's replica, then exchange every replica's
        summary (one all-gather over the world) and bring the views, the
        fleet plane and the health rows up to date alike on every rank.
        Returns whether any replica progressed."""
        s = self.schedulers[self._local]
        if self._tape is not None:
            self._tape.begin()
        ticked = s.tick()
        ops = self._tape.end() if self._tape is not None else None
        mine = None
        if self._model_rank == 0:
            mine = dict(
                progressed=ticked, queue=list(s._queue), ops=ops,
                live=sum(x is not None for x in s._slots),
                done=s.completions[self._sent:],
                gauges={n: self._gauge(self._local, n) for n in _GAUGES},
                now=self.clock.inner.now() if self.comm.rank == 0 else None,
            )
            self._sent = len(s.completions)
        t0 = time.perf_counter()
        summaries = self.comm.allgather_obj(mine)[::self._M]
        self.exchange_ms_total += (time.perf_counter() - t0) * 1e3
        self.exchanges += 1
        self.clock.adopt(summaries[0]["now"])
        progressed = False
        for j, summary in enumerate(summaries):
            progressed = progressed or summary["progressed"]
            if j != self._local:
                self.schedulers[j].apply(summary)
            if summary["ops"]:
                self.policy.replay(summary["ops"])
            self.health.clean_tick(j)
        return progressed

    def _one_process(self, what: str) -> None:
        if self.comm is not None:
            raise NotImplementedError(
                f"{what} over tensor-parallel replicas is not ported")

    # ---------------------------------------------------------- dispatch
    @property
    def replicas(self) -> int:
        return len(self.schedulers)

    def submit(self, req: Request) -> None:
        """Accept a request into the router queue.  Geometry-validated
        per replica: a replica whose pool cannot EVER hold the request
        (heterogeneous fleets — ``PoolExhausted`` from its
        ``check_fit``) is that replica's problem, not grounds for
        refusing a request another replica can serve; the submit
        raises only when NO admitting replica fits it."""
        err = None
        for i in self._admitting:
            try:
                self.schedulers[i].check_fit(req)
                self._queue.append(req)
                if self.ledger is not None:
                    # The record opens when the fleet ACCEPTS the
                    # request — a later shed/poison terminal still
                    # finalizes it (conservation counts holdback too).
                    self.ledger.begin(req, self.clock.now())
                return
            except PoolExhausted as e:
                err = e
        raise err if err is not None else RuntimeError(
            "router has no admitting replica"
        )

    def _fits(self, i: int, req: Request) -> bool:
        try:
            self.schedulers[i].check_fit(req)
            return True
        except PoolExhausted:
            return False

    def _gauge(self, i: int, name: str):
        inst = self.replica_registries[i].peek(name)
        v = inst.value if inst is not None else None
        return None if v is None else float(v)

    def _load(self, i: int) -> float:
        """Replica load score off the LIVE gauges: occupied slots plus
        queued requests, per slot of capacity, with the KV-pool
        occupancy gauge as the fractional tie-break (two equally busy
        replicas — prefer the one with more free pool).  Gauges refresh
        once per tick, so the router adds its own dispatches since the
        last refresh on top; before a replica's FIRST tick (cold start
        — gauges never published) the scheduler's host-side truth
        stands in, and already includes every dispatch."""
        s = self.schedulers[i]
        cap = s.engine.capacity
        occ = self._gauge(i, "serve.slot_occupancy")
        qd = self._gauge(i, "serve.queue_depth")
        if occ is None or qd is None:
            occ, qd = s.slot_occupancy, float(s.queue_depth)
        else:
            qd += self._since_gauge[i]
        kv = self._gauge(i, "mem.kv.occupancy") or 0.0
        return (occ * cap + qd) / cap + 0.1 * kv

    def _admit_candidates(self) -> List[int]:
        """Admitting-role replicas that may take FRESH work: live or
        probation only — dead replicas take nothing, and a DRAINING
        replica (mid-scale-down / mid-rollout) is fenced even though
        its tick loop still runs."""
        return [i for i in self._admitting if self.health.can_admit(i)]

    def _ranked_replicas(self, probation_ok: bool = True) -> List[int]:
        """Dispatch candidates (admitting, up, with admission headroom)
        ranked least-loaded first.  Probation replicas carry a flat
        load penalty — the reduced-weight half of the circuit breaker:
        they receive fresh work only when every full-trust replica is
        busier — and are excluded entirely for recovered work
        (``probation_ok=False``)."""
        ranked = []
        for i in self._admit_candidates():
            s = self.schedulers[i]
            probation = self.health.in_probation(i)
            if probation and not probation_ok:
                continue
            # queue_depth is LIVE (submit appends immediately), so it
            # already counts this tick's dispatches — _since_gauge is
            # only for correcting the stale gauges in _load.
            if s.queue_depth >= self.max_queue:
                continue
            ranked.append((self._load(i) + (1.0 if probation else 0.0), i))
        ranked.sort()
        return [i for _, i in ranked]

    def _dispatch(self) -> bool:
        """Move every ARRIVED router-queue request to the least-loaded
        replica, FIFO; stop at the first backpressure refusal (order
        preservation) or future arrival.  A replica-side
        ``PoolExhausted`` is that replica's problem: it is excluded for
        this pick and the next candidate tried."""
        progressed = self._drain_recovered()
        now = self.clock.now()
        while self._queue:
            if self.policy is None:
                if self._queue[0].arrival > now:
                    break
                qi = 0
            else:
                # Weighted-fair dispatch: the holdback pick
                # runs on the same fleet plane the replicas consult, so
                # the order work LEAVES the router already honors the
                # fair-share clocks (per-tenant FIFO within a tenant).
                # None = nothing arrived, or every arrived tenant is
                # rate-throttled this instant — both wait here.
                qi = self.policy.pick_index(self._queue, now)
                if qi is None:
                    break
            t0 = time.perf_counter()
            ranked = self._ranked_replicas()
            if not ranked:
                # Fleet-wide backpressure: the request WAITS here (and
                # is never lost) — count the deferral, surface depth.
                self._m_bp.inc()
                break
            req = self._queue[qi]
            placed = None
            misfit = None
            for i in ranked:
                try:
                    self.schedulers[i].submit(req)
                except PoolExhausted as e:
                    misfit = e
                    continue
                placed = i
                break
            if placed is None:
                # Every candidate's POOL GEOMETRY refuses this request
                # (check_fit is occupancy-blind).  If a currently-
                # saturated replica could fit it, wait for headroom
                # (backpressure); if nobody up can EVER fit it, the
                # request is terminal — quarantine, never a router
                # abort and never an infinite holdback.
                if any(
                    self._fits(i, req)
                    for i in self._admit_candidates() if i not in ranked
                ):
                    self._m_bp.inc()
                    break
                self._queue.pop(qi)
                self._terminal_request(
                    req, "poisoned",
                    error=f"PoolExhausted: {misfit}",
                )
                self.health.m_poisoned.inc()
                if self.incidents is not None:
                    self.incidents.evaluate()
                progressed = True
                continue
            self._queue.pop(qi)
            self.assignments.setdefault(req.id, []).append(placed)
            self._since_gauge[placed] += 1
            ms = (time.perf_counter() - t0) * 1e3
            self.dispatch_ms.append(ms)
            self._m_disp.inc()
            self._m_disp_ms.observe(ms)
            progressed = True
        if self._shed_overflow(now):
            progressed = True
        self._m_rq.set(len(self._queue))
        return progressed

    def _shed_overflow(self, now: float) -> bool:
        """Load shedding (``CMN_ROUTER_SHED_DEPTH``): when surviving
        capacity leaves more than ``shed_depth`` ARRIVED requests in
        the holdback queue, refuse the newest-arrived
        (``status="shed"``) — bounded queues instead of unbounded
        latency collapse.  0 (the default) disables shedding; future
        arrivals never count (they are not waiting yet).

        Per-tenant depths: a policy tenant with its own
        ``shed_depth`` gets the same newest-first discipline applied to
        ITS arrived backlog alone — a bursty tenant's overflow sheds at
        its cap without the fleet cap ever engaging, and without
        another tenant's requests counting against it."""
        progressed = False
        if self.policy is not None:
            for tenant in sorted({r.tenant for r in self._queue}):
                depth = self.policy.shed_depth(tenant)
                if not depth:
                    continue
                t_arrived = [
                    r for r in self._queue
                    if r.tenant == tenant and r.arrival <= now
                ]
                if len(t_arrived) <= depth:
                    continue
                victims = sorted(
                    t_arrived, key=lambda r: r.arrival
                )[depth:]
                shed_ids = {id(v) for v in victims}
                self._queue = [
                    r for r in self._queue if id(r) not in shed_ids
                ]
                for req in sorted(victims, key=lambda r: -r.arrival):
                    self._terminal_request(
                        req, "shed",
                        error=f"tenant {tenant!r} holdback depth > "
                              f"{depth}",
                    )
                    self.health.m_shed.inc()
                progressed = True
        if not self.shed_depth:
            return progressed
        arrived = [r for r in self._queue if r.arrival <= now]
        if len(arrived) <= self.shed_depth:
            return progressed
        victims = sorted(arrived, key=lambda r: r.arrival)[
            self.shed_depth:
        ]
        shed_ids = {id(v) for v in victims}
        self._queue = [r for r in self._queue if id(r) not in shed_ids]
        for req in sorted(victims, key=lambda r: -r.arrival):
            self._terminal_request(
                req, "shed",
                error=f"holdback depth > {self.shed_depth} with "
                      "surviving capacity saturated",
            )
            self.health.m_shed.inc()
        return True

    def _terminal_request(self, req: Request, status: str,
                          error: Optional[str] = None) -> None:
        """A never-admitted router-queue request terminates here (shed,
        or unservable-anywhere): one definite Completion."""
        now = self.clock.now()
        comp = terminal_completion(
            _QueueEntry(req=req), status, now, error=error,
        )
        if self.ledger is not None:
            comp.usage = self.ledger.finalize(req.id, status, now)
        self._router_completions.append(comp)

    def _rebalance(self) -> bool:
        """Steal arrived queued work from a replica whose slots are all
        busy for a replica with a free slot and an empty queue."""
        if not self.rebalance:
            return False
        # Role discipline holds under rebalance too: a decode replica's
        # free slots belong to the migration plane, and its queue (if a
        # drain ever filled one) is recompute work another decode
        # replica could not prefill faster anyway.  Health discipline:
        # only full-trust LIVE replicas steal (a probation replica gets
        # fresh admissions only — the circuit breaker), dead replicas
        # neither donate (harvested already) nor receive, and a
        # DRAINING replica sits out both sides — the drain is the one
        # mover of its work.
        idle = [
            i for i in self._admitting
            if self.health.state(i) == "live"
            and self.schedulers[i].has_free_slot
            and self.schedulers[i].queue_depth == 0
        ]
        if not idle:
            return False
        donors = sorted(
            (
                i for i in self._admitting
                if self.health.can_admit(i)
                and self.schedulers[i].queue_depth > 0
                and not self.schedulers[i].has_free_slot
            ),
            key=lambda i: -self.schedulers[i].queue_depth,
        )
        moved = False
        for dst in idle:
            for src in donors:
                if src == dst:
                    continue
                entry = self.schedulers[src].steal_queued()
                if entry is None:
                    continue
                try:
                    self.schedulers[dst].check_fit(entry.req)
                except PoolExhausted:
                    # The idle replica's pool cannot hold this entry
                    # (heterogeneous fleet) — hand it straight back
                    # (same queue end it was stolen from).
                    self.schedulers[src].submit_entry(entry)
                    continue
                self.schedulers[dst].submit_entry(entry)
                self.assignments.setdefault(
                    entry.req.id, []
                ).append(dst)
                self._m_migr.inc()
                moved = True
                break
        return moved

    # ---------------------------------------------------------- recovery
    def _on_replica_death(self, i: int, exc: BaseException) -> None:
        """The fault boundary: replica ``i``'s tick escaped.
        Mark it dead, harvest its queued entries AND live slots into
        recompute entries (carried + generated tokens preserved — the
        eviction-requeue discipline, so survivor continuations are
        greedy-identical), and re-dispatch each to a survivor — unless
        the entry has now killed ``retry_budget`` replicas, in which
        case it is the likely cause and is quarantined as a poisoned
        Completion with the attributed error."""
        err = f"{type(exc).__name__}: {exc}"
        self.health.mark_dead(i, err)
        try:
            entries = self.schedulers[i].harvest_entries()
        except Exception:  # pragma: no cover - defensive harvest
            entries = []
        # The dead engine's device state is garbage: free its graphs and
        # pools now, not when a revival replaces the scheduler.
        self._release_engine(i)
        # Requests this replica FINISHED before dying are history, not
        # casualties — move them to the router's books so a revival
        # (which replaces the scheduler) cannot lose them.
        self._router_completions.extend(self.schedulers[i].completions)
        self.schedulers[i].completions = []
        for entry in entries:
            entry.retries += 1
            entry.last_error = err
            self.health.m_retries.inc()
            if self.ledger is not None:
                # The harvest already settled block occupancy and booked
                # the eviction; the DEATH itself books here.
                self.ledger.book(entry.req.id, "retries", 1)
            if entry.retries >= self.health.retry_budget:
                self._quarantine(entry, err)
            else:
                self._redispatch(entry)
        # Evaluate the incident rules NOW, while the breach is fresh:
        # the critical `replica_dead` (and `poison_request`, when a
        # quarantine happened) default rules capture their bundles at
        # the moment the fleet lost the replica.
        if self.incidents is not None:
            self.incidents.evaluate()

    def _quarantine(self, entry, err: str) -> None:
        now = self.clock.now()
        comp = terminal_completion(entry, "poisoned", now, error=err)
        if self.ledger is not None:
            comp.usage = self.ledger.finalize(
                entry.req.id, "poisoned", now
            )
        self._router_completions.append(comp)
        self.health.m_poisoned.inc()

    def _redispatch(self, entry) -> bool:
        """Re-dispatch one harvested entry to a surviving FULL-TRUST
        replica (probation replicas take only fresh admissions).  This
        is a ``migrate`` fault site: ``drop@migrate`` loses one
        re-dispatch frame on the wire — detected immediately (the
        entry never left the router) and retried on the next path.
        With no survivor able to take it, the entry parks in
        ``_recovered`` and re-tries every dispatch round — recovered
        work is never dropped."""
        candidates = [
            i for i in self._ranked_replicas(probation_ok=False)
            if self._fits(i, entry.req)
        ] or [
            # Every full-trust survivor is at its admission cap:
            # recovered work outranks the cap (it already waited once),
            # so fall back to the least-loaded fitting survivor.
            i for i in sorted(
                (j for j in self._admit_candidates()
                 if not self.health.in_probation(j)),
                key=self._load,
            )
            if self._fits(i, entry.req)
        ]
        for i in candidates:
            if self._fault is not None and \
                    self._fault.hook("migrate") == "drop":
                self.health.m_retries.inc()
                continue
            self.schedulers[i].submit_entry(entry)
            self.assignments.setdefault(entry.req.id, []).append(i)
            self._since_gauge[i] += 1
            self.health.m_recovered.inc()
            return True
        up = self._admit_candidates()
        if up and not any(self._fits(i, entry.req) for i in up):
            # Replicas are UP but none's POOL GEOMETRY can ever hold
            # this entry (a heterogeneous fleet lost the only replica
            # that could) — terminal, the same verdict the fresh-
            # dispatch path reaches: never an infinite park.  With NO
            # up replica at all the entry parks instead: a pending
            # revival is the recovery path, and ``run()`` raises loudly
            # if nobody ever drives one.
            self._quarantine(
                entry,
                "PoolExhausted on every surviving replica"
                + (f" (after {entry.last_error})"
                   if entry.last_error else ""),
            )
            if self.incidents is not None:
                self.incidents.evaluate()
            return True
        self._recovered.append(entry)
        return False

    def _drain_recovered(self) -> bool:
        """Retry parked recovered entries (their survivor may have
        appeared — a revival graduated, or capacity freed)."""
        if not self._recovered:
            return False
        parked, self._recovered = self._recovered, []
        progressed = False
        for entry in parked:
            if self._redispatch(entry):
                progressed = True
        return progressed

    def revive_replica(self, i: int, engine, fault=None) -> None:
        """Re-register a replacement engine for dead replica ``i``
        behind the probation circuit breaker: fresh Scheduler, fresh
        metrics registry, fresh span ring (the old incarnation's books
        are closed — its harvest already moved every request it held).
        The revived replica receives only fresh admissions at reduced
        dispatch weight until ``CMN_SERVE_PROBATION_TICKS`` clean ticks
        pass, so a flapping replica cannot thrash the fleet."""
        self._one_process("revive_replica")
        from chainermn_tpu_torch.observability.metrics import MetricsRegistry
        from chainermn_tpu_torch.observability.tracing import (
            RequestTimeline,
            SpanRing,
        )

        if self.health.state(i) != "dead":
            raise ValueError(
                f"replica {i} is {self.health.state(i)!r} — only a dead "
                "replica can be revived"
            )
        ring = SpanRing(4096)
        reg = MetricsRegistry()
        self.rings[i] = ring
        self.replica_registries[i] = reg
        self.schedulers[i] = Scheduler(
            engine, registry=reg, clock=self.clock,
            timeline=RequestTimeline(ring=ring), fault=fault,
            ledger=self.ledger if self.ledger is not None else False,
            policy=self.policy,
        )
        self._since_gauge[i] = 0
        self.health.start_probation(i)

    # ------------------------------------------------- elastic
    def add_replica(self, engine, role: str = "mixed",
                    fault=None) -> int:
        """Scale-up: register a NEW replica behind the probation
        circuit breaker — fresh Scheduler, registry and span ring,
        sharing the fleet clock and ledger, earning full trust through
        ``CMN_SERVE_PROBATION_TICKS`` clean ticks exactly like a
        revival replacement (a cold newcomer must not immediately soak
        up recovered work or rebalance steals).  Returns the new
        replica index."""
        self._one_process("add_replica")
        from chainermn_tpu_torch.observability.metrics import MetricsRegistry
        from chainermn_tpu_torch.observability.tracing import (
            RequestTimeline,
            SpanRing,
        )
        from chainermn_tpu_torch.serving.disagg import ROLES as _ROLES

        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r} (one of {_ROLES})")
        i = len(self.schedulers)
        ring = SpanRing(4096)
        reg = MetricsRegistry()
        self.rings.append(ring)
        self.replica_registries.append(reg)
        self.roles.append(role)
        self.schedulers.append(Scheduler(
            engine, registry=reg, clock=self.clock,
            timeline=RequestTimeline(ring=ring), fault=fault,
            ledger=self.ledger if self.ledger is not None else False,
            policy=self.policy,
        ))
        self._since_gauge.append(0)
        self._occ_sum.append(0.0)
        self.health.add_replica()
        self.health.start_probation(i)
        if role != "decode":
            self._admitting.append(i)
        return i

    def drain_replica(self, i: int) -> dict:
        """Scale-down / rolling-deploy drain: fence replica ``i``
        (DRAINING — no fresh admissions, no rebalance steals), hand its
        decode-ready slots to the least-loaded full-trust survivor over
        the cmn-kvmig-1 path (``pack_slots``/``install_payload`` — live
        KV moves through the one-variant programs, the survivor never
        recompiles), and re-dispatch its still-prefilling slots and
        queued entries as recompute entries (carried tokens ride
        along, the eviction-requeue discipline).  Nothing is lost; the
        replica ends empty and fenced, ready for
        :meth:`deregister_replica` (scale-down) or
        :meth:`retire_replica` + :meth:`revive_replica` (rollout).

        The slot handoff is a ``migrate`` fault site: ``drop@migrate``
        loses the frame BEFORE any detach, so the slots stay
        source-held and fall back to the recompute path — detected
        immediately, zero loss.  A replica that crashes mid-drain
        downgrades to the fault boundary (:meth:`_on_replica_death`):
        marked dead, work harvested — the terminal invariant holds
        either way."""
        self._one_process("drain_replica")
        from chainermn_tpu_torch.serving import disagg as _disagg

        if not self.health.is_draining(i):
            self.health.start_draining(i)
        s = self.schedulers[i]
        summary = {
            "replica": i, "slots_migrated": 0, "entries_requeued": 0,
            "dropped_frames": 0,
        }
        try:
            ready = s.ready_slots()
            survivors = [
                j for j in self._admitting
                if j != i and self.health.state(j) == "live"
            ]
            if ready and survivors:
                if self._fault is not None and \
                        self._fault.hook("migrate") == "drop":
                    # Handoff frame lost on the wire — detected here
                    # (nothing detached yet); the slots fall back to
                    # the recompute path below.
                    summary["dropped_frames"] += 1
                    self.health.m_retries.inc()
                else:
                    dest = min(survivors, key=self._load)
                    installed, queued = _disagg.handoff_slots(
                        s, self.schedulers[dest], ready
                    )
                    for slot in ready:
                        self.assignments.setdefault(
                            slot.entry.req.id, []
                        ).append(dest)
                        self._m_migr.inc()
                    self._since_gauge[dest] += installed
                    summary["slots_migrated"] = installed
                    summary["entries_requeued"] += queued
                    summary["dest"] = dest
        except Exception as exc:
            if device_fault(exc):
                raise
            self._on_replica_death(i, exc)
            summary["crashed"] = f"{type(exc).__name__}: {exc}"
            return summary
        for entry in s.harvest_entries():
            summary["entries_requeued"] += 1
            self._redispatch(entry)
        s.finish()
        return summary

    def retire_replica(self, i: int) -> None:
        """Rolling-deploy seam: a DRAINED replica steps aside (state
        ``dead``, orderly — not a counted failure) so
        :meth:`revive_replica` can register the new-version engine
        behind probation.  Its finished completions move to the
        router's books first — ``revive_replica`` replaces the
        Scheduler wholesale, and the old incarnation's terminals must
        survive that."""
        self._one_process("retire_replica")
        s = self.schedulers[i]
        if s is not None and s.pending:
            raise ValueError(
                f"replica {i} still holds work — drain it first"
            )
        if s is not None:
            self._router_completions.extend(s.completions)
            s.completions = []
        self.health.mark_retired(i)
        self._release_engine(i)

    def deregister_replica(self, i: int) -> None:
        """Scale-down final step: remove a DRAINED (or crashed
        mid-drain, hence dead-and-harvested) replica and fully release
        its state — scheduler (whose weakref'd flight/incident
        providers die with it), span ring, metrics registry, and the
        FleetHealth row (tombstoned ``removed`` so historical indices
        stay stable).  Its finished completions move to the router's
        books first, so :attr:`completions` and the fleet ledger's
        conservation hold across the removal."""
        self._one_process("deregister_replica")
        st = self.health.state(i)
        if st not in ("draining", "dead"):
            raise ValueError(
                f"replica {i} is {st!r} — only a draining or dead "
                "replica can be deregistered (drain it first)"
            )
        s = self.schedulers[i]
        if s is not None and s.pending:
            raise ValueError(
                f"replica {i} still holds work — drain it first"
            )
        if s is not None:
            self._router_completions.extend(s.completions)
            s.completions = []
        self.health.remove_replica(i)
        self._release_engine(i)
        self.schedulers[i] = None
        self.rings[i] = None
        self.replica_registries[i] = None
        self._admitting = [j for j in self._admitting if j != i]

    def _release_engine(self, i: int) -> None:
        """Free replica ``i``'s device state — its captured graphs, their
        memory pools and its KV pools — when its engine leaves the fleet
        (dead, retired, deregistered).  Its host books stay readable."""
        if self.schedulers[i] is not None:
            self.schedulers[i].engine.release()

    def queued_requests(self) -> List[Request]:
        """The router holdback queue (oldest first) — chaos-harness /
        dashboard introspection."""
        return list(self._queue)

    # --------------------------------------------------------------- run
    def tick(self) -> bool:
        """One fleet iteration: dispatch arrived requests, tick every
        UP replica inside the fault boundary, rebalance, refresh router
        gauges.  Returns whether anything progressed anywhere.

        The fault boundary: a host-side exception escaping a replica's
        tick — a real defect or an injected ``crash@serve_step`` — marks
        THAT replica dead and recovers its work onto survivors
        (:meth:`_on_replica_death`) instead of aborting the fleet; a
        CUDA error (:func:`device_fault`) propagates.  A clean tick
        feeds the probation counter of a revived replica.

        Over tensor-parallel replicas (``comm=``) each rank ticks its own
        replica, with no fault boundary (an error propagates), then the
        replicas' summaries are exchanged (:meth:`_tick_tensor_parallel`)."""
        progressed = self._dispatch()
        if self.comm is not None:
            progressed = self._tick_tensor_parallel() or progressed
        for i, s in enumerate(self.schedulers if self.comm is None else ()):
            if s is None or not self.health.is_up(i):
                continue
            try:
                if s.tick():
                    progressed = True
            except Exception as exc:
                if device_fault(exc):
                    raise
                self._on_replica_death(i, exc)
                progressed = True
            else:
                was_probation = self.health.in_probation(i)
                self.health.clean_tick(i)
                if was_probation and self._recovered:
                    # The countdown toward graduating this replica IS
                    # progress toward serving the parked recovered work
                    # (which only full-trust replicas may take) — an
                    # otherwise-idle fleet must keep ticking it down
                    # rather than declare deadlock.
                    progressed = True
        if self._rebalance():
            progressed = True
        self._since_gauge = [0] * len(self.schedulers)
        occs = [
            self._occupancy(i) for i in range(len(self.schedulers))
        ]
        self._m_spread.set(max(occs) - min(occs))
        for i, o in enumerate(occs):
            self._occ_sum[i] += o
        self._occ_n += 1
        self._ticks += 1
        if self.policy is not None:
            # Fleet-wide per-tenant queue census: holdback + parked
            # recovered work + every UP replica's queue — the
            # ``serve.tenant.<t>.queue_depth`` gauges the starvation
            # rule and dashboards read.
            census = [r.tenant for r in self._queue]
            census += [e.req.tenant for e in self._recovered]
            for j, s in enumerate(self.schedulers):
                if s is not None and self.health.is_up(j):
                    census += [e.req.tenant for e in s._queue]
            self.policy.publish_queue(census)
        if self.incidents is not None and \
                self._ticks % self._inc_every == 0:
            self.incidents.evaluate()
        return progressed

    def _occupancy(self, i: int) -> float:
        """Replica occupancy off the live gauge, falling back to the
        scheduler's host-side truth (a freshly revived replica's
        registry has not published yet; a dead one's gauges are stale
        — its harvested slots are empty, which is what the host truth
        reads)."""
        if self.schedulers[i] is None or not self.health.is_up(i):
            return 0.0
        o = self._gauge(i, "serve.slot_occupancy")
        return o if o is not None else self.schedulers[i].slot_occupancy

    @property
    def pending(self) -> bool:
        return bool(
            self._queue or self._recovered or any(
                s.pending for i, s in enumerate(self.schedulers)
                if s is not None and self.health.is_up(i)
            )
        )

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[Completion]:
        """Submit ``requests`` (optional) and drain the whole fleet.
        Returns every replica's completions, merged (sorted by finish
        time)."""
        for r in requests or ():
            self.submit(r)
        while self.pending:
            if not self.tick():
                if self.policy is None:
                    nxt = [r.arrival for r in self._queue[:1]]
                else:
                    # Policy dispatch can pick ANY queued entry, and a
                    # fully-throttled holdback unblocks at the earliest
                    # rate release, not an arrival — cover both, with
                    # the min arrival as the no-candidate fallback
                    # (parity with the FIFO head).
                    now = self.clock.now()
                    nxt = [
                        r.arrival for r in self._queue
                        if r.arrival > now
                    ]
                    rel = self.policy.next_release(self._queue, now)
                    if rel is not None:
                        nxt.append(rel)
                    if not nxt and self._queue:
                        nxt = [min(r.arrival for r in self._queue)]
                nxt += [
                    t for t in (
                        s.next_arrival()
                        for i, s in enumerate(self.schedulers)
                        if s is not None and self.health.is_up(i)
                    ) if t is not None
                ]
                if not nxt:  # pragma: no cover - defensive
                    raise RuntimeError(
                        "router made no progress with no future "
                        "arrivals (dead replicas un-revived? drive the "
                        "loop yourself — or via recovery.ChaosHarness "
                        "— to revive mid-run)"
                    )
                self.clock.skip_to(min(nxt))
        self.finish()
        return self.completions

    def finish(self) -> None:
        """Close every UP replica's books + the router's own gauges
        (a dead replica's books closed at harvest — its process would
        be gone in a real fleet)."""
        for i, s in enumerate(self.schedulers):
            if s is not None and self.health.is_up(i):
                s.finish()
        self._m_rq.set(len(self._queue))
        self._m_spread.set(0.0)
        if self.incidents is not None:
            self.incidents.evaluate()

    # ------------------------------------------------------ introspection
    @property
    def completions(self) -> List[Completion]:
        """Every replica's completions plus the router's own terminal
        verdicts (poisoned / shed), merged."""
        out: List[Completion] = list(self._router_completions)
        for s in self.schedulers:
            if s is not None:
                out.extend(s.completions)
        return sorted(out, key=lambda c: (c.finished_at, c.id))

    def replica_stats(self) -> List[dict]:
        """Per-replica host-side summary (benchmarks/dashboards).  A
        deregistered replica keeps its row (historical dispatch counts
        stay attributable) but its live state is gone."""
        out = []
        for i, s in enumerate(self.schedulers):
            out.append({
                "replica": i,
                "role": self.roles[i],
                "state": self.health.state(i),
                "dispatched": sum(
                    1 for reps in self.assignments.values()
                    if reps and reps[0] == i
                ),
                "served": sum(
                    1 for reps in self.assignments.values()
                    if reps and reps[-1] == i
                ),
                "completions": len(s.completions) if s is not None else 0,
                "occupancy_mean": (
                    self._occ_sum[i] / self._occ_n if self._occ_n else 0.0
                ),
                "engine": s.engine.stats() if s is not None else None,
            })
        return out

    def export_fleet_trace(self, path: str) -> dict:
        """Merge the per-replica span rings through the fleet merge
        (:mod:`~chainermn_tpu_torch.observability.fleet`) — one replica
        = one "rank" (pid) — and write ONE
        Perfetto-loadable trace.  A migrated request's ``serve.*``
        spans (each carrying ``req=<id>`` detail) appear under every
        replica that touched it.  Replicas share one process and one
        monotonic clock, so no offset correction is needed (offsets
        default to zero).  Returns the merge summary (with ``path``)."""
        self._one_process("export_fleet_trace")
        from chainermn_tpu_torch.observability import fleet as _fleet
        from chainermn_tpu_torch.observability import tracing as _tracing

        dumps = [
            {
                "rank": i,
                "spans": ring.snapshot(),
                "spans_total": ring.total,
                "epoch_wall": _tracing.EPOCH_WALL,
                "epoch_perf": _tracing.EPOCH_PERF,
            }
            for i, ring in enumerate(self.rings)
            if ring is not None  # deregistered replicas released theirs
        ]
        merged = _fleet.merge_fleet_trace(dumps)
        merged["summary"]["path"] = _fleet.write_fleet_trace(
            path, merged["payload"]
        )
        return merged["summary"]
