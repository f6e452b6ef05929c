"""Serving-fleet failure plane: fault isolation, retry budgets, chaos.

A production fleet must survive replica death, runaway requests and
overload without dropping work.  Four mechanisms, all host-side (no
device state is trusted after a failure — recovery is recompute, the
eviction discipline):

* **Fault-isolated replicas** — the :class:`~chainermn_tpu_torch.
  serving.router.Router` wraps each replica's ``tick()`` in a fault
  boundary; an escaping host-side exception (a Python error, or an
  injected ``crash@serve_step``) marks the replica **dead** instead of
  aborting the fleet, and the router *harvests* its queued entries and
  live slots into recompute entries (carried + generated tokens kept,
  so continuations are greedy-identical) and re-dispatches them to
  survivors.  A CUDA error is not harvested: it is sticky for the whole
  process, whose replicas all share one CUDA context, so the boundary
  re-raises it (see the router).  Survivors never re-capture.

* **Retry budgets + poison quarantine** — every harvested entry's
  ``retries`` count grows with the replica it just killed.  A request
  that has killed ``retry_budget`` replicas (``CMN_SERVE_RETRY_BUDGET``,
  default 2) is the likely *cause*: it terminates as a
  :class:`~chainermn_tpu_torch.serving.scheduler.Completion` with
  ``status="poisoned"`` and the attributed error instead of being
  re-dispatched until it kills the fleet.

* **Probation (circuit breaker)** — :meth:`Router.revive_replica`
  registers a replacement engine that takes only *fresh* admissions at
  reduced dispatch weight (never recovered work, never rebalance
  steals) until ``CMN_SERVE_PROBATION_TICKS`` clean ticks pass.

* **Graceful degradation** — per-request ``deadline_ms`` (the scheduler
  cancels over-deadline slots and frees their blocks,
  ``status="deadline"``) and router load shedding: when surviving
  capacity leaves the holdback queue deeper than
  ``CMN_ROUTER_SHED_DEPTH`` arrived requests, the newest are refused
  with ``status="shed"``.  Both are terminal: a degraded request still
  terminates exactly once, with a definite status.

Everything publishes as the ``serve.health.*`` family, watched by the
critical ``replica_dead`` / ``poison_request`` default incident rules.

:class:`ChaosHarness` proves the plane: it drives a multi-replica
router under a seeded fault schedule (:func:`chaos_schedule`: the same
event list for the same seed as the JAX package's) over the sites
``crash@serve_step`` and ``skew@serve_step`` on replicas and
``drop@migrate`` on the router's re-dispatch path, revives dead
replicas after a cooldown, fires scale-ups, scale-downs and a rolling
deploy when the schedule carries them, and checks the **terminal
invariant** with :func:`verify_terminal_invariant`: every submitted
request terminates exactly once (ok, poisoned, shed or deadline).
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence

from chainermn_tpu_torch.observability.metrics import (
    NoopInstrument as _NoopInstrument,
    _env_float,
)

#: Replica lifecycle states (see :class:`FleetHealth`).  ``draining``
#: and ``removed`` are the elastic-fleet states: a draining
#: replica still ticks (its in-flight work progresses) but is fenced
#: from fresh admissions AND rebalance steals; a removed replica was
#: deregistered after a scale-down drain — its row is a tombstone so
#: historical replica indices stay stable.
STATES = ("live", "probation", "draining", "dead", "removed")


# ----------------------------------------------------------- env knobs
def retry_budget_from_env() -> int:
    """``CMN_SERVE_RETRY_BUDGET`` — how many replicas one request may
    kill before it is quarantined as poisoned (default 2)."""
    return max(1, int(_env_float("CMN_SERVE_RETRY_BUDGET", 2)))


def probation_ticks_from_env() -> int:
    """``CMN_SERVE_PROBATION_TICKS`` — clean ticks a revived replica
    serves at reduced weight before rejoining at full trust
    (default 32)."""
    return max(1, int(_env_float("CMN_SERVE_PROBATION_TICKS", 32)))


def shed_depth_from_env() -> int:
    """``CMN_ROUTER_SHED_DEPTH`` — arrived requests the router holds
    back before shedding the newest (0, the default, disables
    shedding: the holdback queue is unbounded)."""
    return max(0, int(_env_float("CMN_ROUTER_SHED_DEPTH", 0)))


def deadline_ms_from_env() -> Optional[float]:
    """``CMN_SERVE_DEADLINE_MS`` — fleet-wide default per-request
    deadline applied to requests that carry none of their own (unset or
    ``0`` = no default deadline)."""
    v = _env_float("CMN_SERVE_DEADLINE_MS", 0.0)
    return v if v > 0 else None


# ---------------------------------------------------------- FleetHealth
class FleetHealth:
    """Per-replica state machine + the ``serve.health.*`` instruments.

    Owned by the :class:`~chainermn_tpu_torch.serving.router.Router`; the
    scheduler-side member of the family (``serve.health.
    deadline_cancels``) publishes from the scheduler because deadlines
    are enforced there.

    States: ``live`` → (tick raised) → ``dead`` → (revive) →
    ``probation`` → (:data:`probation_ticks` clean ticks) → ``live``.
    A probation replica that raises goes straight back to ``dead`` —
    the circuit breaker re-opens.

    The elastic extensions: ``live``/``probation`` →
    (:meth:`start_draining`) → ``draining`` → either
    (:meth:`mark_retired` — rolling deploy) → ``dead`` → (revive) →
    ``probation``, or (:meth:`remove_replica` — scale-down) →
    ``removed``, a terminal tombstone.  Rows are dynamic:
    :meth:`add_replica` appends one for a scale-up (the router
    registers the newcomer behind probation).
    """

    def __init__(self, n: int, registry=None,
                 retry_budget: Optional[int] = None,
                 probation_ticks: Optional[int] = None):
        self.retry_budget = (
            retry_budget if retry_budget is not None
            else retry_budget_from_env()
        )
        if self.retry_budget < 1:
            raise ValueError(
                f"retry_budget must be >= 1, got {self.retry_budget}"
            )
        self.probation_ticks = (
            probation_ticks if probation_ticks is not None
            else probation_ticks_from_env()
        )
        self._state = ["live"] * n
        self._probation_left = [0] * n
        #: last attributed error per replica (None while healthy).
        self.errors: List[Optional[str]] = [None] * n
        if registry is None:
            noop = _NoopInstrument()
            self.m_dead = self.m_recovered = self.m_retries = noop
            self.m_poisoned = self.m_shed = self.m_probation = noop
            self.m_draining = noop
        else:
            self.m_dead = registry.counter("serve.health.replica_dead")
            self.m_recovered = registry.counter("serve.health.recovered")
            self.m_retries = registry.counter("serve.health.retries")
            self.m_poisoned = registry.counter("serve.health.poisoned")
            self.m_shed = registry.counter("serve.health.shed")
            self.m_probation = registry.gauge("serve.health.probation")
            self.m_draining = registry.gauge("serve.health.draining")

    # ------------------------------------------------------------ state
    @property
    def replicas(self) -> int:
        return len(self._state)

    def state(self, i: int) -> str:
        return self._state[i]

    def is_up(self, i: int) -> bool:
        """Not dead / removed: the replica's tick loop still runs (a
        DRAINING replica keeps ticking — its in-flight work must finish
        or hand off — it is merely fenced from NEW work)."""
        return self._state[i] not in ("dead", "removed")

    def can_admit(self, i: int) -> bool:
        """May take FRESH work: live or probation only — draining, dead
        and removed replicas are all fenced from admissions (and from
        rebalance steals; the router enforces both on this seam)."""
        return self._state[i] in ("live", "probation")

    def in_probation(self, i: int) -> bool:
        return self._state[i] == "probation"

    def is_draining(self, i: int) -> bool:
        return self._state[i] == "draining"

    @property
    def dead_replicas(self) -> List[int]:
        return [i for i, s in enumerate(self._state) if s == "dead"]

    # ------------------------------------------------------ transitions
    def mark_dead(self, i: int, error: str) -> None:
        self._state[i] = "dead"
        self.errors[i] = error
        self._probation_left[i] = 0
        self.m_dead.inc()
        self._gauge_probation()
        self._gauge_draining()

    def start_probation(self, i: int) -> None:
        if self._state[i] != "dead":
            raise ValueError(
                f"replica {i} is {self._state[i]!r}, not dead — only a "
                "dead replica can be revived into probation"
            )
        self._state[i] = "probation"
        self._probation_left[i] = self.probation_ticks
        self.errors[i] = None
        self._gauge_probation()

    def clean_tick(self, i: int) -> bool:
        """One tick survived without an escaping exception.  Returns
        True when this tick GRADUATED the replica out of probation."""
        if self._state[i] != "probation":
            return False
        self._probation_left[i] -= 1
        if self._probation_left[i] > 0:
            return False
        self._state[i] = "live"
        self._gauge_probation()
        return True

    # ------------------------------------- elastic transitions
    def start_draining(self, i: int) -> None:
        """Fence replica ``i`` for a scale-down / rolling-deploy drain:
        it keeps ticking (in-flight work progresses) but takes no fresh
        admissions and no rebalance steals.  Only a live or probation
        replica can start draining (a dead one's work was already
        harvested; a removed one is gone)."""
        if self._state[i] not in ("live", "probation"):
            raise ValueError(
                f"replica {i} is {self._state[i]!r} — only a live or "
                "probation replica can start draining"
            )
        self._state[i] = "draining"
        self._probation_left[i] = 0
        self._gauge_probation()
        self._gauge_draining()

    def mark_retired(self, i: int) -> None:
        """A DRAINED replica steps aside for a rolling deploy: state
        goes ``dead`` so :meth:`start_probation` (via the router's
        ``revive_replica``) can register its replacement — but this is
        an ORDERLY exit, so ``serve.health.replica_dead`` does not
        count it as a failure."""
        if self._state[i] != "draining":
            raise ValueError(
                f"replica {i} is {self._state[i]!r} — only a draining "
                "replica can retire (drain it first)"
            )
        self._state[i] = "dead"
        self.errors[i] = "retired (rolling deploy)"
        self._gauge_draining()

    def add_replica(self) -> int:
        """Scale-up: append one row (born ``dead`` — the router revives
        it straight into probation, so a newcomer earns full trust the
        same way a replacement does).  Returns the new index."""
        self._state.append("dead")
        self._probation_left.append(0)
        self.errors.append(None)
        return len(self._state) - 1

    def remove_replica(self, i: int) -> None:
        """Scale-down tombstone: a drained (or crashed-mid-drain, hence
        dead) replica leaves the fleet.  The row stays — historical
        replica indices in assignments/snapshots remain valid — but the
        state is terminal: never up, never revivable, never counted in
        the probation/draining gauges."""
        if self._state[i] not in ("draining", "dead"):
            raise ValueError(
                f"replica {i} is {self._state[i]!r} — only a draining "
                "or dead replica can be removed (drain it first)"
            )
        self._state[i] = "removed"
        self._probation_left[i] = 0
        self._gauge_probation()
        self._gauge_draining()

    def _gauge_probation(self) -> None:
        self.m_probation.set(
            sum(1 for s in self._state if s == "probation")
        )

    def _gauge_draining(self) -> None:
        self.m_draining.set(
            sum(1 for s in self._state if s == "draining")
        )

    def snapshot(self) -> List[dict]:
        return [
            {
                "replica": i,
                "state": s,
                "probation_left": self._probation_left[i],
                "error": self.errors[i],
            }
            for i, s in enumerate(self._state)
        ]


# -------------------------------------------------- terminal invariant
def verify_terminal_invariant(requests: Sequence,
                              completions: Sequence) -> dict:
    """The chaos harness's oracle: every submitted request terminates
    EXACTLY once with a definite status — zero lost, zero duplicated.

    Returns a report dict; ``report["holds"]`` is the verdict and the
    rest names the evidence (per-status counts, lost/duplicated ids).
    """
    want = {r.id for r in requests}
    seen: dict = {}
    for c in completions:
        seen[c.id] = seen.get(c.id, 0) + 1
    by_status: dict = {"ok": 0, "poisoned": 0, "shed": 0, "deadline": 0}
    for c in completions:
        by_status[c.status] = by_status.get(c.status, 0) + 1
    lost = sorted(want - set(seen))
    duplicated = sorted(i for i, n in seen.items() if n > 1)
    unknown = sorted(set(seen) - want)
    return {
        "submitted": len(want),
        "terminated": len(seen),
        "by_status": by_status,
        "lost": lost,
        "duplicated": duplicated,
        "unknown": unknown,
        "holds": not lost and not duplicated and not unknown,
    }


# -------------------------------------------------------- chaos harness
def chaos_schedule(seed: int, replicas: int, *,
                   crash_iters: Sequence[int] = (3, 9, 17, 29),
                   crash_p: float = 0.75, skew_p: float = 0.5,
                   skew_ms: int = 5, drops: int = 1,
                   scale_ups: int = 0, scale_downs: int = 0,
                   rollout_at: Optional[int] = None,
                   elastic_ticks: Sequence[int] = (2, 24)) -> dict:
    """A seeded randomized fault schedule over the existing fault sites.

    Per replica, independently: with probability ``crash_p`` a
    ``crash@serve_step:N`` (N drawn from ``crash_iters`` — the replica
    dies mid-stream at decode iteration N) and with probability
    ``skew_p`` a ``skew@serve_step:N:ms`` (fail-slow from iteration N).
    Router-level: ``drops`` one-shot ``drop@migrate`` specs — recovery
    re-dispatch frames lost on the wire, detected immediately and
    retried (see ``Router._redispatch``).

    Same seed → same schedule: the chaos battery is reproducible.
    Returns ``{"seed", "replica_faults": [spec-or-None per replica],
    "router_faults": spec-or-None}`` — spec strings in the
    ``CMN_FAULT`` grammar, buildable with
    :func:`~chainermn_tpu_torch.resilience.faults.parse_fault_spec`.

    Elastic events: ``scale_ups`` / ``scale_downs`` draw
    that many fleet-size changes at seeded ticks in ``elastic_ticks``,
    and ``rollout_at`` pins a mid-traffic rolling deploy; they land
    under an ``"elastic"`` key ([{"tick", "event"}] sorted by tick)
    the harness fires between router ticks — so drains, handoffs and
    probation graduations interleave with the crash/skew/drop faults
    above.
    """
    rng = random.Random(seed)
    per_replica: List[Optional[str]] = []
    for _ in range(replicas):
        parts = []
        if rng.random() < crash_p:
            parts.append(f"crash@serve_step:{rng.choice(crash_iters)}")
        if rng.random() < skew_p:
            parts.append(
                f"skew@serve_step:{rng.randint(1, 8)}:{skew_ms}ms"
            )
        per_replica.append(";".join(parts) or None)
    if all(p is None or "crash" not in p for p in per_replica):
        # A chaos run with zero crashes proves nothing — force one on a
        # seeded replica (still deterministic per seed).
        victim = rng.randrange(replicas)
        extra = f"crash@serve_step:{rng.choice(crash_iters)}"
        per_replica[victim] = (
            extra if per_replica[victim] is None
            else per_replica[victim] + ";" + extra
        )
    router_faults = ";".join(
        f"drop@migrate:{rng.randint(1, 3) + 2 * k}"
        for k in range(max(0, drops))
    ) or None
    out = {
        "seed": seed,
        "replica_faults": per_replica,
        "router_faults": router_faults,
    }
    events = [
        {"tick": rng.randint(*elastic_ticks), "event": "scale_up"}
        for _ in range(max(0, scale_ups))
    ] + [
        {"tick": rng.randint(*elastic_ticks), "event": "scale_down"}
        for _ in range(max(0, scale_downs))
    ]
    if rollout_at is not None:
        events.append({"tick": int(rollout_at), "event": "rollout"})
    if events:
        out["elastic"] = sorted(events, key=lambda e: e["tick"])
    return out


class ChaosHarness:
    """Drive a multi-replica router through a seeded fault schedule and
    check the terminal invariant.

    ``engine_factory`` builds one fresh
    :class:`~chainermn_tpu_torch.serving.DecodeEngine` per call — the initial
    fleet AND every revival replacement come from it (a dead replica's
    device state is never reused; its engine is garbage).  Dead
    replicas are revived ``revive_after`` ticks after death (behind the
    probation circuit breaker), up to ``max_revives`` times fleet-wide,
    so the run also exercises readmission; revived replicas run
    fault-free (the schedule belongs to the first incarnation).

    The harness is deliberately a thin loop over public Router seams —
    everything it does (``tick``/``revive_replica``/``completions``) a
    production supervisor could do the same way.

    Elastic events: a schedule carrying an ``"elastic"``
    list fires scale-ups (``Router.add_replica`` behind probation),
    scale-downs (fence → drain over the cmn-kvmig-1 path → deregister
    the coldest live replica — skipped when the fleet is at one
    admitting replica), and a mid-traffic rolling deploy
    (:class:`~chainermn_tpu_torch.serving.elastic.RollingDeploy`, driven a
    tick at a time) between router ticks, so the crash/skew/drop
    faults land DURING drains and rollouts and the terminal invariant
    is checked across every elastic transition.
    """

    def __init__(self, engine_factory: Callable[[], object],
                 replicas: int = 3, seed: int = 0, registry=None,
                 revive_after: int = 4, max_revives: int = 8,
                 schedule: Optional[dict] = None, **router_kw):
        from chainermn_tpu_torch.resilience.faults import (
            FaultInjector,
            parse_fault_spec,
        )
        from chainermn_tpu_torch.serving.router import Router

        self.engine_factory = engine_factory
        self.registry = registry
        self.schedule = (
            schedule if schedule is not None
            else chaos_schedule(seed, replicas)
        )
        faults = [
            FaultInjector(parse_fault_spec(s)) if s else None
            for s in self.schedule["replica_faults"]
        ]
        rf = self.schedule["router_faults"]
        router_fault = (
            FaultInjector(parse_fault_spec(rf)) if rf else None
        )
        self.router = Router(
            [engine_factory() for _ in range(replicas)],
            registry=registry, faults=faults, fault=router_fault,
            **router_kw,
        )
        self.revive_after = max(1, revive_after)
        self.max_revives = max_revives
        self.revived = 0
        #: ticks-until-revive countdown per currently-dead replica.
        self._revive_in: dict = {}
        #: pending elastic events, sorted by tick.
        self._elastic = sorted(
            self.schedule.get("elastic") or (),
            key=lambda e: e["tick"],
        )
        #: what actually fired (replica picked, skips) — the report's
        #: ``elastic`` evidence.
        self.elastic_log: List[dict] = []
        self.rollout = None
        self._tick_no = 0

    def _poll_revivals(self) -> None:
        health = self.router.health
        for i in health.dead_replicas:
            if i not in self._revive_in:
                self._revive_in[i] = self.revive_after
        for i in list(self._revive_in):
            if health.state(i) == "dead":
                self._revive_in[i] -= 1
                if self._revive_in[i] <= 0 and \
                        self.revived < self.max_revives:
                    self.router.revive_replica(i, self.engine_factory())
                    self.revived += 1
                    del self._revive_in[i]
            else:
                # Revived elsewhere, or deregistered (scale-down of a
                # replica that crashed mid-drain) — stop counting.
                del self._revive_in[i]

    # ------------------------------------------- elastic events
    def _coldest_live(self) -> Optional[int]:
        """The scale-down victim: the least-loaded full-trust live
        admitting replica — but never the last one that can admit (a
        fleet of zero admitting replicas deadlocks by construction)."""
        router = self.router
        admitting = [
            i for i in router._admitting if router.health.can_admit(i)
        ]
        cands = [
            i for i in admitting if router.health.state(i) == "live"
        ]
        if not cands or len(admitting) <= 1:
            return None
        return min(cands, key=router._load)

    def _fire_elastic(self) -> None:
        from chainermn_tpu_torch.serving.elastic import RollingDeploy

        while self._elastic and self._elastic[0]["tick"] <= self._tick_no:
            ev = dict(self._elastic.pop(0))
            if ev["event"] == "scale_up":
                ev["replica"] = self.router.add_replica(
                    self.engine_factory()
                )
            elif ev["event"] == "scale_down":
                victim = self._coldest_live()
                if victim is None:
                    ev["skipped"] = "fleet at minimum"
                else:
                    ev["replica"] = victim
                    ev["drain"] = self.router.drain_replica(victim)
                    self.router.deregister_replica(victim)
                    self._revive_in.pop(victim, None)
            elif ev["event"] == "rollout":
                if self.rollout is None:
                    self.rollout = RollingDeploy(
                        self.router, self.engine_factory,
                        registry=self.registry,
                    )
                    ev["replicas"] = list(self.rollout.pending)
                else:  # pragma: no cover - one rollout per schedule
                    ev["skipped"] = "rollout already running"
            self.elastic_log.append(ev)
        if self.rollout is not None:
            self.rollout.tick()

    def run(self, requests: Sequence) -> dict:
        """Submit ``requests``, drain the fleet under the schedule, and
        return the invariant report (plus harness/run bookkeeping).
        Raises if the fleet deadlocks — a chaos run must always
        terminate."""
        router = self.router
        for r in requests:
            router.submit(r)
        stall = 0
        while router.pending:
            progressed = router.tick()
            self._tick_no += 1
            self._fire_elastic()
            self._poll_revivals()
            if progressed:
                stall = 0
                continue
            now = router.clock.now()
            nxt = [
                t for t in (
                    [r.arrival for r in router.queued_requests()[:1]]
                    + [
                        s.next_arrival()
                        for i, s in enumerate(router.schedulers)
                        if s is not None and router.health.is_up(i)
                    ]
                )
                if t is not None and t > now
            ]
            if nxt:
                router.clock.skip_to(min(nxt))
                stall = 0
            elif self._revive_in and self.revived < self.max_revives:
                # Everything that could serve the remaining work is
                # dead and a revival countdown is running — idle ticks
                # count it down (this IS progress toward recovery).
                stall = 0
            elif self._elastic or (
                self.rollout is not None
                and not self.rollout.done and not self.rollout.paused
            ):
                # A pending elastic event (a scale-up may be the only
                # path to capacity) or an in-flight rollout (probation
                # graduation rides clean ticks) — idle ticks progress it.
                stall = 0
            else:
                stall += 1
                if stall > 3:
                    raise RuntimeError(
                        "chaos fleet deadlocked: no progress, no "
                        "arrivals, no revivals pending "
                        f"(health={router.health.snapshot()})"
                    )
        # Let an in-flight rollout finish on an idle fleet (probation
        # graduation needs clean ticks; bounded by the rollout's own
        # stall watchdog + this guard).
        guard = 0
        while self.rollout is not None and not self.rollout.done \
                and not self.rollout.paused:
            router.tick()
            self._tick_no += 1
            self._fire_elastic()
            guard += 1
            if guard > 4 * router.health.probation_ticks * max(
                    1, router.health.replicas):
                raise RuntimeError(
                    "rollout failed to converge on an idle fleet "
                    f"(state={router.health.snapshot()})"
                )
        router.finish()
        report = verify_terminal_invariant(requests, router.completions)
        report["schedule"] = self.schedule
        report["revived"] = self.revived
        report["health"] = router.health.snapshot()
        if self.elastic_log:
            report["elastic"] = self.elastic_log
        if self.rollout is not None:
            report["rollout"] = {
                "replaced": list(self.rollout.replaced),
                "paused": self.rollout.paused,
                "done": self.rollout.done,
            }
        return report
