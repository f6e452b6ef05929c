"""Multi-tenant SLO policy plane: weighted fair queuing, priority
preemption, drift-driven chunked-prefill budgeting.

Without it admission is one FIFO queue, so a single bursty tenant can
starve a latency-sensitive one.  One :class:`PolicyPlane` is the
*policy* layer the :class:`~chainermn_tpu_torch.serving.scheduler.
Scheduler` and :class:`~chainermn_tpu_torch.serving.router.Router`
consult at every admission, eviction and steal decision.  Four
mechanisms, all host-side (the decode step's one capture holds with
policy ON):

* **Weighted fair admission (VTC).**  Every tenant carries a virtual
  service clock — the *virtual token counter* of Sheng et al. 2023 —
  charged from the SAME integer cost seams the usage ledger books:
  prefill tokens net of prefix hits (``_prefill_chunk`` computes from
  the first unmatched token, so a cached prefix is free here exactly as
  it is on the bill), decode iterations, and KV block-microseconds
  (piecewise-constant integration mirroring
  :meth:`~chainermn_tpu_torch.observability.ledger.CostLedger.set_blocks`).
  Admission picks the queued tenant with the smallest
  ``charged / weight`` clock (per-tenant FIFO within), so fairness is
  over real cost, not request count.  A tenant going active after idling
  is LIFTED to the busiest floor (min clock over currently-queued
  tenants) — idle time banks no credit.

* **Priority classes with preemption.**  A queued entry whose effective
  class (``Request.priority``, else its tenant's default) strictly
  outranks a running slot's may evict the lowest-class youngest slot
  through the existing recompute-requeue path: generated tokens fold
  into ``carried``, the entry re-queues at its tenant's head, and the
  re-admission re-matches its own just-cached prefix — preemption is
  nearly free, the continuation greedy-identical.  ``entry.retries`` is
  never touched (that counter means replica deaths).

* **Drift-driven chunked-prefill budgeting.**  When the live SLO check
  reports a breach (rolling p95 left the envelope — the
  ``serve.slo.p95_drift`` signal) for ``drift_hysteresis`` consecutive
  checks, the plane latches a Sarathi-style cap: at most
  ``prefill_cap`` prefill tokens admitted per scheduler iteration
  (chunk-granular; the first chunk of a round always runs so prefill
  can never wedge).  The latch releases after the same number of clean
  checks.

* **Per-tenant isolation knobs.**  Token rate limits over the policy
  clock (a tenant past ``rate_limit`` cost-units/s is simply not
  eligible for admission until the clock catches up — terminals stay
  exactly-once: a throttled request still completes, or terminates
  through the existing ``deadline``/``shed`` paths), prefix-cache block
  quotas (enforced inside
  :meth:`~chainermn_tpu_torch.serving.prefix_cache.PrefixCache.insert` /
  eviction — a tenant over quota evicts its OWN least-recently-used
  leaves, never another tenant's), and per-tenant deadline / shed
  defaults that terminate as the existing ``status="deadline"`` /
  ``"shed"`` outcomes (the shed depth caps the router's holdback).

Starvation watch: the plane publishes ``serve.policy.starved_tenant``
(the index of a tenant whose rolling queue-wait p95 exceeds
``CMN_POLICY_STARVATION_MS``; −1 = nobody), which the
``tenant_starvation`` default incident rule turns into a keyed incident
per starved tenant.

Share ONE plane fleet-wide: the Router passes its ``policy=`` into
every replica (revivals and scale-ups included), so the service clocks
and rate limits are fleet-coherent, like the shared ledger; the router
picks its holdback dispatch and its rebalance steals on the same plane
and publishes the fleet-wide queue census.

Over tensor-parallel replicas, one process per model rank, each rank
holds its own copy of the plane and steps only its own replica: the
replica's scheduler ticks against a :meth:`PolicyPlane.fork` of the
plane as the fleet tick found it, through a :class:`PlaneTape` that
records every call; the tapes travel in the router's per-tick gather and
:meth:`PolicyPlane.replay` applies them in replica order on every rank,
so every rank's plane is the same after every tick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

from chainermn_tpu_torch.observability.metrics import (
    NoopInstrument as _NoopInstrument,
    _env_float,
)

#: cost-dimension weights: one unit per prefill token; decode iterations
#: and block-microseconds are scaled by the env-tunable weights below.
COST_DIMS = ("prefill_tokens", "decode_iterations", "block_us")


# ----------------------------------------------------------- env knobs
def prefill_cap_from_env() -> int:
    """``CMN_POLICY_PREFILL_CAP`` — prefill tokens admitted per
    scheduler iteration while the drift latch is engaged (default
    32)."""
    return max(1, int(_env_float("CMN_POLICY_PREFILL_CAP", 32)))


def drift_hysteresis_from_env() -> int:
    """``CMN_POLICY_DRIFT_HYSTERESIS`` — consecutive breaching SLO
    checks before the prefill cap engages (and clean checks before it
    releases; default 2)."""
    return max(1, int(_env_float("CMN_POLICY_DRIFT_HYSTERESIS", 2)))


def decode_cost_from_env() -> int:
    """``CMN_POLICY_COST_DECODE`` — policy-clock cost units per decode
    iteration (default 1; prefill tokens are always 1 each)."""
    return max(0, int(_env_float("CMN_POLICY_COST_DECODE", 1)))


def block_cost_from_env() -> float:
    """``CMN_POLICY_COST_BLOCK_US`` — policy-clock cost units per KV
    block-microsecond held (default 0 = pool occupancy not metered
    into the fairness clock; enable to charge hoarders)."""
    return max(0.0, _env_float("CMN_POLICY_COST_BLOCK_US", 0.0))


def starvation_ms_from_env() -> float:
    """``CMN_POLICY_STARVATION_MS`` — per-tenant rolling queue-wait p95
    above which the plane names the tenant on the
    ``serve.policy.starved_tenant`` gauge (default 1000 ms)."""
    return _env_float("CMN_POLICY_STARVATION_MS", 1000.0)


def default_weight_from_env() -> float:
    """``CMN_SERVE_TENANT_WEIGHT`` — fair-share weight for tenants not
    named in the spec (default 1)."""
    return max(1e-9, _env_float("CMN_SERVE_TENANT_WEIGHT", 1.0))


def tenant_spec_from_env() -> Dict[str, "TenantPolicy"]:
    """Parse ``CMN_SERVE_TENANT_SPEC`` — semicolon-separated per-tenant
    specs ``name:key=value,key=value`` with keys ``weight``,
    ``priority``, ``rate`` (cost units/s), ``quota`` (prefix-cache
    blocks), ``deadline_ms``, ``shed`` (router holdback depth), e.g.
    ``slo:weight=4,priority=1,deadline_ms=500;batch:weight=1,rate=200``.
    Unparseable fragments are skipped (tolerant, like every obs knob)."""
    import os

    spec = os.environ.get("CMN_SERVE_TENANT_SPEC", "").strip()
    out: Dict[str, TenantPolicy] = {}
    if not spec:
        return out
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, body = part.partition(":")
        name = name.strip()
        if not name:
            continue
        kw: dict = {}
        for item in body.split(","):
            k, _, v = item.partition("=")
            k, v = k.strip(), v.strip()
            try:
                if k == "weight":
                    kw["weight"] = max(1e-9, float(v))
                elif k == "priority":
                    kw["priority"] = int(float(v))
                elif k == "rate":
                    kw["rate_limit"] = float(v)
                elif k == "quota":
                    kw["prefix_quota"] = int(float(v))
                elif k == "deadline_ms":
                    kw["deadline_ms"] = float(v)
                elif k == "shed":
                    kw["shed_depth"] = int(float(v))
            except ValueError:
                continue
        out[name] = TenantPolicy(name=name, **kw)
    return out


# --------------------------------------------------------- TenantPolicy
@dataclass
class TenantPolicy:
    """One tenant's knobs.  Everything optional: an unconfigured tenant
    gets the default weight and no limits — the plane never refuses a
    tenant it has not seen."""

    name: str
    #: fair-share weight: the VTC clock advances by ``cost / weight``,
    #: so a weight-3 tenant earns 3× the service of a weight-1 one.
    weight: float = 1.0
    #: default priority class for requests that carry none of their own
    #: (``Request.priority == 0``); higher preempts lower.
    priority: int = 0
    #: cost units per second this tenant may consume (policy clock);
    #: None = unlimited.
    rate_limit: Optional[float] = None
    #: prefix-cache trie blocks this tenant may pin; None = unlimited.
    prefix_quota: Optional[int] = None
    #: default deadline (ms past arrival) for its requests that carry
    #: none — terminates as the existing ``status="deadline"``.
    deadline_ms: Optional[float] = None
    #: router holdback cap for this tenant's ARRIVED requests; overflow
    #: sheds newest-first as the existing ``status="shed"``.
    shed_depth: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}"
            )


# ---------------------------------------------------------- PolicyPlane
class PolicyPlane:
    """The fleet's admission/eviction/steal policy.

    Args:
      tenants: per-tenant knobs — a dict ``name -> TenantPolicy``, an
        iterable of :class:`TenantPolicy`, or None (resolve from
        ``CMN_SERVE_TENANT_SPEC``).  Tenants not named get
        ``TenantPolicy(name, weight=CMN_SERVE_TENANT_WEIGHT)`` on first
        sight.
      registry: where ``serve.policy.*`` and the per-tenant
        ``serve.tenant.<t>.*`` family publish — the Scheduler/Router
        latch (explicit always publishes; ``None`` rides ``CMN_OBS``;
        off → noop instruments).
      prefill_cap / drift_hysteresis: the Sarathi latch (env-backed
        defaults ``CMN_POLICY_PREFILL_CAP`` /
        ``CMN_POLICY_DRIFT_HYSTERESIS``).
      decode_cost / block_cost_us: policy-clock weights for the decode
        and block-occupancy seams (``CMN_POLICY_COST_DECODE`` /
        ``CMN_POLICY_COST_BLOCK_US``).
      starvation_ms: queue-wait p95 envelope behind the
        ``tenant_starvation`` rule (``CMN_POLICY_STARVATION_MS``).
    """

    def __init__(self, tenants=None, registry=None,
                 prefill_cap: Optional[int] = None,
                 drift_hysteresis: Optional[int] = None,
                 decode_cost: Optional[int] = None,
                 block_cost_us: Optional[float] = None,
                 starvation_ms: Optional[float] = None):
        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability.metrics import (
            registry as global_registry,
        )

        if tenants is None:
            tenants = tenant_spec_from_env()
        if not isinstance(tenants, dict):
            tenants = {t.name: t for t in tenants}
        self.tenants: Dict[str, TenantPolicy] = dict(tenants)
        self._default_weight = default_weight_from_env()
        self.prefill_cap = (
            prefill_cap_from_env() if prefill_cap is None
            else max(1, int(prefill_cap))
        )
        self.drift_hysteresis = (
            drift_hysteresis_from_env() if drift_hysteresis is None
            else max(1, int(drift_hysteresis))
        )
        self.decode_cost = (
            decode_cost_from_env() if decode_cost is None
            else max(0, int(decode_cost))
        )
        self.block_cost_us = (
            block_cost_from_env() if block_cost_us is None
            else max(0.0, float(block_cost_us))
        )
        self.starvation_ms = (
            starvation_ms_from_env() if starvation_ms is None
            else float(starvation_ms)
        )
        #: live view the PrefixCache reads at insert time — one dict,
        #: shared by reference into every replica's trie.
        self.prefix_quotas: Dict[str, int] = {
            n: t.prefix_quota for n, t in self.tenants.items()
            if t.prefix_quota is not None
        }
        #: raw policy-clock charge per tenant (integer cost units except
        #: for the optional fractional block weight) — the rate-limit
        #: basis and the VTC oracle's input.
        self.charged: Dict[str, float] = {}
        #: the virtual token counter: ``charged / weight``, lifted on
        #: (re)activation.  Admission picks the smallest.
        self.virtual: Dict[str, float] = {}
        #: first-sighting time per tenant — the rate-limit clock origin.
        self._t0: Dict[str, float] = {}
        #: request id -> (tenant, block level, since-us) — the
        #: piecewise block-second integral, mirroring the ledger's.
        self._blocks: Dict[int, tuple] = {}
        #: tenants queued at the last pick (activation-lift tracking).
        self._was_queued: set = set()
        #: stable tenant index for the starvation gauge / incident key.
        self._tenant_index: Dict[str, int] = {}
        #: rolling queue-wait windows (ms), per tenant.
        self._wait_win: Dict[str, List[float]] = {}
        self._wait_window = 64
        # Drift latch state.
        self._breach_streak = 0
        self._clean_streak = 0
        self.prefill_cap_active = False
        #: audit trail: (req_id, tenant, virtual-clock-at-pick) per
        #: admission pick — the VTC convergence test's exact record.
        self.admission_log: List[tuple] = []
        self.preemptions = 0
        self.throttle_deferrals = 0
        #: True once a Router owns this plane: replicas then skip their
        #: own per-tenant queue-depth publish (the router's fleet-wide
        #: census is the truth; per-replica publishes would thrash it).
        self.fleet = False
        if registry is None and not _obs.enabled():
            self._reg = None
            noop = _NoopInstrument()
            self._m_preempt = self._m_throttled = noop
            self._m_cap_active = self._m_capped = noop
            self._m_starved = noop
        else:
            reg = registry if registry is not None else global_registry()
            self._reg = reg
            self._m_preempt = reg.counter("serve.policy.preemptions")
            self._m_throttled = reg.counter("serve.policy.throttled")
            self._m_cap_active = reg.gauge(
                "serve.policy.prefill_cap_active"
            )
            self._m_capped = reg.counter("serve.policy.prefill_capped")
            self._m_starved = reg.gauge("serve.policy.starved_tenant")
        self._m_cap_active.set(0.0)
        self._m_starved.set(-1.0)
        #: per-tenant instruments, created on first sight.
        self._t_depth: Dict[str, object] = {}
        self._t_preempted: Dict[str, object] = {}
        self._t_throttled: Dict[str, object] = {}

    # ------------------------------------------------------------ tenants
    def policy_for(self, tenant: str) -> TenantPolicy:
        t = self.tenants.get(tenant)
        if t is None:
            t = TenantPolicy(tenant, weight=self._default_weight)
            self.tenants[tenant] = t
        if tenant not in self._tenant_index:
            self._tenant_index[tenant] = len(self._tenant_index)
        return t

    def tenant_index(self, tenant: str) -> int:
        """Stable integer id (first-sighting order) — the starvation
        gauge's value and incident dedupe key."""
        self.policy_for(tenant)
        return self._tenant_index[tenant]

    def effective_priority(self, req) -> int:
        """The request's class: its own ``priority`` when set (non-zero),
        else its tenant's default."""
        p = getattr(req, "priority", 0)
        return p if p else self.policy_for(req.tenant).priority

    def _t_inst(self, cache: Dict[str, object], tenant: str,
                suffix: str, kind: str):
        inst = cache.get(tenant)
        if inst is None:
            if self._reg is None:
                inst = _NoopInstrument()
            elif kind == "gauge":
                inst = self._reg.gauge(f"serve.tenant.{tenant}.{suffix}")
            else:
                inst = self._reg.counter(
                    f"serve.tenant.{tenant}.{suffix}"
                )
            cache[tenant] = inst
        return inst

    # ------------------------------------------------------------ charging
    def charge(self, tenant: str, dim: str, amount) -> None:
        """Advance ``tenant``'s policy clock by one booked cost — the
        same seams the usage ledger books (prefill tokens net of prefix
        hits, decode iterations, block-microseconds)."""
        if amount <= 0:
            return
        if dim == "prefill_tokens":
            cost = float(amount)
        elif dim == "decode_iterations":
            cost = float(amount) * self.decode_cost
        elif dim == "block_us":
            cost = float(amount) * self.block_cost_us
        else:
            raise ValueError(f"unknown policy cost dim {dim!r}")
        if cost <= 0:
            return
        t = self.policy_for(tenant)
        self.charged[tenant] = self.charged.get(tenant, 0.0) + cost
        self.virtual[tenant] = (
            self.virtual.get(tenant, 0.0) + cost / t.weight
        )

    def set_blocks(self, rid: int, tenant: str, blocks: int,
                   now: float) -> None:
        """Piecewise-constant block-second integration on the policy
        clock — the ledger's ``set_blocks`` discipline, charged into
        the fairness clock at ``CMN_POLICY_COST_BLOCK_US`` units per
        block-microsecond (0 = seam present, charge off)."""
        now_us = int(now * 1e6)
        prev = self._blocks.get(rid)
        if prev is not None:
            _, level, since = prev
            if level > 0 and now_us > since:
                self.charge(tenant, "block_us", (now_us - since) * level)
        if blocks > 0:
            self._blocks[rid] = (tenant, int(blocks), now_us)
        else:
            self._blocks.pop(rid, None)

    # ---------------------------------------------------------- rate limit
    def _ensure_clock(self, tenant: str, now: float) -> None:
        if tenant not in self._t0:
            self._t0[tenant] = now

    def throttled(self, tenant: str, now: float) -> bool:
        """True while ``tenant`` has consumed past its ``rate_limit``
        allowance (``rate × seconds-since-first-sight``)."""
        t = self.policy_for(tenant)
        if t.rate_limit is None:
            return False
        self._ensure_clock(tenant, now)
        allowance = t.rate_limit * max(0.0, now - self._t0[tenant])
        return self.charged.get(tenant, 0.0) > allowance

    def next_release(self, reqs: Sequence, now: float
                     ) -> Optional[float]:
        """Earliest time a currently-throttled queued tenant becomes
        eligible again — the idle-skip bound for ``run()`` loops (a
        fully-throttled queue must advance the clock, not spin)."""
        out = None
        # Queue order, not a set's: a tenant first seen here takes the
        # next index, and the ranks of a tensor-parallel fleet (each its
        # own string hash seed) must number tenants alike.
        for tenant in dict.fromkeys(r.tenant for r in reqs
                                    if r.arrival <= now):
            t = self.policy_for(tenant)
            if t.rate_limit is None or not self.throttled(tenant, now):
                continue
            rel = (
                self._t0[tenant]
                + self.charged.get(tenant, 0.0) / t.rate_limit
            )
            out = rel if out is None else min(out, rel)
        return out

    # ------------------------------------------------------------- picking
    def pick_index(self, reqs: Sequence, now: float,
                   record: bool = False) -> Optional[int]:
        """The weighted-fair admission pick over ``reqs`` (Request-like:
        ``.arrival`` / ``.tenant`` / ``.id``): the first-queued item of
        the arrived, un-throttled tenant with the smallest virtual
        clock.  Returns the index into ``reqs``, or None (nothing
        arrived, or every arrived tenant is rate-throttled — counted as
        a throttle deferral)."""
        heads: Dict[str, int] = {}
        order: List[str] = []
        for i, r in enumerate(reqs):
            if r.arrival > now:
                continue
            if r.tenant not in heads:
                heads[r.tenant] = i
                order.append(r.tenant)
        if not heads:
            return None
        # Activation lift: a tenant newly (re)joining the queue starts
        # at the busiest floor — idle time banks no credit (VTC).
        floor = min(
            (self.virtual.get(t, 0.0) for t in order
             if t in self._was_queued),
            default=None,
        )
        for t in order:
            self.policy_for(t)
            self._ensure_clock(t, now)
            if t not in self._was_queued and floor is not None:
                self.virtual[t] = max(
                    self.virtual.get(t, 0.0), floor
                )
        self._was_queued = set(order)
        eligible = [t for t in order if not self.throttled(t, now)]
        if not eligible:
            self.throttle_deferrals += 1
            self._m_throttled.inc()
            for t in order:
                self._t_inst(
                    self._t_throttled, t, "throttled", "counter"
                ).inc()
            return None
        best = min(
            eligible,
            key=lambda t: (self.virtual.get(t, 0.0),
                           self._tenant_index[t]),
        )
        idx = heads[best]
        if record:
            self.admission_log.append(
                (reqs[idx].id, best, self.virtual.get(best, 0.0))
            )
        return idx

    def note_admission(self, req) -> None:
        """Record one COMMITTED admission (the scheduler calls this
        after the allocator gate passed, never on a failed pick) —
        ``(req id, tenant, virtual clock at admission)``, the VTC
        convergence test's exact trace."""
        self.admission_log.append(
            (req.id, req.tenant,
             self.virtual.get(req.tenant, 0.0))
        )

    def steal_index(self, reqs: Sequence, now: float) -> Optional[int]:
        """The rebalance-steal pick: the same weighted-fair head the
        donor's own admission would serve next — the stolen entry runs
        at once on an idle replica, so the steal can only accelerate the
        fair schedule."""
        return self.pick_index(reqs, now)

    # ----------------------------------------------------------- preemption
    def preempt_pick(self, slots: Sequence, incoming_class: int):
        """The victim for a class-``incoming_class`` admission with no
        free slot: the LOWEST-class slot, youngest admission among
        equals (the eviction discipline), and only when strictly
        outranked.  Returns the slot or None."""
        victims = [
            s for s in slots
            if self.effective_priority(s.entry.req) < incoming_class
        ]
        if not victims:
            return None
        return min(
            victims,
            key=lambda s: (self.effective_priority(s.entry.req),
                           -s.admit_seq),
        )

    def note_preemption(self, victim_tenant: str) -> None:
        self.preemptions += 1
        self._m_preempt.inc()
        self._t_inst(
            self._t_preempted, victim_tenant, "preempted", "counter"
        ).inc()

    # ------------------------------------------------------- prefill budget
    def on_slo_check(self, report: Optional[dict]) -> None:
        """Feed one SLO check verdict into the drift latch (call on the
        scheduler's check cadence).  Engages the prefill cap after
        ``drift_hysteresis`` consecutive breaching checks; releases
        after the same number of clean ones."""
        breached = bool(report) and any(
            isinstance(v, dict) and v.get("breached")
            for v in report.values()
        )
        if breached:
            self._breach_streak += 1
            self._clean_streak = 0
            if not self.prefill_cap_active and \
                    self._breach_streak >= self.drift_hysteresis:
                self.prefill_cap_active = True
                self._m_cap_active.set(1.0)
        else:
            self._clean_streak += 1
            self._breach_streak = 0
            if self.prefill_cap_active and \
                    self._clean_streak >= self.drift_hysteresis:
                self.prefill_cap_active = False
                self._m_cap_active.set(0.0)

    def prefill_budget(self) -> Optional[int]:
        """Prefill tokens admissible this iteration: ``prefill_cap``
        while the drift latch is engaged, None (unbounded) otherwise."""
        return self.prefill_cap if self.prefill_cap_active else None

    def note_prefill_capped(self) -> None:
        self._m_capped.inc()

    # ---------------------------------------------------------- starvation
    def note_queue_wait(self, tenant: str, wait_ms: float) -> None:
        """One first-admission queue-wait sample; refreshes the starved
        gauge (worst breaching tenant's index, −1 = nobody)."""
        win = self._wait_win.setdefault(tenant, [])
        win.append(float(wait_ms))
        if len(win) > self._wait_window:
            del win[: len(win) - self._wait_window]
        self._publish_starved()

    def _wait_p95(self, tenant: str) -> Optional[float]:
        win = self._wait_win.get(tenant)
        if not win:
            return None
        vals = sorted(win)
        return vals[min(len(vals) - 1, int(0.95 * (len(vals) - 1)))]

    def _publish_starved(self) -> None:
        worst, worst_p95 = None, None
        for tenant in self._wait_win:
            p95 = self._wait_p95(tenant)
            if p95 is not None and p95 > self.starvation_ms and (
                worst_p95 is None or p95 > worst_p95
            ):
                worst, worst_p95 = tenant, p95
        self._m_starved.set(
            float(self.tenant_index(worst)) if worst is not None
            else -1.0
        )

    # ------------------------------------------------------------ defaults
    def deadline_ms(self, tenant: str) -> Optional[float]:
        """The tenant's default deadline for requests carrying none."""
        return self.policy_for(tenant).deadline_ms

    # -------------------------------------------------------------- publish
    def shed_depth(self, tenant: str) -> Optional[int]:
        """The tenant's router holdback cap (None = only the fleet
        ``CMN_ROUTER_SHED_DEPTH`` applies)."""
        return self.policy_for(tenant).shed_depth

    def publish_queue(self, tenants: Sequence[str]) -> None:
        """Refresh ``serve.tenant.<t>.queue_depth`` from one queue
        census (every queued request's tenant, fleet-wide when the
        Router drives it)."""
        counts: Dict[str, int] = {}
        for t in tenants:
            counts[t] = counts.get(t, 0) + 1
        for t in self._t_depth:
            if t not in counts:
                self._t_depth[t].set(0.0)
        for t, n in counts.items():
            self._t_inst(
                self._t_depth, t, "queue_depth", "gauge"
            ).set(float(n))

    # --------------------------------------------- tensor-parallel fleets
    def fork(self) -> "PolicyPlane":
        """A copy of this plane's decision state that publishes nothing
        and starts an empty admission log: what one replica of a
        tensor-parallel fleet ticks against (:class:`PlaneTape`)."""
        f = PolicyPlane.__new__(PolicyPlane)
        f.__dict__.update(self.__dict__)
        for name in ("tenants", "charged", "virtual", "_t0", "_blocks",
                     "_tenant_index"):
            setattr(f, name, dict(getattr(self, name)))
        f._was_queued = set(self._was_queued)
        f._wait_win = {t: list(w) for t, w in self._wait_win.items()}
        f.admission_log = []
        f._reg = None
        noop = _NoopInstrument()
        f._m_preempt = f._m_throttled = f._m_cap_active = noop
        f._m_capped = f._m_starved = noop
        f._t_depth, f._t_preempted, f._t_throttled = {}, {}, {}
        return f

    def replay(self, ops: Sequence[tuple]) -> None:
        """Apply a :class:`PlaneTape`'s recorded calls, in order."""
        for name, args in ops:
            getattr(self, name)(*args)

    # ---------------------------------------------------------- inspection
    def state(self) -> dict:
        """Host-side snapshot (flight records, tests, ``chip_smoke.py``)."""
        return {
            "virtual": dict(self.virtual),
            "charged": dict(self.charged),
            "prefill_cap_active": self.prefill_cap_active,
            "preemptions": self.preemptions,
            "throttle_deferrals": self.throttle_deferrals,
            "tenants": sorted(self.tenants),
        }


# ------------------------------------------------------------- PlaneTape
class _Req(NamedTuple):
    """What the plane reads of a request (a recorded call's argument)."""

    id: int
    tenant: str
    arrival: float
    priority: int


class _Entry(NamedTuple):
    req: _Req


class _SlotRef(NamedTuple):
    """What :meth:`PolicyPlane.preempt_pick` reads of a slot."""

    entry: _Entry
    admit_seq: int


def _req(r) -> _Req:
    return _Req(r.id, r.tenant, float(r.arrival),
                int(getattr(r, "priority", 0)))


#: the calls a scheduler makes on its plane that change it (state or
#: instruments), each with the converter of its arguments into what the
#: plane reads of them (picklable).
_TAPED = {
    "charge": None, "set_blocks": None, "deadline_ms": None,
    "note_queue_wait": None, "note_preemption": None,
    "note_prefill_capped": None, "on_slo_check": None,
    "pick_index": lambda reqs, now: ([_req(r) for r in reqs], now),
    "steal_index": lambda reqs, now: ([_req(r) for r in reqs], now),
    "next_release": lambda reqs, now: ([_req(r) for r in reqs], now),
    "note_admission": lambda req: (_req(req),),
    "effective_priority": lambda req: (_req(req),),
    "preempt_pick": lambda slots, cls: (
        [_SlotRef(_Entry(_req(s.entry.req)), s.admit_seq) for s in slots],
        cls),
}


class PlaneTape:
    """The plane a replica's scheduler holds in a tensor-parallel fleet.

    Between :meth:`begin` and :meth:`end` (one replica tick) every call
    goes to a :meth:`PolicyPlane.fork` of ``plane``, and each that
    changes the plane is recorded, its arguments reduced to what the
    plane reads of them; :meth:`end`
    returns the record for :meth:`PolicyPlane.replay`.  Outside a tick
    (the router's steals and idle skips, which every rank makes alike)
    calls go to ``plane`` itself, unrecorded."""

    def __init__(self, plane: PolicyPlane):
        self.plane = plane
        self._target = plane
        self._ops: Optional[list] = None

    def begin(self) -> None:
        self._target = self.plane.fork()
        self._ops = []

    def end(self) -> list:
        ops, self._ops, self._target = self._ops or [], None, self.plane
        return ops

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        if self._ops is None or name not in _TAPED:
            return attr
        light = _TAPED[name]

        def call(*args):
            self._ops.append((name, light(*args) if light else args))
            return attr(*args)

        return call
