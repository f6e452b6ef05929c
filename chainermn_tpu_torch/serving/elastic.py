"""Elastic serving fleet: closed-loop autoscaling + rolling deploys.

Serving load is diurnal and bursty; a statically sized fleet either
queues the bursts or pays for idle replicas.  This module closes the
loop over pieces the fleet already has: the router's live gauges, the
zero-loss ``cmn-kvmig-1`` drain path, the probation circuit breaker and
the incident plane's watch-rule grammar.

* :class:`Autoscaler` — watches ``serve.router.queue_depth``,
  ``serve.slot_occupancy`` and ``serve.slo.p95_drift`` through
  :class:`~chainermn_tpu_torch.observability.incident.Watch` rules and
  scales the :class:`~chainermn_tpu_torch.serving.router.Router`'s
  replica set.  Scale-up builds a replica via the injected
  ``engine_factory`` and registers it BEHIND PROBATION
  (``Router.add_replica``; its decode step is captured once, at its
  first decode iteration); scale-down picks the coldest live replica,
  fences it (DRAINING), drains every live slot and queued entry to
  survivors (``Router.drain_replica`` — live KV over
  ``pack_slots``/``install_payload``, nothing lost, survivors never
  re-capture), then deregisters it, which frees its device state.
  Hysteresis (consecutive breaching ticks) plus a post-action cooldown
  keep bursty gauges from flapping the fleet; a would-be action in the
  OPPOSITE direction during cooldown counts ``serve.autoscale.flap``
  (the critical ``scale_flap`` default incident rule) and is suppressed.

* :class:`RollingDeploy` — zero-downtime version replacement: the same
  fence → drain → revive sequence, one replica at a time, with new
  weights handed to the engine factory.  Health gate: each replaced
  replica must GRADUATE PROBATION before the next is touched.  A
  replica that dies mid-rollout pauses the rollout and files a critical
  incident (``rollout_interrupted``); a step stuck past
  ``CMN_SERVE_ROLLOUT_TIMEOUT_TICKS`` counts ``serve.rollout.stalled``
  (the critical ``rollout_stalled`` default rule).  The JAX package
  loads the new weights through its checkpointer, which the port has
  not ported; the caller passes them as ``params``.

Both controllers are host-side supervisors over PUBLIC router seams
(``add_replica`` / ``drain_replica`` / ``retire_replica`` /
``revive_replica`` / ``deregister_replica``); the chaos harness drives
the same seams under fault schedules.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from chainermn_tpu_torch.observability.metrics import (
    NoopInstrument as _NoopInstrument,
    _env_float,
)


# ----------------------------------------------------------- env knobs
def scale_up_depth_from_env() -> float:
    """``CMN_SERVE_SCALE_UP_DEPTH`` — arrived requests held back in the
    router queue above which the autoscaler wants a replica (default
    4)."""
    return _env_float("CMN_SERVE_SCALE_UP_DEPTH", 4.0)


def scale_up_drift_from_env() -> float:
    """``CMN_SERVE_SCALE_UP_DRIFT`` — worst-replica ``serve.slo.
    p95_drift`` above which the autoscaler wants a replica (default
    0.25)."""
    return _env_float("CMN_SERVE_SCALE_UP_DRIFT", 0.25)


def scale_down_occ_from_env() -> float:
    """``CMN_SERVE_SCALE_DOWN_OCC`` — mean fleet slot occupancy below
    which (with an empty router queue) the autoscaler retires the
    coldest replica (default 0.3)."""
    return _env_float("CMN_SERVE_SCALE_DOWN_OCC", 0.3)


def scale_hysteresis_from_env() -> int:
    """``CMN_SERVE_SCALE_HYSTERESIS`` — consecutive breaching ticks a
    scaling signal must hold before the autoscaler acts (default 2)."""
    return max(1, int(_env_float("CMN_SERVE_SCALE_HYSTERESIS", 2)))


def scale_cooldown_from_env() -> int:
    """``CMN_SERVE_SCALE_COOLDOWN_TICKS`` — ticks after a scale action
    during which no further action fires (a reversed direction in this
    window counts ``serve.autoscale.flap``; default 16)."""
    return max(0, int(_env_float("CMN_SERVE_SCALE_COOLDOWN_TICKS", 16)))


def scale_bounds_from_env() -> tuple:
    """``CMN_SERVE_SCALE_MIN`` / ``CMN_SERVE_SCALE_MAX`` — fleet-size
    bounds the autoscaler never crosses (defaults 1 / 8)."""
    lo = max(1, int(_env_float("CMN_SERVE_SCALE_MIN", 1)))
    hi = max(lo, int(_env_float("CMN_SERVE_SCALE_MAX", 8)))
    return lo, hi


def rollout_timeout_from_env() -> int:
    """``CMN_SERVE_ROLLOUT_TIMEOUT_TICKS`` — ticks one rollout step may
    take (drain + probation graduation) before ``serve.rollout.
    stalled`` counts and the ``rollout_stalled`` rule fires (default
    256)."""
    return max(1, int(_env_float("CMN_SERVE_ROLLOUT_TIMEOUT_TICKS", 256)))


# ------------------------------------------------------------ Autoscaler
class Autoscaler:
    """Closed-loop fleet sizing over the router's live signals.

    Args:
      router: the :class:`~chainermn_tpu_torch.serving.router.Router` whose
        replica set this controller owns.
      engine_factory: builds one fresh engine per scale-up (same
        contract as the chaos harness's: a new replica's device state
        is always fresh).
      registry: where ``serve.autoscale.*`` publishes — same latch as
        the Scheduler/Router (explicit always publishes; ``None``
        rides the ``CMN_OBS`` master switch; off → noop instruments,
        zero overhead — the obs A/B contract is unchanged with an
        autoscaler constructed).
      min_replicas / max_replicas: fleet-size bounds (defaults
        ``CMN_SERVE_SCALE_MIN`` / ``CMN_SERVE_SCALE_MAX``).
      up_depth / up_drift / down_occ: signal thresholds (defaults
        ``CMN_SERVE_SCALE_UP_DEPTH`` / ``CMN_SERVE_SCALE_UP_DRIFT`` /
        ``CMN_SERVE_SCALE_DOWN_OCC``).
      hysteresis / cooldown_ticks: flap damping (defaults
        ``CMN_SERVE_SCALE_HYSTERESIS`` /
        ``CMN_SERVE_SCALE_COOLDOWN_TICKS``).
      down_hysteresis: streak the DOWN watch needs (default:
        ``hysteresis``).  Scale-down is the reversible-but-expensive
        direction, and the tick after a scale-up always samples a
        transient occupancy dip (the newcomer is empty) — an
        aggressive-up policy sets ``hysteresis=1,
        down_hysteresis>=3`` so that dip never even registers as an
        urge, let alone a flap.

    Call :meth:`tick` once per router tick.  Decisions are recorded in
    :attr:`decisions` and published as ``serve.autoscale.*``;
    :attr:`replica_ticks` integrates fleet size over ticks (the
    bench's replica-seconds numerator).
    """

    def __init__(self, router, engine_factory: Callable[[], object],
                 registry=None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 up_depth: Optional[float] = None,
                 up_drift: Optional[float] = None,
                 down_occ: Optional[float] = None,
                 hysteresis: Optional[int] = None,
                 cooldown_ticks: Optional[int] = None,
                 down_hysteresis: Optional[int] = None):
        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability.incident import Watch
        from chainermn_tpu_torch.observability.metrics import (
            registry as global_registry,
        )

        self.router = router
        self.engine_factory = engine_factory
        lo, hi = scale_bounds_from_env()
        self.min_replicas = lo if min_replicas is None else max(
            1, int(min_replicas)
        )
        self.max_replicas = hi if max_replicas is None else max(
            self.min_replicas, int(max_replicas)
        )
        self.up_depth = (
            scale_up_depth_from_env() if up_depth is None else up_depth
        )
        self.up_drift = (
            scale_up_drift_from_env() if up_drift is None else up_drift
        )
        self.down_occ = (
            scale_down_occ_from_env() if down_occ is None else down_occ
        )
        h = (
            scale_hysteresis_from_env() if hysteresis is None
            else max(1, int(hysteresis))
        )
        dh = h if down_hysteresis is None else max(1, int(down_hysteresis))
        self.cooldown_ticks = (
            scale_cooldown_from_env() if cooldown_ticks is None
            else max(0, int(cooldown_ticks))
        )
        #: The scaling policy AS watch rules — the incident grammar judges
        #: the signals (compiled predicate + hysteresis streak), this
        #: controller only acts on the verdicts.  +1 = wants a replica,
        #: −1 = can spare one.
        self.watches = [
            (Watch(
                "autoscale_up_backlog", "serve.router.queue_depth",
                f"> {self.up_depth:g}", hysteresis=h,
                description="arrived requests held back fleet-wide — "
                            "the scale-out signal",
            ), +1),
            (Watch(
                "autoscale_up_slo", "serve.slo.p95_drift",
                f"> {self.up_drift:g}", hysteresis=h,
                description="worst replica's rolling p95 left the SLO "
                            "envelope",
            ), +1),
            (Watch(
                "autoscale_down_idle", "serve.slot_occupancy",
                f"< {self.down_occ:g}", hysteresis=dh,
                description="mean fleet occupancy low with an empty "
                            "router queue — capacity to spare",
            ), -1),
        ]
        self._streak = {w.name: 0 for w, _ in self.watches}
        self._cooldown_left = 0
        self._last_direction = 0
        self._ticks = 0
        #: Σ up-replica count per tick — replica-seconds on the shared
        #: scheduler clock's tick grid (a draining replica still costs
        #: a machine, so it counts until deregistration).
        self.replica_ticks = 0
        self.flaps = 0
        #: [{"tick", "action", "replica", "reason"}] audit trail.
        self.decisions: List[dict] = []
        if registry is None and not _obs.enabled():
            noop = _NoopInstrument()
            self._m_replicas = self._m_up = self._m_down = noop
            self._m_flap = noop
        else:
            reg = registry if registry is not None else global_registry()
            self._m_replicas = reg.gauge("serve.autoscale.replicas")
            self._m_up = reg.counter("serve.autoscale.scale_up")
            self._m_down = reg.counter("serve.autoscale.scale_down")
            self._m_flap = reg.counter("serve.autoscale.flap")
        self._m_replicas.set(len(self._up_replicas()))

    # ----------------------------------------------------------- signals
    def _up_replicas(self) -> List[int]:
        r = self.router
        return [
            i for i in range(len(r.schedulers))
            if r.schedulers[i] is not None and r.health.is_up(i)
        ]

    def _signals(self) -> dict:
        """The three live signals, fleet-aggregated: arrived router
        backlog, mean up-replica occupancy, worst-replica SLO drift
        (``None`` when no replica has published one — an absent signal
        never fires, the Watch contract)."""
        r = self.router
        now = r.clock.now()
        depth = float(sum(
            1 for q in r.queued_requests() if q.arrival <= now
        ))
        ups = self._up_replicas()
        occ = (
            sum(r._occupancy(i) for i in ups) / len(ups) if ups else None
        )
        drifts = []
        for i in ups:
            inst = r.replica_registries[i].peek("serve.slo.p95_drift")
            if inst is not None and inst.value is not None:
                drifts.append(float(inst.value))
        return {
            "serve.router.queue_depth": depth,
            "serve.slot_occupancy": occ,
            "serve.slo.p95_drift": max(drifts) if drifts else None,
        }

    # ------------------------------------------------------------ control
    def tick(self) -> Optional[dict]:
        """One control-loop evaluation.  Returns the action record when
        the fleet changed size, else ``None``."""
        self._ticks += 1
        self.replica_ticks += len(self._up_replicas())
        sig = self._signals()
        direction = 0
        reason = None
        for w, d in self.watches:
            v = sig.get(w.metric)
            if v is not None and w._fn(v):
                self._streak[w.name] += 1
            else:
                self._streak[w.name] = 0
            if self._streak[w.name] >= w.hysteresis:
                # Scale-up outranks scale-down (latency beats savings);
                # watch order encodes the priority.
                if direction == 0 or (direction < 0 and d > 0):
                    direction, reason = d, w.name
        if direction < 0 and sig["serve.router.queue_depth"] > 0:
            # Never retire capacity while anything waits fleet-wide.
            direction, reason = 0, None
        in_cooldown = self._cooldown_left > 0
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if direction == 0:
            self._m_replicas.set(len(self._up_replicas()))
            return None
        if in_cooldown:
            if self._last_direction and direction != self._last_direction:
                # Direction reversed within cooldown: the flap the
                # damping exists to absorb.  Counted (the critical
                # ``scale_flap`` default rule watches this), suppressed.
                self.flaps += 1
                self._m_flap.inc()
            return None
        action = self._act(direction, reason)
        self._m_replicas.set(len(self._up_replicas()))
        return action

    def _act(self, direction: int, reason: str) -> Optional[dict]:
        n = len(self._up_replicas())
        if direction > 0:
            if n >= self.max_replicas:
                return None
            i = self.router.add_replica(self.engine_factory())
            self._m_up.inc()
            action = "scale_up"
        else:
            if n <= self.min_replicas:
                return None
            i = self._coldest()
            if i is None:
                return None
            self.router.drain_replica(i)
            self.router.deregister_replica(i)
            self._m_down.inc()
            action = "scale_down"
        self._last_direction = direction
        self._cooldown_left = self.cooldown_ticks
        rec = {
            "tick": self._ticks, "action": action, "replica": i,
            "reason": reason,
        }
        self.decisions.append(rec)
        for name in self._streak:
            self._streak[name] = 0
        return rec

    def _coldest(self) -> Optional[int]:
        """The scale-down victim: the least-loaded FULL-TRUST live
        admitting replica (a probation newcomer is never the victim —
        retiring what was just added is the flap this controller
        damps), keeping at least one admitting replica."""
        r = self.router
        admitting = [i for i in r._admitting if r.health.can_admit(i)]
        cands = [i for i in admitting if r.health.state(i) == "live"]
        if not cands or len(admitting) <= 1:
            return None
        return min(cands, key=r._load)


# --------------------------------------------------------- RollingDeploy
class RollingDeploy:
    """Zero-downtime rolling deploy over the router's elastic seams.

    Replaces every replica that is LIVE at construction, one at a
    time: fence → drain (live slots hand off over cmn-kvmig-1, queue
    re-dispatches — zero loss) → retire (orderly, not a counted
    failure) → revive with a new-version engine behind probation.
    Health gate: the replaced replica must graduate probation (state
    ``live`` again) before the next is touched.

    ``engine_factory`` builds the replacement engine; when ``params``
    is given (the "new model version" weights) it is
    called as ``engine_factory(params=params)``, else ``()``.

    A replica that dies mid-rollout — the one in flight, or one still
    waiting its turn — PAUSES the rollout (:attr:`paused`) and files a
    critical ``rollout_interrupted`` incident; :meth:`resume` continues
    once an operator revived it.  A step stuck longer than
    ``timeout_ticks`` (``CMN_SERVE_ROLLOUT_TIMEOUT_TICKS``) counts
    ``serve.rollout.stalled`` once, which the critical
    ``rollout_stalled`` default rule turns into an incident.

    Drive :meth:`tick` once per router tick; :attr:`done` reports
    completion, :attr:`replaced` the replica order.
    """

    def __init__(self, router, engine_factory: Callable[..., object],
                 params=None, registry=None,
                 timeout_ticks: Optional[int] = None,
                 incidents=None):
        import chainermn_tpu_torch.observability as _obs
        from chainermn_tpu_torch.observability.metrics import (
            registry as global_registry,
        )

        self.router = router
        self.engine_factory = engine_factory
        self.params = params
        self.timeout_ticks = (
            rollout_timeout_from_env() if timeout_ticks is None
            else max(1, int(timeout_ticks))
        )
        self.incidents = (
            incidents if incidents is not None else router.incidents
        )
        #: replicas still awaiting replacement, in index order.
        self.pending: List[int] = [
            i for i in range(len(router.schedulers))
            if router.schedulers[i] is not None
            and router.health.state(i) == "live"
        ]
        #: the replica currently in probation, awaiting graduation.
        self.current: Optional[int] = None
        self.replaced: List[int] = []
        self.paused = False
        self._step_ticks = 0
        self._stalled = False
        if registry is None and not _obs.enabled():
            noop = _NoopInstrument()
            self._m_replaced = self._m_inprog = self._m_stalled = noop
        else:
            reg = registry if registry is not None else global_registry()
            self._m_replaced = reg.counter("serve.rollout.replaced")
            self._m_inprog = reg.gauge("serve.rollout.in_progress")
            self._m_stalled = reg.counter("serve.rollout.stalled")
        self._m_inprog.set(1.0 if self.pending else 0.0)

    @property
    def done(self) -> bool:
        return (
            not self.paused and self.current is None and not self.pending
        )

    def resume(self) -> None:
        """Operator acknowledgment after a mid-rollout death: continue
        with the remaining replicas (the dead one is the revival
        machinery's problem; if it was still pending it will be
        re-checked at its turn)."""
        self.paused = False
        self._m_inprog.set(0.0 if self.done else 1.0)

    def _pause(self, replica: int, why: str) -> None:
        self.paused = True
        self._m_inprog.set(0.0)
        if self.incidents is not None:
            try:
                self.incidents.file_incident(
                    "rollout_interrupted", severity="critical",
                    plane="serving",
                    detail={
                        "replica": replica, "why": why,
                        "replaced": list(self.replaced),
                        "pending": list(self.pending),
                    },
                )
            except Exception:  # pragma: no cover - incident I/O best-effort
                pass

    def tick(self) -> None:
        """One rollout step evaluation (call once per router tick)."""
        if self.paused or self.done:
            return
        health = self.router.health
        if self.current is not None:
            i = self.current
            st = health.state(i)
            if st == "dead":
                # The replacement died before graduating — stop the
                # rollout rather than march the fleet down.
                self._pause(i, "replacement died in probation")
                return
            if st != "live":
                self._step_ticks += 1
                if self._step_ticks > self.timeout_ticks \
                        and not self._stalled:
                    self._stalled = True
                    self._m_stalled.inc()
                return
            # Graduated — the health gate opens for the next replica.
            self.replaced.append(i)
            self._m_replaced.inc()
            self.current = None
            self._step_ticks = 0
            self._stalled = False
        while self.pending:
            i = self.pending.pop(0)
            st = health.state(i)
            if st == "dead":
                self._pause(i, "replica died awaiting its rollout turn")
                return
            if st not in ("live", "probation"):
                # Scaled away (draining/removed) while waiting — no
                # longer ours to replace.
                continue
            self.router.drain_replica(i)
            if health.state(i) == "dead":
                # Crashed during its own drain (the fault boundary
                # already harvested it) — pause, same discipline.
                self._pause(i, "replica crashed during rollout drain")
                return
            self.router.retire_replica(i)
            self.router.revive_replica(i, self._new_engine())
            self.current = i
            self._step_ticks = 0
            return
        self._m_inprog.set(0.0 if self.done else 1.0)

    def _new_engine(self):
        if self.params is not None:
            return self.engine_factory(params=self.params)
        return self.engine_factory()
