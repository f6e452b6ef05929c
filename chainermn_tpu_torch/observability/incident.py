"""Incident plane — declarative watch rules, auto-captured debug bundles.

The sensor planes (the metrics registry and flight records, the serving
SLO monitor, the memory plane and the capture watch) publish transient
signals — ``serve.slo.p95_drift``, ``compile.budget_exceeded``,
``mem.kv.leaked_blocks`` — that nobody tails, and by the time a human
looks the SLO window has rolled over.  This module watches them and turns
a breach into ONE deduplicated, causally-ordered debug bundle captured
*at the moment the rule fired*.

Three pieces:

* :class:`Watch` — one declarative rule: ``(name, metric, predicate,
  cooldown, severity)``.  The predicate is either a callable over the
  metric's live value or a tiny comparison grammar (``"> 0.5"``,
  ``">= 0"``, …); ``hysteresis`` requires N consecutive breaching
  evaluations before the rule fires (one noisy sample is not an
  incident).
* :class:`IncidentManager` — evaluates the rules against the live
  registry on the stack's EXISTING cadences (the serving scheduler's
  SLO-check cadence and its drain, the memory plane's leak check, the
  crash path — nothing new is polled), with per-rule cooldown
  (``CMN_OBS_INCIDENT_COOLDOWN_S``), fingerprint dedupe (one bundle per
  distinct incident per run), and a hard per-run cap
  (``CMN_OBS_INCIDENT_MAX``) so a flapping gauge can never fill a disk.
  A firing rule captures a bounded bundle under ``CMN_OBS_INCIDENT_DIR``
  (default ``$CMN_OBS_FLIGHT_DIR/incidents/``; neither set → the manager
  evaluates and counts but writes nothing, like the dormant flight
  recorder): the flight record (the keyed provider machinery verbatim),
  a Chrome-trace window cut from the span ring, a full metrics snapshot,
  the newest SLO report / KV-memory sample / capture-watch blames / usage
  snapshot, and a ``manifest.json`` whose causal timeline orders every
  correlated signal and names the first-mover plane.
* the **offline postmortem analyzer** —
  ``python -m chainermn_tpu_torch.observability.incident report <bundle>
  [--json]`` renders a captured bundle: firing rule, timeline,
  cross-plane correlations, artifact pointers.

Cost discipline: steady state is rule evaluation only — per rule, one
registry dict lookup (no instrument creation: :meth:`~chainermn_tpu_torch.
observability.metrics.MetricsRegistry.peek`) plus one predicate call, on
cadences the stack already pays.  Capture cost is paid only when a rule
fires, which is never the steady state.  Publishing follows the stack's
latch rule: an explicitly passed registry always publishes; otherwise
``CMN_OBS`` is latched at construction.

The serving fleet's rules (``router_backlog``, ``replica_dead``,
``poison_request``, ``migration_failed``, ``scale_flap``,
``rollout_stalled``) watch instruments the router, the failure plane,
the migration transport and the elastic controllers build;
:meth:`IncidentManager.file_incident` takes the rule-less
``rollout_interrupted`` capture.  A rule over an instrument this process never
built never fires.  The bundle's ``clock`` section carries the fleet
clock's cross-rank offsets once a :class:`~chainermn_tpu_torch.
observability.fleet.FleetClock` is noted (:meth:`IncidentManager.
note_fleet_clock`; ``MetricsReport(fleet_trace=)`` and
``export_fleet_trace`` note theirs), and is None before.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from chainermn_tpu_torch.observability import metrics as _metrics
from chainermn_tpu_torch.observability import tracing as _tracing

#: Manifest schema tag; bump on breaking layout changes.
INCIDENT_SCHEMA = "cmn-incident-1"

#: Per-rule re-fire cooldown, seconds — ``CMN_OBS_INCIDENT_COOLDOWN_S``.
DEFAULT_COOLDOWN_S = 60.0

#: Hard per-run bundle cap — ``CMN_OBS_INCIDENT_MAX``.
DEFAULT_MAX_INCIDENTS = 16

#: Chrome-trace window cut from the span ring, seconds —
#: ``CMN_OBS_INCIDENT_WINDOW_S``.
DEFAULT_WINDOW_S = 30.0

#: The manifest filename inside a bundle.
MANIFEST = "manifest.json"

#: Correlated headline signals snapshotted into every manifest (whichever
#: of them the registry actually holds) — the four planes' top-line
#: numbers, so a postmortem reads the cross-plane state without opening
#: ``metrics.json``.
HEADLINE_SIGNALS = (
    "serve.slo.p95_drift", "serve.slo.ttft.p95_ms",
    "serve.slo.queue_wait.p95_ms", "serve.slo.token.p95_ms",
    "serve.queue_depth", "serve.slot_occupancy",
    "serve.migration.failed", "serve.tenant.top_share",
    "serve.autoscale.replicas", "serve.rollout.in_progress",
    "fleet.straggler_rank", "fleet.straggler_stall_ms",
    "fleet.clock_rtt_ms",
    "compile.count", "compile.budget_exceeded",
    "mem.in_use_bytes", "mem.kv.occupancy", "mem.kv.leaked_blocks",
    "guard.consecutive_skips", "guard.rollbacks",
)

#: metric-name prefix → sensor plane (manifest / timeline attribution).
_PLANES = (
    ("serve.", "serving"),
    ("fleet.", "fleet"),
    ("compile.", "device"),
    ("device.", "device"),
    ("mem.", "memory"),
    ("guard.", "resilience"),
    ("hb.", "resilience"),
    ("ckpt.", "resilience"),
    ("train.", "training"),
    ("host_op.", "host"),
    ("incident.", "incident"),
)


def plane_of(metric: str) -> str:
    """The sensor plane a metric name belongs to (``"host"`` fallback)."""
    for prefix, plane in _PLANES:
        if metric.startswith(prefix):
            return plane
    return "host"


_PRED_RE = re.compile(r"^\s*(>=|<=|==|!=|>|<)\s*(-?[0-9.]+(?:e-?[0-9]+)?)\s*$")

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}


def compile_predicate(
    pred: Union[str, Callable[[float], bool]],
) -> Tuple[Callable[[float], bool], str]:
    """Resolve a rule predicate to ``(fn, description)``.  The string
    grammar is one comparison against a number (``"> 0.5"``, ``">= 0"``,
    ``"!= 0"``); anything richer passes a callable (described by its
    ``__name__``)."""
    if callable(pred):
        return pred, getattr(pred, "__name__", "<callable>")
    m = _PRED_RE.match(str(pred))
    if not m:
        raise ValueError(
            f"watch predicate {pred!r}: expected '<op> <number>' with op "
            f"in {sorted(_OPS)} (or a callable)"
        )
    op, threshold = m.group(1), float(m.group(2))
    fn = _OPS[op]
    return (lambda v, _f=fn, _t=threshold: _f(v, _t)), f"{op} {threshold:g}"


@dataclass
class Watch:
    """One declarative watch rule over a live registry instrument.

    ``metric`` names the instrument; the value judged is a gauge's /
    counter's current value, or a histogram's observation count.  An
    absent instrument (or a gauge never set) simply does not fire —
    rules for planes a process never builds are free.

    ``hysteresis`` = consecutive breaching evaluations required before
    firing; ``cooldown_s`` = None defers to the manager's default.
    ``key_by_value`` folds ``int(value)`` into the dedupe fingerprint
    (the fleet rule sets it: rank 2 stalling is a different incident
    than rank 0 stalling).
    """

    name: str
    metric: str
    predicate: Union[str, Callable[[float], bool]]
    severity: str = "warning"
    cooldown_s: Optional[float] = None
    hysteresis: int = 1
    plane: Optional[str] = None
    key_by_value: bool = False
    description: str = ""

    def __post_init__(self):
        if not re.fullmatch(r"[A-Za-z0-9_.-]+", self.name):
            raise ValueError(
                f"watch name {self.name!r}: letters/digits/_/./- only "
                "(it names the bundle directory)"
            )
        if self.severity not in ("info", "warning", "critical"):
            raise ValueError(
                f"watch {self.name}: severity must be info|warning|"
                f"critical, got {self.severity!r}"
            )
        if self.hysteresis < 1:
            raise ValueError(
                f"watch {self.name}: hysteresis must be >= 1"
            )
        self._fn, self._describe = compile_predicate(self.predicate)
        if self.plane is None:
            self.plane = plane_of(self.metric)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "metric": self.metric,
            "predicate": self._describe,
            "severity": self.severity,
            "plane": self.plane,
            "hysteresis": self.hysteresis,
            "description": self.description,
        }


def default_rules() -> List[Watch]:
    """The shipped rule set (the JAX package's): one watch per sensor
    plane's headline signal."""
    return [
        Watch(
            "slo_p95_drift", "serve.slo.p95_drift", "> 0.5",
            severity="warning",
            description="rolling p95 left the SLO envelope on the worst "
                        "serving stream (drift > tolerance)",
        ),
        Watch(
            "fleet_straggler", "fleet.straggler_rank", ">= 0",
            severity="warning", key_by_value=True,
            description="the gated fleet attribution named a straggler "
                        "rank (−1 = nobody, never fires)",
        ),
        Watch(
            "compile_budget", "compile.budget_exceeded", "> 0",
            severity="warning",
            description="a watched program compiled past its declared "
                        "budget (steady-state recompile)",
        ),
        Watch(
            "kv_leak", "mem.kv.leaked_blocks", "> 0",
            severity="critical",
            description="blocks still held after a drain + prefix-cache "
                        "gc — refcount drift",
        ),
        Watch(
            "router_backlog", "serve.router.queue_depth", "> 0",
            severity="warning", hysteresis=3,
            description="requests held back in the serving router's own "
                        "queue across consecutive evaluations — every "
                        "replica at its admission cap (fleet-wide "
                        "backpressure; the scale-out signal)",
        ),
        Watch(
            "tenant_starvation", "serve.policy.starved_tenant", ">= 0",
            severity="warning", hysteresis=3, key_by_value=True,
            description="a tenant's rolling queue-wait p95 breached "
                        "CMN_POLICY_STARVATION_MS across consecutive "
                        "evaluations — the policy plane's fair shares "
                        "or weights are mis-tuned for this load shape "
                        "(value = tenant index; −1 = nobody, never "
                        "fires; key_by_value: each starved tenant "
                        "files its own incident)",
        ),
        Watch(
            "migration_failed", "serve.migration.failed", "> 0",
            severity="critical",
            description="a KV-block migration frame was dropped or torn "
                        "on the p2p plane — the in-flight slots it "
                        "carried are gone (disaggregated serving's "
                        "request-loss signal)",
        ),
        Watch(
            "replica_dead", "serve.health.replica_dead", "> 0",
            severity="critical", key_by_value=True,
            description="a serving replica's tick escaped the router's "
                        "fault boundary — the fleet lost capacity and "
                        "its work was harvested onto survivors "
                        "(key_by_value: each additional death files)",
        ),
        Watch(
            "poison_request", "serve.health.poisoned", "> 0",
            severity="critical", key_by_value=True,
            description="a request exhausted its retry budget killing "
                        "replicas and was quarantined as a poisoned "
                        "Completion instead of re-dispatched forever "
                        "(key_by_value: each quarantine files)",
        ),
        Watch(
            "scale_flap", "serve.autoscale.flap", "> 0",
            severity="critical", key_by_value=True,
            description="the autoscaler wanted to reverse direction "
                        "inside its own cooldown — thresholds and "
                        "hysteresis are mis-tuned for this load shape "
                        "and the fleet would thrash "
                        "(key_by_value: each suppressed flap files)",
        ),
        Watch(
            "rollout_stalled", "serve.rollout.stalled", "> 0",
            severity="critical", key_by_value=True,
            description="one rolling-deploy step (drain + probation "
                        "graduation) exceeded "
                        "CMN_SERVE_ROLLOUT_TIMEOUT_TICKS — the "
                        "replacement replica is not graduating and the "
                        "rollout is wedged "
                        "(key_by_value: each stalled step files)",
        ),
        Watch(
            "replication_fallback", "train.rep.fallback", "> 0",
            severity="critical", key_by_value=True,
            description="a supervised relaunch could not assemble a "
                        "peer-restore quorum (missing/mismatched shards "
                        "or a world-size change) and fell back to the "
                        "orbax restore — recovery paid full checkpoint "
                        "I/O and lost work since the last durable save "
                        "(key_by_value: each fallback files)",
        ),
        Watch(
            "replication_lost_steps", "train.rep.lost_steps_excess",
            "> 0", severity="critical",
            description="a fast restore lost more work than one "
                        "replication cadence — the ≤-cadence loss bound "
                        "the replication plane exists to guarantee was "
                        "violated",
        ),
        Watch(
            "replication_torn", "train.rep.torn", "> 0",
            severity="warning",
            description="a replication frame or spill file failed "
                        "schema/crc/digest validation and was discarded "
                        "— a torn replica never installs, but repeated "
                        "tears mean the replication plane is degraded",
        ),
    ]


class _RuleState:
    __slots__ = ("consecutive", "active", "breach_since", "last_value",
                 "last_fired_t", "latched_fp")

    def __init__(self):
        self.consecutive = 0
        self.active = False          # fired and still breaching (latched)
        self.breach_since: Optional[float] = None  # perf_counter base
        self.last_value: Optional[float] = None
        self.last_fired_t: Optional[float] = None  # manager clock base
        #: fingerprint the latch was set with — a key_by_value rule whose
        #: breaching IDENTITY changes mid-breach re-arms against it.
        self.latched_fp: Optional[str] = None


#: Shared tolerant env-number parse (metrics.py — one definition for
#: every observability knob).
_env_float = _metrics._env_float


def _iso(wall_s: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(wall_s))


class IncidentManager:
    """Rules engine + bundle capture for one process.

    Args:
      registry: a :class:`~chainermn_tpu_torch.observability.MetricsRegistry`.
        ``None`` resolves like every other publisher: the global
        registry while observability is enabled (latched here), no-op
        otherwise.
      rules: the watch list (default :func:`default_rules`).
      directory: where bundles land.  ``None`` resolves from
        ``CMN_OBS_INCIDENT_DIR``, then ``$CMN_OBS_FLIGHT_DIR/incidents``,
        else the manager runs dormant (rules evaluate and count, nothing
        is written — the flight recorder's discipline).
      cooldown_s / max_incidents / window_s: env-backed knobs (see the
        module docstring).
      time_fn: injectable cooldown clock (tests) — the trace window and
        timeline always use the span clock (``perf_counter``).
    """

    def __init__(self, registry=None, rules: Optional[Sequence[Watch]] = None,
                 directory: Optional[str] = None,
                 cooldown_s: Optional[float] = None,
                 max_incidents: Optional[int] = None,
                 window_s: Optional[float] = None,
                 time_fn: Optional[Callable[[], float]] = None):
        import chainermn_tpu_torch.observability as _obs

        self._explicit = registry is not None
        self._enabled = self._explicit or _obs.enabled()
        self._registry_fn = (
            (lambda: registry) if registry is not None else _metrics.registry
        )
        self.rules: List[Watch] = list(
            default_rules() if rules is None else rules
        )
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }
        if directory is None:
            directory = os.environ.get("CMN_OBS_INCIDENT_DIR") or ""
            if not directory:
                flight_dir = os.environ.get("CMN_OBS_FLIGHT_DIR", "")
                directory = (
                    os.path.join(flight_dir, "incidents") if flight_dir
                    else None
                )
        self.directory = directory or None
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _env_float("CMN_OBS_INCIDENT_COOLDOWN_S",
                            DEFAULT_COOLDOWN_S)
        )
        self.max_incidents = int(
            max_incidents if max_incidents is not None
            else _env_float("CMN_OBS_INCIDENT_MAX", DEFAULT_MAX_INCIDENTS)
        )
        self.window_s = float(
            window_s if window_s is not None
            else _env_float("CMN_OBS_INCIDENT_WINDOW_S", DEFAULT_WINDOW_S)
        )
        if self.max_incidents < 1:
            raise ValueError(
                f"max_incidents must be >= 1: {self.max_incidents}"
            )
        self._now = time_fn if time_fn is not None else time.monotonic
        self._lock = threading.Lock()
        #: filed manifests, oldest first (bounded by the run cap).
        self.incidents: List[dict] = []
        self._fingerprints: set = set()
        self.count = 0
        self.dropped = 0
        #: extra bundle sections: name -> zero-arg callable (keyed — a
        #: re-registering subsystem replaces its own entry; hold state
        #: via weakref so a dropped scheduler reads ``{"released":
        #: true}``, the flight provider pattern).
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._fleet_clock: Optional[weakref.ref] = None
        if self._enabled:
            self._install_builtin_sources()
            global _latest_manager
            _latest_manager = weakref.ref(self)
            _install_provider()

    # ------------------------------------------------------------- plumbing
    def _reg(self):
        return self._registry_fn()

    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Contribute a section to every future bundle's ``signals.json``
        (keyed; latest registration wins).  Callers holding live objects
        pass a weakref'd closure — the serving scheduler registers
        ``"serving"`` (its live slot map) and ``"slo"`` (the newest SLO
        report) exactly like its flight provider."""
        with self._lock:
            self._sources[name] = fn

    def note_fleet_clock(self, clock) -> None:
        """Record the run's :class:`~chainermn_tpu_torch.observability.
        fleet.FleetClock` (weakly), so manifests carry the clock offsets
        their timelines are judged against."""
        self._fleet_clock = weakref.ref(clock)

    def _clock_meta(self) -> Optional[dict]:
        clock = self._fleet_clock() if self._fleet_clock is not None \
            else None
        if clock is None:
            return None
        try:
            worst = max((o.rtt_s for o in (clock.offsets or {}).values()),
                        default=0.0)
            return {"synced": clock.synced_at is not None,
                    "offsets_s": {str(k): round(v, 9)
                                  for k, v in clock.offsets_s().items()},
                    "worst_rtt_ms": round(worst * 1e3, 3)}
        except Exception:
            return None

    def _install_builtin_sources(self) -> None:
        """The newest KV-memory sample and the capture watch's records
        and blames ride every bundle without any caller wiring — both
        planes already keep process-wide state behind weakrefs."""

        def _memory() -> dict:
            from chainermn_tpu_torch.observability import memory as _omem

            return _omem._flight_section()

        def _compile() -> dict:
            from chainermn_tpu_torch.observability import device as _odevice

            w = _odevice.watch()
            return {"ledger": w.flight_section(), "blames": w.blames()}

        self._sources.setdefault("memory", _memory)
        self._sources.setdefault("compile", _compile)

    def _read(self, metric: str) -> Optional[float]:
        """Live value of an instrument WITHOUT creating it: gauges and
        counters read their value, histograms their count; absent (or
        never-set) instruments read None and never fire."""
        inst = self._reg().peek(metric)
        if inst is None:
            return None
        if isinstance(inst, _metrics.Histogram):
            return float(inst.count)
        v = inst.value
        return None if v is None else float(v)

    # ------------------------------------------------------------ evaluation
    def evaluate(self) -> List[dict]:
        """One pass over every rule against the live registry; returns
        the manifests filed this pass (usually empty).  This is the only
        steady-state entry point — a registry lookup and a predicate per
        rule, nothing else, on cadences the stack already pays."""
        if not self._enabled:
            return []
        filed: List[dict] = []
        open_count = 0
        for rule in list(self.rules):
            st = self._state[rule.name]
            value = self._read(rule.metric)
            breach = value is not None and bool(rule._fn(value))
            if not breach:
                st.consecutive = 0
                st.active = False
                st.breach_since = None
                continue
            st.last_value = value
            st.consecutive += 1
            if st.breach_since is None:
                st.breach_since = time.perf_counter()
            open_count += 1
            fp = self._fingerprint(rule, value)
            if st.active and fp != st.latched_fp:
                # The breaching identity moved without clearing first (a
                # key_by_value rule now watching a DIFFERENT rank) — a
                # distinct incident, so the latch re-arms.
                st.active = False
            if st.active or st.consecutive < rule.hysteresis:
                continue  # already captured this breach / hysteresis arming
            st.active = True
            st.latched_fp = fp
            manifest = self._file(rule, value, st, fp)
            if manifest is not None:
                filed.append(manifest)
        try:
            self._reg().gauge("incident.open").set(open_count)
        except Exception:
            pass
        return filed

    def _fingerprint(self, rule: Watch, value: Optional[float]) -> str:
        key = rule.name
        if rule.key_by_value and value is not None:
            key += f":{int(value)}"
        return key

    def _file(self, rule: Watch, value: Optional[float],
              st: _RuleState, fp: str) -> Optional[dict]:
        """Gatekeeping (cooldown → fingerprint dedupe → run cap) then
        capture.  Every suppression counts into ``incident.dropped`` —
        a silent drop would read as 'nothing fired'."""
        now = self._now()
        with self._lock:
            if st.last_fired_t is not None and \
                    now - st.last_fired_t < self.cooldown_s:
                reason = "cooldown"
            elif fp in self._fingerprints:
                reason = "dedupe"
            elif self.count >= self.max_incidents:
                reason = "cap"
            else:
                reason = None
                st.last_fired_t = now
                self._fingerprints.add(fp)
                self.count += 1
                seq = self.count
        if reason is not None:
            self.dropped += 1
            try:
                self._reg().counter("incident.dropped").inc()
            except Exception:
                pass
            return None
        manifest = self._capture(
            seq, rule.to_dict(), rule.severity, rule.plane, value, fp,
            detail=None, breach_since=st.breach_since,
        )
        return manifest

    def file_incident(self, name: str, severity: str = "critical",
                      plane: str = "resilience", detail=None,
                      value: Optional[float] = None) -> Optional[dict]:
        """Forced capture for rule-less events (a rolling deploy that
        pauses on a replica's death files one).  Bypasses hysteresis,
        cooldown and dedupe — such events are rare and each one matters
        — but still respects the per-run cap and the ``CMN_OBS``
        latch."""
        if not self._enabled:
            return None
        with self._lock:
            capped = self.count >= self.max_incidents
            if not capped:
                self.count += 1
                seq = self.count
        if capped:
            self.dropped += 1
            try:
                self._reg().counter("incident.dropped").inc()
            except Exception:
                pass
            return None
        rule = {
            "name": name, "metric": None, "predicate": "forced",
            "severity": severity, "plane": plane, "hysteresis": 1,
            "description": detail or "",
        }
        return self._capture(seq, rule, severity, plane, value,
                             fingerprint=f"forced:{name}:{seq}",
                             detail=detail, breach_since=None)

    # --------------------------------------------------------------- capture
    @property
    def newest_path(self) -> Optional[str]:
        with self._lock:
            for m in reversed(self.incidents):
                if m.get("bundle"):
                    return m["bundle"]
        return None

    def _capture(self, seq: int, rule: dict, severity: str, plane: str,
                 value: Optional[float], fingerprint: str,
                 detail: Optional[str],
                 breach_since: Optional[float]) -> Optional[dict]:
        """Build the manifest (+ bundle on disk when a directory is
        configured).  Never raises — an incident capture must not make
        the incident worse."""
        try:
            t_mono = time.perf_counter()
            timeline = self._timeline(rule, plane, value, breach_since,
                                      t_mono)
            suspect = self._read("fleet.straggler_rank")
            suspect_rank = (
                int(suspect) if suspect is not None and suspect >= 0
                else None
            )
            # Rank in the id: rank-synchronized events (a guard
            # escalation) file on EVERY rank into one shared incidents
            # dir — per-rank ids keep the bundles from clobbering each
            # other.
            manifest = {
                "schema": INCIDENT_SCHEMA,
                "id": f"incident-r{_default_rank()}-{seq:04d}-"
                      f"{rule['name']}",
                "rule": rule,
                "severity": severity,
                "plane": plane,
                "value": value,
                "fingerprint": fingerprint,
                "rank": _default_rank(),
                "pid": os.getpid(),
                "wall_time": _iso(_tracing.mono_to_wall(t_mono)),
                "t_mono": round(t_mono, 6),
                "signals": self._signals(),
                "timeline": timeline,
                # First mover = the plane whose RULE breached earliest.
                # Context entries (compile events, errored spans) stay in
                # the timeline but don't vote: a warmup compile minutes
                # before an SLO breach is background, not the mover.
                "first_mover": next(
                    (e["plane"] for e in timeline
                     if e["signal"].startswith("rule:")),
                    plane,
                ),
                "suspect_rank": suspect_rank,
                "clock": self._clock_meta(),
                "dup_count": 0,
            }
            if detail:
                manifest["detail"] = detail
            manifest["bundle"] = self._write_bundle(manifest)
            with self._lock:
                self.incidents.append(manifest)
            try:
                self._reg().counter("incident.count").inc()
            except Exception:
                pass
            if manifest["bundle"]:
                sys.stderr.write(
                    f"[chainermn_tpu_torch.incident] {severity} "
                    f"{manifest['id']} ({rule.get('metric') or 'forced'}"
                    f"{'' if value is None else f'={value:g}'}) -> "
                    f"{manifest['bundle']}\n"
                )
                sys.stderr.flush()
            return manifest
        except Exception:  # pragma: no cover - capture must never raise
            try:
                sys.stderr.write(
                    "[chainermn_tpu_torch.incident] capture failed: "
                    + traceback.format_exc(limit=2)
                )
            except Exception:
                pass
            return None

    def _signals(self) -> Dict[str, Optional[float]]:
        """Correlated cross-plane headline values at capture time: every
        HEADLINE signal the registry holds, plus every watched metric."""
        out: Dict[str, Optional[float]] = {}
        names = list(HEADLINE_SIGNALS) + [
            r.metric for r in self.rules if r.metric
        ]
        for name in names:
            if name in out:
                continue
            v = self._read(name)
            if v is not None:
                out[name] = v
        return out

    def _timeline(self, rule: dict, plane: str, value: Optional[float],
                  breach_since: Optional[float],
                  t_mono: float) -> List[dict]:
        """The causal timeline: every correlated signal ordered on the
        span clock (the same monotonic base the fleet plane's offsets
        correct between ranks — manifest ``clock`` carries that
        metadata).  Entries: other rules currently in breach, compile
        events inside the trace window, the last errored span, and the
        firing event itself."""
        entries: List[dict] = []

        def add(t: Optional[float], plane_: str, signal: str, **kw):
            if t is None:
                t = t_mono
            e = {"t_mono": round(float(t), 6),
                 "wall_time": _iso(_tracing.mono_to_wall(float(t))),
                 "plane": plane_, "signal": signal}
            e.update({k: v for k, v in kw.items() if v is not None})
            entries.append(e)

        add(breach_since, plane, f"rule:{rule['name']}",
            metric=rule.get("metric"), value=value)
        for other in self.rules:
            if other.name == rule["name"]:
                continue
            st = self._state.get(other.name)
            if st is not None and st.breach_since is not None:
                add(st.breach_since, other.plane, f"rule:{other.name}",
                    metric=other.metric, value=st.last_value,
                    rank=(int(st.last_value)
                          if other.key_by_value
                          and st.last_value is not None else None))
        cut = t_mono - self.window_s
        try:
            from chainermn_tpu_torch.observability import device as _odevice

            for rec in _odevice.watch().records():
                t = rec.get("t_mono")
                if t is not None and t >= cut:
                    add(t, "device", "compile",
                        program=rec.get("program"),
                        recompile=bool(rec.get("diff")))
        except Exception:
            pass
        try:
            err = _tracing.tracer().last_error()
            if err is not None and err.get("t_mono", 0.0) >= cut:
                add(err["t_mono"], "host", f"span_error:{err['op']}",
                    error=err.get("error"))
        except Exception:
            pass
        entries.sort(key=lambda e: e["t_mono"])
        return entries

    def _write_bundle(self, manifest: dict) -> Optional[str]:
        """The bounded on-disk bundle; returns its directory, or None
        when the manager is dormant (no directory configured)."""
        if self.directory is None:
            return None
        from chainermn_tpu_torch.observability import aggregate as _oagg
        from chainermn_tpu_torch.observability import flight as _flight

        bundle = os.path.join(self.directory, manifest["id"])
        if os.path.exists(os.path.join(bundle, MANIFEST)):
            # A prior run/attempt sharing this incidents dir already
            # filed this id (per-process seqs restart on a supervised
            # relaunch) — uniquify rather than clobber the evidence
            # being debugged.
            base = f"{bundle}-p{os.getpid()}"
            bundle, n = base, 2
            while os.path.exists(os.path.join(bundle, MANIFEST)):
                bundle = f"{base}.{n}"
                n += 1
            manifest["id"] = os.path.basename(bundle)
        os.makedirs(bundle, exist_ok=True)
        artifacts: Dict[str, str] = {}

        def dump(name: str, payload) -> None:
            path = os.path.join(bundle, name)
            with open(path, "w") as f:
                json.dump(_oagg.sanitize_json(payload), f)
            artifacts[name.split(".")[0]] = name

        # 1. The flight record — the keyed-provider machinery verbatim
        # (guard_report / serving / memory / compile sections included).
        rec = _flight.FlightRecorder(bundle, rank=manifest["rank"])
        if rec.record("incident",
                      extra={"incident": manifest["id"]}) is not None:
            artifacts["flight"] = os.path.basename(rec.path)
        # 2. Full metrics snapshot.
        dump("metrics.json", self._reg().snapshot())
        # 3. Chrome-trace window cut from the span ring (Perfetto-
        # loadable, one process = this rank).
        try:
            cut = manifest["t_mono"] - self.window_s
            spans = [
                s for s in _tracing.tracer().ring.snapshot()
                if s.get("t_mono", 0.0) >= cut
            ]
            dump("trace.json", {
                "traceEvents": _tracing.chrome_span_events(
                    spans, rank=manifest["rank"]
                ),
                "displayTimeUnit": "ms",
            })
        except Exception:
            pass
        # 4. The newest per-plane state the registered sources hold
        # (SLO report, KV sample, compile blames, live slot map, ...).
        with self._lock:
            sources = list(self._sources.items())
        signals = {}
        for name, fn in sources:
            try:
                signals[name] = fn()
            except Exception as e:
                signals[name] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }
        dump("signals.json", signals)
        # 5. The manifest LAST: a bundle without one is visibly torn.
        manifest["artifacts"] = artifacts
        with open(os.path.join(bundle, MANIFEST), "w") as f:
            json.dump(_oagg.sanitize_json(manifest), f, indent=1)
        return bundle


# ------------------------------------------------------ process-wide wiring
_manager: Optional[IncidentManager] = None
_manager_lock = threading.Lock()
#: Newest manager (weakref) — what the ``"incidents"`` flight provider
#: reads (explicit test managers replace the view, like ``"memory"``).
_latest_manager: Optional[weakref.ref] = None
_provider_installed = False
_provider_lock = threading.Lock()


def _default_rank() -> int:
    from chainermn_tpu_torch.observability import flight as _flight

    return _flight._default_rank()


def manager() -> IncidentManager:
    """THE per-process incident manager (lazy, like the registry): the
    default rule set against the global registry, directory resolved
    from the env, ``CMN_OBS`` latched at first use."""
    global _manager
    if _manager is None:
        with _manager_lock:
            if _manager is None:
                _manager = IncidentManager()
    return _manager


def run_stats() -> dict:
    """The run's incident accounting, compact: bundles filed and dropped,
    and the newest bundle's path (None while there is none)."""
    m = _manager
    if m is None:
        return {"count": 0, "dropped": 0, "newest": None}
    return {"count": m.count, "dropped": m.dropped,
            "newest": m.newest_path}


def evaluate_if_built() -> None:
    """Evaluate the process manager IF something already wired it — the
    crash/preemption/escalation paths call this so a dying process's
    final registry state is judged, without the crash path constructing
    a plane the run never used.  Never raises."""
    m = _manager
    if m is None:
        return
    try:
        m.evaluate()
    except Exception:
        pass


def _flight_section() -> dict:
    m = _latest_manager() if _latest_manager is not None else None
    if m is None:
        return {"released": True}
    return {
        "count": m.count,
        "dropped": m.dropped,
        "open_rules": [
            r.name for r in m.rules if m._state[r.name].active
        ],
        "newest": m.newest_path,
    }


def _install_provider() -> None:
    global _provider_installed
    with _provider_lock:
        if _provider_installed:
            return
        from chainermn_tpu_torch.observability import flight as _flight

        _flight.register_provider("incidents", _flight_section)
        _provider_installed = True


# --------------------------------------------------------- offline analyzer
def resolve_bundle(path: str) -> str:
    """Resolve the CLI argument to one bundle directory: a bundle dir
    (holds ``manifest.json``), a ``manifest.json`` path, or an incidents
    ROOT dir (holds ``incident-*`` bundles — newest wins, so the
    launcher's printed pointer pastes straight into ``report``)."""
    if os.path.isfile(path):
        return os.path.dirname(os.path.abspath(path)) or "."
    if os.path.isfile(os.path.join(path, MANIFEST)):
        return path
    bundles = [
        d for d in (os.listdir(path) if os.path.isdir(path) else ())
        if d.startswith("incident-")
        and os.path.isfile(os.path.join(path, d, MANIFEST))
    ]
    if bundles:
        # Newest by manifest mtime, name as the tiebreak: bundle NAMES
        # sort by rank before sequence (incident-r2-0001 > r0-0002), so
        # lexicographic order would crown the highest RANK, not the
        # latest capture.
        bundles.sort(key=lambda d: (
            os.path.getmtime(os.path.join(path, d, MANIFEST)), d
        ))
        return os.path.join(path, bundles[-1])
    raise FileNotFoundError(
        f"{path}: not an incident bundle (no {MANIFEST}) and not an "
        f"incidents directory containing one"
    )


def load_report(path: str) -> dict:
    """The machine-readable postmortem for one bundle: the manifest plus
    an artifact inventory (present / bytes / parses)."""
    bundle = resolve_bundle(path)
    with open(os.path.join(bundle, MANIFEST)) as f:
        manifest = json.load(f)
    inventory = {}
    for key, name in (manifest.get("artifacts") or {}).items():
        p = os.path.join(bundle, name)
        entry = {"file": name, "present": os.path.isfile(p)}
        if entry["present"]:
            entry["bytes"] = os.path.getsize(p)
            if name.endswith(".json"):
                try:
                    with open(p) as f:
                        json.load(f)
                    entry["parses"] = True
                except ValueError:
                    entry["parses"] = False
        inventory[key] = entry
    return {"bundle": bundle, "manifest": manifest,
            "artifacts": inventory}


def _render(report: dict) -> None:
    m = report["manifest"]
    rule = m.get("rule") or {}
    print(f"incident  {m.get('id')}  severity={m.get('severity')}  "
          f"plane={m.get('plane')}")
    pred = rule.get("predicate")
    metric = rule.get("metric") or "(forced)"
    val = m.get("value")
    print(f"rule:     {rule.get('name')}  [{metric} {pred}]"
          + (f"  value={val:g}" if isinstance(val, (int, float)) else ""))
    print(f"filed:    {m.get('wall_time')}  rank {m.get('rank')}  "
          f"pid {m.get('pid')}")
    if m.get("detail"):
        print(f"detail:   {m['detail']}")
    who = m.get("suspect_rank")
    print(f"first mover: {m.get('first_mover')}    suspect rank: "
          f"{'none' if who is None else who}")
    timeline = m.get("timeline") or []
    if timeline:
        t0 = timeline[0]["t_mono"]
        print("timeline:")
        for e in timeline:
            extra = "  ".join(
                f"{k}={e[k]}" for k in ("metric", "value", "program",
                                        "rank", "error")
                if e.get(k) is not None
            )
            print(f"  +{e['t_mono'] - t0:9.3f}s  {e['plane']:<10} "
                  f"{e['signal']:<28} {extra}")
    signals = m.get("signals") or {}
    if signals:
        print("correlated signals:")
        for name in sorted(signals):
            print(f"  {name:<34} {signals[name]:g}")
    print("artifacts:")
    for key, entry in sorted((report.get("artifacts") or {}).items()):
        status = "missing" if not entry.get("present") else (
            f"{entry.get('bytes', 0)} bytes"
            + ("" if entry.get("parses", True) else ", DOES NOT PARSE")
        )
        print(f"  {key:<10} {entry.get('file'):<26} {status}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.observability.incident",
        description="Offline postmortem analyzer for captured incident "
                    "bundles.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    rep = sub.add_parser(
        "report", help="render one bundle's postmortem (firing rule, "
                       "causal timeline, cross-plane correlations, "
                       "artifact pointers)",
    )
    rep.add_argument("bundle",
                     help="bundle dir, its manifest.json, or an "
                          "incidents root dir (newest bundle wins)")
    rep.add_argument("--json", action="store_true",
                     help="emit the machine-readable report instead of "
                          "the rendering")
    args = ap.parse_args(argv)
    report = load_report(args.bundle)
    if args.json:
        print(json.dumps(report))
        return 0
    _render(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
