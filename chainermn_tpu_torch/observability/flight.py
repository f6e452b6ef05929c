"""Flight recorder — a per-rank black box for post-mortems.

When a process dies, everything it knew dies with it: the span it was
blocked in, its metric history, the serving state that explains *why*.
The flight recorder snapshots all of that to a per-rank JSONL file at the
moments that matter:

* an uncaught crash — :func:`snapshot_on_crash` (a crash handler calls
  it), which names the reason by the exception's class and lifts any
  attribution it carries (peer, op, kind, ...) into the record;
* incident capture — the incident plane writes one record into each
  bundle;
* ``SIGUSR1`` — poke a *live* process for a snapshot without stopping it
  (``kill -USR1 <pid>``; the handler only appends a JSONL line).

Records are **append-only JSONL** (one self-contained JSON object per
line, schema :data:`FLIGHT_SCHEMA`) at
``$CMN_OBS_FLIGHT_DIR/flight.rank<R>.jsonl`` (``R`` from ``RANK``, as
``torchrun`` sets it).  Without that env var the recorder is dormant
(single-process scripts can construct one explicitly).
``CMN_OBS_FLIGHT=0`` disables it outright.

Failure discipline: the recorder must never make a bad day worse — every
entry point swallows its own errors (a full disk at crash time loses the
record, not the attributed traceback on stderr).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from chainermn_tpu_torch.observability import metrics as _metrics
from chainermn_tpu_torch.observability import tracing as _tracing

#: Record schema tag; bump on breaking layout changes.
FLIGHT_SCHEMA = "cmn-flight-1"

#: State providers: name -> zero-arg callable returning a
#: JSON-serializable dict (the serving slot map, memory, ...).  Survives
#: recorder re-creation; keyed so a re-registering subsystem replaces its
#: own entry instead of stacking duplicates.
_providers: Dict[str, Callable[[], dict]] = {}
_providers_lock = threading.Lock()


def register_provider(name: str, fn: Callable[[], dict]) -> None:
    """Contribute a section to every future record's ``resilience`` map
    (the JAX package's layout).  The serving scheduler registers
    ``serving`` (live slot map, allocator occupancy, queue depth,
    in-flight request ids); the memory monitor registers ``memory``
    (fresh device-memory watermarks + the newest KV-pool sample); the
    ledger ``usage``, the capture watch ``compile``, the incident
    manager ``incidents``."""
    with _providers_lock:
        _providers[name] = fn


def _default_rank() -> int:
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


class FlightRecorder:
    """Appends snapshot records to one per-rank JSONL file.

    Retention: the file keeps the newest ``CMN_OBS_FLIGHT_MAX`` records
    (default 64; ``0`` disables pruning).  Under a supervised relaunch
    loop with an explicit ``CMN_OBS_FLIGHT_DIR``, every attempt appends
    to the SAME per-rank file — one record per crash/SIGUSR1, forever —
    so without the cap a long-lived flaky deployment grows its black box
    without bound.  Oldest records prune first; the crash being debugged
    is always the newest."""

    def __init__(self, directory: str, rank: Optional[int] = None):
        self.rank = _default_rank() if rank is None else int(rank)
        self.directory = directory
        self.path = os.path.join(
            directory, f"flight.rank{self.rank}.jsonl"
        )
        self.max_records = int(
            _metrics._env_float("CMN_OBS_FLIGHT_MAX", 64)
        )
        self._line_count: Optional[int] = None

    # ------------------------------------------------------------- recording
    def record(self, reason: str, exc: Optional[BaseException] = None,
               extra: Optional[dict] = None) -> Optional[str]:
        """Write one record; returns the file path, or None on any failure
        (including a non-serializable provider — the record is written
        with that section replaced by an error note, not dropped)."""
        try:
            from chainermn_tpu_torch.observability import aggregate as _oagg

            entry = _oagg.sanitize_json(self._build(reason, exc, extra))
            os.makedirs(self.directory, exist_ok=True)
            line = json.dumps(entry, default=_best_effort_json)
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
                try:
                    os.fsync(f.fileno())
                except OSError:
                    pass
            try:
                self._prune()
            except Exception:
                pass  # retention is best-effort; the record landed
            return self.path
        except Exception:  # pragma: no cover - last-resort guard
            try:
                sys.stderr.write(
                    "[chainermn_tpu_torch.flight] failed to write flight record: "
                    + traceback.format_exc(limit=2)
                )
            except Exception:
                pass
            return None

    def _prune(self) -> None:
        """Oldest-first retention (``CMN_OBS_FLIGHT_MAX``).  Record
        events are rare (crash / SIGUSR1), so the occasional full-file
        read is off every hot path; the rewrite is atomic so a reader
        never sees a torn file.  The cached line count only delays
        pruning when another recorder shares the file — the rewrite
        recounts from the file itself, so the cap self-corrects."""
        if self.max_records <= 0:
            return
        if self._line_count is None:
            with open(self.path) as f:
                self._line_count = sum(1 for _ in f)
        else:
            self._line_count += 1
        if self._line_count <= self.max_records:
            return
        with open(self.path) as f:
            lines = f.readlines()
        keep = lines[-self.max_records:]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(keep)
        os.replace(tmp, self.path)
        self._line_count = len(keep)

    def _build(self, reason: str, exc: Optional[BaseException],
               extra: Optional[dict]) -> dict:
        tr = _tracing.tracer()
        reg = _metrics.registry()
        entry = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "rank": self.rank,
            "pid": os.getpid(),
            "wall_time": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            # What this rank is (or was last) doing — the one-liner a
            # post-mortem reads first.
            "in_flight_span": tr.current_span_name(),
            "open_spans": tr.in_flight(),
            "last_error_span": tr.last_error(),
            "spans": tr.ring.snapshot(),
            "spans_evicted": tr.ring.total - len(tr.ring),
            "metrics": reg.snapshot(),
            "metric_samples": reg.last_samples(),
            "resilience": {},
        }
        with _providers_lock:
            provs = list(_providers.items())
        for name, fn in provs:
            try:
                entry["resilience"][name] = fn()
            except Exception as e:
                entry["resilience"][name] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }
        if exc is not None:
            err = {
                "type": type(exc).__name__,
                "message": str(exc)[:500],
            }
            # Attributed resilience errors carry who/what/why — lift them.
            for attr in ("peer", "op", "kind", "reason", "divergent",
                         "step", "no_majority", "iteration"):
                v = getattr(exc, attr, None)
                if v is not None and not callable(v):
                    err[attr] = v
            entry["error"] = err
        if extra:
            entry["extra"] = dict(extra)
        return entry


def _best_effort_json(obj):
    """Flight records must land even when a provider leaks a numpy scalar
    or similar — stringify rather than raise."""
    try:
        import numpy as np

        if isinstance(obj, np.generic):
            return obj.item()
    except Exception:
        pass
    return str(obj)


# ------------------------------------------------------- process-wide wiring
_recorder: Optional[FlightRecorder] = None
_recorder_built = False
_recorder_lock = threading.Lock()
_sigusr1_installed = False


def recorder() -> Optional[FlightRecorder]:
    """The env-configured per-process recorder: built from
    ``CMN_OBS_FLIGHT_DIR`` on first use (None when unset or when
    ``CMN_OBS_FLIGHT=0``); installs the ``SIGUSR1`` snapshot handler as a
    side effect when possible (main thread only, per the signal API)."""
    global _recorder, _recorder_built
    if not _recorder_built:
        with _recorder_lock:
            if not _recorder_built:
                directory = os.environ.get("CMN_OBS_FLIGHT_DIR", "")
                if directory and \
                        os.environ.get("CMN_OBS_FLIGHT", "1") != "0":
                    _recorder = FlightRecorder(directory)
                _recorder_built = True
    if _recorder is not None:
        # Retried on EVERY access (idempotent flag inside): the first
        # build may happen off the main thread (a worker-thread crash
        # path), where signal.signal raises — a later main-thread caller
        # (a Scheduler's constructor) must still get the live-snapshot
        # handler.
        _install_sigusr1()
    return _recorder


def _install_sigusr1() -> None:
    global _sigusr1_installed
    if _sigusr1_installed:
        return
    try:
        def _on_usr1(signum, frame):
            rec = _recorder
            if rec is None:
                return

            # The handler executes ON the interrupted main thread, which
            # may be holding a tracer/registry/instrument lock (all
            # non-reentrant) at the moment of delivery — recording inline
            # would self-deadlock acquiring a lock whose owner is the
            # suspended frame below.  Hand the write to a fresh daemon
            # thread: the main thread resumes (and releases its locks)
            # immediately; the writer blocks briefly, then snapshots.
            def _write():
                path = rec.record("sigusr1")
                if path:
                    sys.stderr.write(
                        f"[chainermn_tpu_torch.flight] SIGUSR1 snapshot -> "
                        f"{path}\n"
                    )
                    sys.stderr.flush()

            threading.Thread(
                target=_write, name="cmn-flight-usr1", daemon=True
            ).start()

        signal.signal(signal.SIGUSR1, _on_usr1)
        _sigusr1_installed = True
    except (ValueError, OSError, AttributeError):
        # Not the main thread (or no SIGUSR1 on this platform): the
        # recorder still works for crash/exit snapshots.
        pass


#: Crash reasons by exception class name, matched along the class's MRO
#: (the JAX package's vocabulary): :mod:`~chainermn_tpu_torch.resilience`'s
#: ``RankDivergedError``, ``PeerFailedError``, ``HealthEscalationInterrupt``
#: and :class:`~chainermn_tpu_torch.resilience.preemption.
#: PreemptionInterrupt` (the exit-75 record).  Matched by name, so this
#: module imports none of them.
CRASH_REASONS = {
    "RankDivergedError": "rank_diverged",
    "PeerFailedError": "peer_failed",
    "PreemptionInterrupt": "preemption_exit",
    "HealthEscalationInterrupt": "health_escalation_exit",
}


def crash_reason(exc: BaseException) -> str:
    """The flight-record reason for ``exc``: the first
    :data:`CRASH_REASONS` entry along its class's MRO, else ``"crash"``."""
    for cls in type(exc).__mro__:
        reason = CRASH_REASONS.get(cls.__name__)
        if reason is not None:
            return reason
    return "crash"


def snapshot_on_crash(exc: BaseException) -> Optional[str]:
    """Crash-path entry point (a crash handler calls it with the
    escaping exception).  Never raises."""
    try:
        # Incident plane: judge the dying process's final registry state
        # against the watch rules BEFORE the crash record, so a breach
        # that killed the run leaves a bundle next to the flight record.
        # Only when the run already wired the plane — a crash must not
        # construct one.
        from chainermn_tpu_torch.observability import incident as _oincident

        _oincident.evaluate_if_built()
    except Exception:
        pass
    try:
        rec = recorder()
        if rec is None:
            return None
        reason = crash_reason(exc)
        path = rec.record(reason, exc=exc)
        if path:
            sys.stderr.write(
                f"[chainermn_tpu_torch.flight] {reason} record -> {path}\n"
            )
            sys.stderr.flush()
        return path
    except Exception:  # pragma: no cover - never worsen a crash
        return None
