"""Span tracing of host-side ops, the serving request timeline, and
profiler annotations.

Every host-side operation worth a post-mortem records a :class:`Span`
into a bounded in-memory ring: *op*, *peer*, *bytes*, *wall time*, and
whether it raised.  The ring is what the flight recorder dumps, so a
post-mortem can say what a process spent its last seconds in.

Three integration layers:

* **Host spans** — :meth:`Tracer.span` context manager.  Each span also
  feeds the metrics registry (``host_op.<op>`` count/bytes/latency).
* **Request timeline** — :class:`RequestTimeline` records the serving
  scheduler's lifecycle events (submit, admit, prefill, decode, evict,
  retire) on the scheduler clock, mirrors each into the span ring, and
  exports the run as Chrome trace-event JSON
  (:func:`write_chrome_trace`, Perfetto-loadable).
* **Profiler annotations** — :func:`step_annotation` and
  :func:`named_scope` open a ``torch.profiler.record_function`` range, so
  the names show in a ``torch.profiler`` trace beside the device
  kernels.
* **Phase spans** — :class:`PhaseSpan` names a phase of a loop (the
  serving scheduler's tick): its duration into a histogram bound once,
  and a :func:`named_scope` range only while a profiler records.

Overhead discipline: a span is one ``perf_counter`` pair, one small object,
one deque append, and three instrument updates.  Nothing here ever touches
a device buffer.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from chainermn_tpu_torch.observability import metrics as _metrics

#: Bucket edges for host-op latency histograms (ms) — the registry default.
_OP_EDGES = _metrics.DEFAULT_MS_EDGES

#: Per-process epoch anchor: ONE wall-clock reading paired with ONE
#: monotonic reading, captured together at import.  Every span timestamp
#: is recorded on the monotonic clock (``perf_counter`` — the same clock
#: that times durations) and converted to wall time only through this
#: pair, so a rank's exported timestamps can never skew against its own
#: durations the way mixing ``time.time()`` starts with ``perf_counter``
#: durations could (NTP stepping the wall clock mid-run, coarse wall
#: resolution).  The wall anchor exists only to label exported records
#: with human time.
EPOCH_WALL = time.time()
EPOCH_PERF = time.perf_counter()


def mono_to_wall(t_mono: float) -> float:
    """Map a ``perf_counter`` timestamp onto this process's wall clock
    via the import-time epoch anchor."""
    return EPOCH_WALL + (t_mono - EPOCH_PERF)


@dataclass
class Span:
    """One completed (or failed) host-plane operation."""

    op: str
    peer: Optional[int] = None
    nbytes: Optional[int] = None
    #: start on the MONOTONIC clock (``perf_counter`` — one clock base
    #: per rank for both timestamps and durations; wall time is derived
    #: through the epoch anchor at export).
    t_mono: Optional[float] = None
    #: per-op sequence number (assigned at span open by the tracer):
    #: the k-th ``barrier`` span on every rank describes the SAME
    #: collective, however much each rank's ring has evicted.
    seq: Optional[int] = None
    ms: float = 0.0
    ok: bool = True
    error: Optional[str] = None
    #: free-form detail (e.g. ``step=120`` for checkpoint spans).
    detail: Optional[str] = None

    def to_dict(self) -> dict:
        t = self.t_mono if self.t_mono is not None else EPOCH_PERF
        d = {"op": self.op, "t_mono": round(t, 6),
             "wall_start": round(mono_to_wall(t), 6),
             "ms": round(self.ms, 3), "ok": self.ok}
        for k in ("peer", "nbytes", "error", "detail", "seq"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


class SpanRing:
    """Bounded ring of completed spans (oldest evicted first)."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"span ring capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        #: Total ever appended (evictions = total - len).
        self.total = 0

    def append(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self.total += 1
            if len(self._spans) > self.capacity:
                del self._spans[: len(self._spans) - self.capacity]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class _OpenSpan:
    __slots__ = ("span", "t0")

    def __init__(self, span: Span, t0: float):
        self.span = span
        self.t0 = t0


class Tracer:
    """Process-wide span recorder.

    Tracks per-thread stacks of *open* spans so the flight recorder can
    name what a rank is blocked in **right now** (``in_flight()``), and
    keeps the most recent errored span (``last_error()``) for post-mortems
    taken after the stack has already unwound — the crash path: by the
    time ``sys.excepthook`` runs, the failing span has closed.
    """

    def __init__(self, ring: Optional[SpanRing] = None,
                 publish_metrics: bool = True):
        # `is None`, not `or`: an EMPTY ring is falsy (__len__ == 0) and
        # `or` would silently replace the caller's ring with a fresh one.
        self.ring = ring if ring is not None else SpanRing(
            int(os.environ.get("CMN_OBS_SPAN_RING", "512"))
        )
        self._publish = publish_metrics
        self._lock = threading.Lock()
        #: thread ident -> stack of open spans (dict, not thread-local:
        #: the flight recorder reads OTHER threads' stacks).
        self._open: Dict[int, List[_OpenSpan]] = {}
        #: per-op open counters: source of each span's ``seq``.
        self._op_seq: Dict[str, int] = {}
        self._last_error: Optional[Span] = None

    # ----------------------------------------------------------------- spans
    def span(self, op: str, peer: Optional[int] = None,
             nbytes: Optional[int] = None, detail: Optional[str] = None):
        """Context manager recording one host-plane op.  The yielded
        :class:`Span` is mutable — callers that only learn the byte count
        mid-op (recv) set ``span.nbytes`` before exit."""
        return _SpanCtx(self, Span(op=op, peer=peer, nbytes=nbytes,
                                   detail=detail))

    def _push(self, open_span: _OpenSpan) -> None:
        tid = threading.get_ident()
        span = open_span.span
        with self._lock:
            # Stamp at OPEN, under the tracer lock: ``t_mono`` shares the
            # exact reading the duration pair uses, and ``seq`` counts
            # opens per op — collectives open in the same order on every
            # rank, so equal (op, seq) across ranks is the same event.
            span.t_mono = open_span.t0
            span.seq = self._op_seq.get(span.op, 0)
            self._op_seq[span.op] = span.seq + 1
            self._open.setdefault(tid, []).append(open_span)

    def _pop(self, open_span: _OpenSpan, error: Optional[BaseException]):
        span = open_span.span
        span.ms = (time.perf_counter() - open_span.t0) * 1000.0
        if error is not None:
            span.ok = False
            span.error = f"{type(error).__name__}: {error}"[:300]
        tid = threading.get_ident()
        with self._lock:
            stack = self._open.get(tid)
            if stack and stack[-1] is open_span:
                stack.pop()
            elif stack and open_span in stack:  # defensive: odd unwind order
                stack.remove(open_span)
            if error is not None:
                self._last_error = span
        self.ring.append(span)
        if self._publish:
            reg = _metrics.registry()
            reg.counter(f"host_op.{span.op}.total").inc()
            if not span.ok:
                reg.counter(f"host_op.{span.op}.errors").inc()
            if span.nbytes is not None:
                reg.counter(f"host_op.{span.op}.bytes").inc(span.nbytes)
            reg.histogram(f"host_op.{span.op}.ms", _OP_EDGES).observe(span.ms)

    # ------------------------------------------------------------ inspection
    def in_flight(self) -> List[dict]:
        """Currently open spans across ALL threads, innermost last per
        thread — what each thread of this rank is sitting in right now."""
        now = time.perf_counter()
        out = []
        with self._lock:
            for tid, stack in self._open.items():
                for os_ in stack:
                    d = os_.span.to_dict()
                    d["open_ms"] = round((now - os_.t0) * 1000.0, 3)
                    d["thread"] = tid
                    del d["ms"]  # not finished; open_ms is the honest number
                    out.append(d)
        return out

    def last_error(self) -> Optional[dict]:
        with self._lock:
            return self._last_error.to_dict() if self._last_error else None

    def current_span_name(self) -> Optional[str]:
        """The innermost in-flight op (any thread; main thread preferred),
        falling back to the last *errored* span — the flight recorder's
        "what was this rank doing" one-liner."""
        main_id = threading.main_thread().ident
        with self._lock:
            stack = self._open.get(main_id)
            if stack:
                return stack[-1].span.op
            for other in self._open.values():
                if other:
                    return other[-1].span.op
            if self._last_error is not None:
                return self._last_error.op
        return None


class _SpanCtx:
    __slots__ = ("_tracer", "_open")

    def __init__(self, tracer_: Tracer, span: Span):
        self._tracer = tracer_
        self._open = _OpenSpan(span, 0.0)

    def __enter__(self) -> Span:
        self._open.t0 = time.perf_counter()
        self._tracer._push(self._open)
        return self._open.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._pop(self._open, exc)
        return False  # never swallow


# ------------------------------------------------ request-lifecycle timeline
@dataclass
class LifecycleEvent:
    """One serving-plane lifecycle event on the *scheduler clock*.

    ``kind`` ∈ {submit, admit, prefill, decode, evict, retire}; ``t`` is
    the event's start in scheduler-clock seconds (the clock the arrival
    schedule lives on, so queue waits render true even when the scheduler
    skips idle gaps); duration events carry ``dur_ms``.
    """

    kind: str
    t: float
    req: Optional[int] = None
    slot: Optional[int] = None
    dur_ms: float = 0.0
    info: Optional[dict] = None


class RequestTimeline:
    """Bounded recorder of request-lifecycle events for one serving run.

    Two sinks per event:

    * the timeline's own ring (capacity ``CMN_OBS_TIMELINE``, default
      32768 — sized for whole-run Chrome/Perfetto export; oldest events
      drop first and ``dropped`` counts them, so a truncated export is
      visible, never silent), and
    * optionally the process span ring (``ring=``): each event is
      mirrored as a ``serve.<kind>`` :class:`Span`, so a flight record
      of a dying serving rank shows its recent scheduling activity next
      to the host-plane ops.  Mirrored spans bypass the metric publisher
      — the scheduler's ``serve.*`` histograms already carry the rates.
    """

    def __init__(self, capacity: Optional[int] = None,
                 ring: Optional[SpanRing] = None):
        cap = int(
            capacity if capacity is not None
            else os.environ.get("CMN_OBS_TIMELINE", "32768")
        )
        if cap < 1:
            raise ValueError(f"timeline capacity must be >= 1: {cap}")
        self.capacity = cap
        self._lock = threading.Lock()
        # deque(maxlen): O(1) eviction — a full timeline sits on the
        # scheduler's per-iteration path, where a list-trim memmove of
        # `capacity` pointers per event would not.
        self._events: deque = deque(maxlen=cap)
        self.ring = ring
        #: total ever recorded (dropped = total - len).
        self.total = 0

    def record(self, kind: str, t: float, req: Optional[int] = None,
               slot: Optional[int] = None, dur_ms: float = 0.0,
               info: Optional[dict] = None) -> None:
        ev = LifecycleEvent(kind=kind, t=t, req=req, slot=slot,
                            dur_ms=dur_ms, info=info)
        with self._lock:
            self._events.append(ev)
            self.total += 1
        if self.ring is not None:
            detail = f"req={req}" if req is not None else (
                f"slots={len(info['reqs'])}" if info and "reqs" in info
                else None
            )
            self.ring.append(Span(
                op=f"serve.{kind}", peer=slot,
                t_mono=time.perf_counter(), ms=dur_ms, detail=detail,
            ))

    def events(self) -> List[LifecycleEvent]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.total - len(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


#: Chrome trace-event track ids: the admission queue gets its own track
#: above the slot tracks.
_QUEUE_TID = 0


def chrome_trace_events(events, rank: int = 0) -> List[dict]:
    """Convert :class:`LifecycleEvent` s into Chrome trace-event JSON
    objects (the ``traceEvents`` array — Perfetto/``chrome://tracing``
    loadable).

    Track layout: one *process* per rank; thread 0 is the admission
    queue, thread ``1 + slot`` is that decode slot.  A request renders
    as:

    * a ``queue req N`` slice on the queue track (submit→admit, and
      again evict→readmission),
    * a ``req N`` slice on its slot track for each residency
      (admit→retire/evict), with nested ``prefill`` / ``decode`` slices,
    * an ``evict`` *instant* event at each eviction.

    Events still open when the recording ends (an aborted run) are
    closed at the last observed timestamp, so the export always loads.
    """
    out: List[dict] = []
    pid = int(rank)
    used_tids = {_QUEUE_TID}
    t_max = max((e.t + e.dur_ms / 1e3 for e in events), default=0.0)

    def us(t: float) -> float:
        return round(t * 1e6, 3)

    def slice_(name, cat, tid, t0, t1, args=None):
        ev = {"name": name, "cat": cat, "ph": "X", "pid": pid,
              "tid": tid, "ts": us(t0), "dur": max(us(t1) - us(t0), 0.0)}
        if args:
            ev["args"] = args
        out.append(ev)

    queue_since: Dict[int, float] = {}
    residency: Dict[int, tuple] = {}  # req -> (t_admit, slot)
    for e in events:
        if e.kind == "submit":
            queue_since[e.req] = e.t
        elif e.kind == "admit":
            t0 = queue_since.pop(e.req, None)
            if t0 is not None:
                slice_(f"queue req {e.req}", "queue", _QUEUE_TID,
                       t0, e.t, {"req": e.req})
            residency[e.req] = (e.t, e.slot)
            used_tids.add(1 + e.slot)
        elif e.kind == "prefill":
            used_tids.add(1 + e.slot)
            slice_("prefill", "prefill", 1 + e.slot, e.t,
                   e.t + e.dur_ms / 1e3,
                   {"req": e.req, **(e.info or {})})
        elif e.kind == "decode":
            info = e.info or {}
            for slot, req in info.get("reqs", ()):
                used_tids.add(1 + slot)
                slice_("decode", "decode", 1 + slot, e.t,
                       e.t + e.dur_ms / 1e3,
                       {"req": req, "mixed": info.get("mixed", False)})
        elif e.kind in ("evict", "retire"):
            start = residency.pop(e.req, None)
            if start is not None:
                t0, slot = start
                args = {"req": e.req}
                if e.kind == "evict":
                    args["evicted"] = True
                elif e.info:
                    args.update(e.info)
                slice_(f"req {e.req}", "request", 1 + slot, t0, e.t, args)
            if e.kind == "evict":
                out.append({"name": "evict", "cat": "evict", "ph": "i",
                            "s": "t", "pid": pid, "tid": 1 + e.slot,
                            "ts": us(e.t), "args": {"req": e.req}})
                queue_since[e.req] = e.t
    # Close anything the recording ended inside of.
    for req, (t0, slot) in residency.items():
        slice_(f"req {req}", "request", 1 + slot, t0, t_max,
               {"req": req, "open": True})
    for req, t0 in queue_since.items():
        if t0 < t_max:
            slice_(f"queue req {req}", "queue", _QUEUE_TID, t0, t_max,
                   {"req": req, "open": True})
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": f"cmn-serve rank {pid}"}}]
    for tid in sorted(used_tids):
        name = "queue" if tid == _QUEUE_TID else f"slot {tid - 1}"
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": name}})
        meta.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"sort_index": tid}})
    return meta + out


def write_chrome_trace(path: str, events, rank: int = 0) -> str:
    """Write a Perfetto-loadable Chrome trace JSON file
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``) and return
    ``path``.  Strict JSON via the same sanitizer as the metric feeds."""
    import json

    from chainermn_tpu_torch.observability import aggregate as _oagg

    payload = {
        "traceEvents": _oagg.sanitize_json(
            chrome_trace_events(events, rank=rank)
        ),
        "displayTimeUnit": "ms",
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def chrome_span_events(spans, rank: int = 0) -> List[dict]:
    """Chrome trace-event objects for one process's span dump
    (:meth:`SpanRing.snapshot` dicts): one *process* (``pid`` = rank),
    every span a complete ``X`` slice on track 0, timestamps in
    microseconds from the earliest span.  The incident plane cuts its
    bundle's trace window with this."""
    pid = int(rank)
    t0 = min((float(s.get("t_mono", 0.0)) for s in spans), default=0.0)
    out: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": f"cmn rank {pid}"}},
    ]
    for span in spans:
        args = {k: span[k] for k in ("peer", "nbytes", "detail", "seq")
                if k in span}
        if not span.get("ok", True):
            args["error"] = span.get("error")
        out.append({
            "name": span["op"], "cat": "host_op", "ph": "X",
            "pid": pid, "tid": 0,
            "ts": round((float(span.get("t_mono", 0.0)) - t0) * 1e6, 3),
            "dur": round(float(span.get("ms", 0.0)) * 1e3, 3),
            "args": args,
        })
    return out


# ------------------------------------------------------ profiler annotations
def step_annotation(step: int):
    """A ``torch.profiler.record_function`` range named for one step
    (``cmn_train_step#<step>``), so a ``torch.profiler`` trace carries the
    host step number beside the device kernels."""
    import torch

    return torch.profiler.record_function(f"cmn_train_step#{int(step)}")


def named_scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (the
    in-step counterpart of :func:`step_annotation`)."""
    import torch

    return torch.profiler.record_function(name)


class PhaseSpan:
    """One named phase of a loop: ``with span: ...``.

    Each use adds its ``perf_counter`` duration (ms) to the histogram it
    was bound to at construction (none: a range only), and opens
    :func:`named_scope` (``name``) while a ``torch.profiler`` records, so
    that in a profile the phase sits on the host timeline beside the
    kernels it launched.  The profiler's flag is read as the span is
    entered.  No name formatting and no registry lookup per use; phase
    spans are not appended to the span ring."""

    __slots__ = ("name", "_observe", "_recording", "_t0", "_range")

    def __init__(self, name: str, hist=None):
        import torch

        self.name = name
        self._observe = hist.observe if hist is not None else None
        self._recording = torch.autograd._profiler_enabled
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "PhaseSpan":
        if self._recording():
            self._range = named_scope(self.name)
            self._range.__enter__()
        if self._observe is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._observe is not None:
            self._observe((time.perf_counter() - self._t0) * 1e3)
        r = self._range
        if r is not None:
            self._range = None
            r.__exit__(exc_type, exc, tb)
        return False


#: The phase span of a loop whose observability is off: no clock read,
#: no range.
NOOP_SPAN = contextlib.nullcontext()


#: Process-wide tracer (lazy singleton, like the metrics registry).
_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer
