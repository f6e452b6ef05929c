"""Device-plane observability — the capture watch, FLOPs, MFU/roofline.

The JAX package watches its compiler: which jitted programs compiled, for
which argument signature, and how close each runs to the chip's roofline.
PyTorch runs eagerly, and the serving engine's fixed-shape decode step is
instead captured once as a CUDA graph and replayed.  So this module's
:class:`CompileWatch` is the **capture watch**:

* **Captures and signatures** — the engine registers each of its programs
  (:meth:`CompileWatch.register`) with a budget (``decode_step <= 1``,
  ``prefill <= len(ladder)``, ``cow <= 1``, as the JAX engine declares).
  Every capture of a CUDA graph, and every new input signature of a
  program that runs eagerly (prefill, the copy-on-write copy, the KV
  block reads and writes, the speculative round; every program on the
  CPU), is recorded into a bounded ring (``CMN_OBS_COMPILE_RING``) with
  its signature (shapes, dtypes, the model's geometry) and its wall time,
  and counted in the ``compile.*`` metrics (``compile.count``,
  ``compile.ms``).  A second capture or signature of one program emits
  **blame**: a structured diff of the new signature against the previous
  one naming the changed argument and axis.  Exceeding a budget bumps
  the ``compile.budget_exceeded`` gauge the recompile-guard tests pin at
  0.  Replays are counted per program (``WatchedProgram.replays``).
* **MFU / roofline attribution** — a per-signature cost model of the
  decode step (:meth:`WatchedProgram.cost_analysis`), built once and
  memoized process-wide per ``(program, signature)``, folded with a
  measured step time into :func:`roofline`: achieved TFLOP/s, MFU
  against :data:`PEAK_BF16_FLOPS`, arithmetic intensity and the roofline
  gap, published as ``device.<program>.*`` gauges by the serving
  scheduler.  The cost model (the engine's ``decode_cost``) is:

  - FLOPs = what ``torch.utils.flop_counter.FlopCounterMode`` counts over
    one eager step of the signature (the dense products: QKV, output
    projection, FFN, LM head), plus, when the attention ran in the
    hand-written paged kernel (which the counter cannot see, just as XLA
    cannot see inside a Pallas call), the analytic attention term
    :func:`attention_core_flops` for the live context:
    ``4 · H · Dh`` per layer per attended position;
  - bytes = every weight read once (parameters' bytes) + the control
    vectors + the logits written (``capacity × vocab × 4``) + the KV
    read: ``2 · KH · Dh · itemsize`` (plus ``2 · KH · 4`` of scales for
    an int8 pool) per layer per attended position.

  The attended positions are the live slots' context lengths, summed,
  averaged over the clean decode iterations since the last publish (the
  scheduler supplies them): the only data-dependent term.
* **Flight provider** — a keyed ``"compile"`` provider puts per-program
  capture counts, replays, declared budgets and the most recent blame
  records into every crash / SIGUSR1 flight record.

Publishing follows the stack's latch rules: :meth:`CompileWatch.register`
consults the ``CMN_OBS`` master switch when the program is registered
(disabled → the program still counts its signatures, which the engine's
``*_compiles`` properties read, but records nothing and publishes
nothing); an explicitly passed registry always publishes.  The per-call
steady-state cost is one dict lookup of the call's signature key.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

from chainermn_tpu_torch.observability import metrics as _metrics

#: Capture-record ring capacity — ``CMN_OBS_COMPILE_RING``.
DEFAULT_COMPILE_RING = 256

#: Dense bf16 tensor-core peak per card, keyed by
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheet, SXM part, at its
#: 700 W limit) — the MFU denominator.  A card that is not in the table
#: publishes no MFU.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def attention_core_flops(batch: int, heads: int, q_len: int,
                         head_dim: int, kv_len: Optional[int] = None,
                         causal: bool = False, n_forward: int = 1,
                         n_backward: int = 1) -> float:
    """Analytic FLOPs of the attention-core products (``QKᵀ`` and ``AV``)
    for one attention call — the term ``FlopCounterMode`` CANNOT see when
    the core runs in a hand-written kernel.

    Accounting (MAC-based, as the JAX package counts it):

    * forward = ``4·B·H·Tq·Tkv·Dh`` (two products), halved for causal;
    * backward = 2.5× forward (five products: score recompute, dV, dP,
      dQ, dK);
    * ``n_forward=2`` when the block is rematerialized.

    GQA/MQA leave the core count unchanged (every query head still
    attends the full key length); ``heads`` is the QUERY head count.
    """
    if kv_len is None:
        kv_len = q_len
    area = q_len * kv_len
    if causal:
        area *= 0.5
    fwd = 4.0 * batch * heads * area * head_dim
    return n_forward * fwd + n_backward * 2.5 * fwd


#: open :func:`kernel_flops` tallies (innermost last).
_KERNEL_TALLY: List[List[float]] = []


@contextlib.contextmanager
def kernel_flops():
    """Tally, over the calls inside, the analytic FLOPs the hand-written
    kernels report as they launch (:func:`tally_kernel_flops`), the work
    ``FlopCounterMode`` cannot see; yields a one-element list holding the
    sum."""
    box = [0.0]
    _KERNEL_TALLY.append(box)
    try:
        yield box
    finally:
        _KERNEL_TALLY.remove(box)


def tally_kernel_flops(flops: Callable[[], float]) -> None:
    """Add ``flops()`` to the innermost open :func:`kernel_flops` tally
    (a no-op, and ``flops`` is not called, when none is open)."""
    if _KERNEL_TALLY:
        _KERNEL_TALLY[-1][0] += float(flops())


def current_device_kind() -> str:
    """``torch.cuda.get_device_name(0)`` where a card exists, else
    ``"cpu"`` (no peak: no MFU)."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def mfu_pct(flops: float, step_time_s: float, n_devices: int = 1,
            device_kind: Optional[str] = None,
            peak_flops: Optional[float] = None) -> Optional[float]:
    """THE utilization formula: per-execution FLOPs ÷ (step time ·
    per-card peak · n_devices), as a percent.  ``None`` when the device
    has no :data:`PEAK_BF16_FLOPS` entry (and no explicit
    ``peak_flops``), or the inputs are degenerate."""
    if peak_flops is None:
        if device_kind is None:
            device_kind = current_device_kind()
        peak_flops = PEAK_BF16_FLOPS.get(device_kind)
    if peak_flops is None or not flops or step_time_s <= 0:
        return None
    return 100.0 * flops / (step_time_s * peak_flops * n_devices)


def roofline(cost: dict, step_time_s: float, n_devices: int = 1,
             device_kind: Optional[str] = None,
             peak_flops: Optional[float] = None,
             extra_flops: float = 0.0,
             kv_positions: float = 0.0) -> Optional[dict]:
    """Roofline attribution for one program's measured step:

    * ``tflops_per_device`` — achieved TFLOP/s per card, including the
      attention term (``cost["attention_flops_per_position"] ×
      kv_positions``) and any ``extra_flops``;
    * ``mfu_pct`` — achieved vs :data:`PEAK_BF16_FLOPS` (None off the
      table, unless ``peak_flops`` is given explicitly);
    * ``arithmetic_intensity`` — FLOPs / bytes (the roofline
      x-coordinate), bytes including the KV read
      (``cost["kv_bytes_per_position"] × kv_positions``);
    * ``roofline_gap_x`` — peak / achieved (1.0 = at the compute roof).

    ``cost`` is a :meth:`WatchedProgram.cost_analysis` dict (``flops``,
    ``bytes accessed`` and the two per-position terms); returns ``None``
    when it carries no FLOPs.
    """
    counted = float(cost.get("flops", 0.0) or 0.0)
    if counted <= 0 or step_time_s <= 0:
        return None
    extra = float(extra_flops or 0.0) + float(
        cost.get("attention_flops_per_position", 0.0)) * kv_positions
    flops = counted + extra
    nbytes = float(cost.get("bytes accessed", 0.0) or 0.0) + float(
        cost.get("kv_bytes_per_position", 0.0)) * kv_positions
    per_dev = flops / step_time_s / max(n_devices, 1)
    out = {
        "flops_per_exec": counted,
        "extra_flops_per_exec": extra,
        "bytes_per_exec": nbytes or None,
        "step_time_ms": step_time_s * 1e3,
        "tflops_per_device": per_dev / 1e12,
        "arithmetic_intensity": (flops / nbytes) if nbytes else None,
    }
    pct = mfu_pct(flops, step_time_s, n_devices,
                  device_kind=device_kind, peak_flops=peak_flops)
    out["mfu_pct"] = pct
    out["roofline_gap_x"] = (100.0 / pct) if pct else None
    return out


# -------------------------------------------------------------- signatures
def _leaf_signature(x) -> dict:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return {"shape": [int(s) for s in shape], "dtype": str(dtype)}
    if isinstance(x, (bool, int, float)):
        # A scalar's VALUE never changes what is captured or run (a
        # prefill start offset, a block id): recording it would litter
        # every blame diff with false "changed" entries.
        return {"py": type(x).__name__}
    return {"static": repr(x)[:200]}


def call_signature(args: Dict[str, object]) -> Dict[str, dict]:
    """Signature of one call: ``{argument name: {shape, dtype} | {py} |
    {static}}`` — what the capture ring records and the blame diff
    compares."""
    return {name: _leaf_signature(v) for name, v in args.items()}


def signature_diff(prev: Dict[str, dict],
                   cur: Dict[str, dict]) -> List[dict]:
    """Structured blame diff between two :func:`call_signature` s: one
    record per changed argument, naming the changed axes (shape),
    ``dtype_changed``, rank changes, and added/removed arguments."""
    changed: List[dict] = []
    for path, now in cur.items():
        was = prev.get(path)
        if was is None:
            changed.append({"arg": path, "change": "added", "now": now})
            continue
        if was == now:
            continue
        rec: dict = {"arg": path, "before": was, "after": now}
        sa, sb = was.get("shape"), now.get("shape")
        if sa is not None and sb is not None:
            if len(sa) == len(sb):
                rec["axes"] = [
                    i for i, (a, b) in enumerate(zip(sa, sb)) if a != b
                ]
            else:
                rec["rank_changed"] = True
        if was.get("dtype") != now.get("dtype"):
            rec["dtype_changed"] = True
        changed.append(rec)
    for path, was in prev.items():
        if path not in cur:
            changed.append({"arg": path, "change": "removed", "was": was})
    return changed


def _sig_digest(sig: Dict[str, dict]) -> str:
    return hashlib.blake2b(
        json.dumps(sig, sort_keys=True).encode(), digest_size=8
    ).hexdigest()


# ------------------------------------------------------------- the watcher
class WatchedProgram:
    """One engine program under the watch: the signatures it has been
    captured (or run eagerly) for, its replays, and its cost model.

    The engine keys its programs' variants by a cheap tuple of shapes and
    dtypes (:meth:`known`); only a NEW key builds the full signature and
    records it (:meth:`CompileWatch.record`).
    """

    def __init__(self, program: str, watch: "CompileWatch",
                 budget: Optional[int] = None,
                 cost_fn: Optional[Callable[[], Optional[dict]]] = None,
                 watched: bool = True):
        self.program = program
        self.budget = budget
        self._watch = watch
        self._cost_fn = cost_fn
        #: False when registered with observability off: counts only.
        self.watched = watched
        self._keys: set = set()
        self._last_signature: Optional[Dict[str, dict]] = None
        self._cost: Optional[dict] = None
        self._cost_failed = False
        #: replays of this program's captured graphs.
        self.replays = 0

    def known(self, key) -> bool:
        return key in self._keys

    @property
    def compiles(self) -> int:
        """Captures (or eager signatures) so far — what the engine's
        ``*_compiles`` properties read."""
        return len(self._keys)

    @property
    def over_budget(self) -> bool:
        return self.budget is not None and self.compiles > self.budget

    def cost_analysis(self, capture: bool = True) -> Optional[dict]:
        """The cost model for the newest signature (lazy: ONE eager step
        under ``FlopCounterMode`` through the engine's cost function,
        memoized process-wide per ``(program, signature)`` so N engines
        of one geometry pay once).  ``None`` before the first call, when
        no cost function was given, or when it failed.

        ``capture=False`` never builds the model — it returns an already
        built/memoized one or ``None``.  The scheduler's on-cadence
        publish runs BETWEEN decode iterations of live requests and
        passes False, leaving the build to the drain; the build must
        also never run inside a CUDA-graph capture, and it does not:
        captures happen inside ``DecodeEngine.step``, builds only here."""
        if self._cost is not None:
            return self._cost
        if self._cost_failed or self._last_signature is None or \
                self._cost_fn is None:
            return None
        key = (self.program, _sig_digest(self._last_signature))
        memo = self._watch._cost_memo
        cost = memo.get(key)
        if cost is None:
            if not capture:
                return None
            try:
                cost = self._cost_fn()
            except Exception:
                cost = None
            if not cost:
                self._cost_failed = True
                return None
            memo[key] = cost
        self._cost = cost
        return cost


class CompileWatch:
    """Per-process capture watch: registered programs, a bounded ring of
    capture/signature records, blame diffs, budget accounting,
    ``compile.*`` metrics, and the ``"compile"`` flight-record section.

    Publishing: an explicit ``registry`` always records and publishes
    (caller intent); ``registry=None`` resolves to the global registry
    with the ``CMN_OBS`` master switch consulted at **register** time.
    Instruments are resolved per event (captures are rare by
    definition).
    """

    def __init__(self, registry=None, ring: Optional[int] = None):
        cap = int(
            ring if ring is not None
            else os.environ.get("CMN_OBS_COMPILE_RING",
                                str(DEFAULT_COMPILE_RING))
        )
        if cap < 1:
            raise ValueError(f"compile ring capacity must be >= 1: {cap}")
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=cap)
        self._blames: deque = deque(maxlen=32)
        self.total_compiles = 0
        self.budget_violations = 0
        self._fns: List["weakref.ref[WatchedProgram]"] = []
        self._cost_memo: Dict[tuple, dict] = {}
        self._explicit = registry is not None
        self._registry_fn = (
            (lambda: registry) if registry is not None
            else _metrics.registry
        )
        _install_provider()

    def _reg(self):
        return self._registry_fn()

    # ---------------------------------------------------------- registering
    def register(self, program: str, budget: Optional[int] = None,
                 cost_fn: Optional[Callable[[], Optional[dict]]] = None
                 ) -> WatchedProgram:
        """A new :class:`WatchedProgram` for ``program``.  ``budget``
        declares the allowed capture/signature count (exceeding it is a
        budget violation — gauged, blamed, and pinned by the
        recompile-guard tests); ``cost_fn`` builds the program's cost
        model for its newest signature (the decode step's)."""
        import chainermn_tpu_torch.observability as _obs

        watched = self._explicit or _obs.enabled()
        wp = WatchedProgram(program, self, budget=budget, cost_fn=cost_fn,
                            watched=watched)
        if watched:
            with self._lock:
                self._fns.append(weakref.ref(wp))
            exceeded = self._reg().gauge("compile.budget_exceeded")
            if exceeded.value is None:
                exceeded.set(0)
        return wp

    def functions(self) -> List[WatchedProgram]:
        """Live watched programs, oldest first (dead refs pruned)."""
        with self._lock:
            out, keep = [], []
            for ref in self._fns:
                wp = ref()
                if wp is not None:
                    out.append(wp)
                    keep.append(ref)
            self._fns = keep
        return out

    # ------------------------------------------------------------ recording
    def record(self, wp: WatchedProgram, key, args: Dict[str, object],
               wall_s: float, kind: str) -> None:
        """One new variant of ``wp``: a CUDA graph captured
        (``kind="capture"``) or an eager program called with a new
        signature (``kind="eager"``), keyed by ``key``, after
        ``wall_s`` seconds (capture, or the first call)."""
        wp._keys.add(key)
        sig = call_signature(args)
        prev = wp._last_signature
        wp._last_signature = sig
        wp._cost = None  # the newest signature owns the cost slot
        wp._cost_failed = False
        if not wp.watched:
            return
        n = wp.compiles
        rec = {
            "program": wp.program,
            "kind": kind,
            "n_compiles": n,
            "budget": wp.budget,
            "t_mono": time.perf_counter(),
            "compile_s": round(float(wall_s), 6),
            "signature": sig,
        }
        if prev is not None:
            rec["diff"] = signature_diff(prev, sig)
        over = wp.budget is not None and n > wp.budget
        if over:
            rec["budget_exceeded"] = True
        with self._lock:
            self._ring.append(rec)
            self.total_compiles += 1
            if prev is not None or over:
                # A second variant of one program is the blame-worthy
                # event; the first is just its birth record.
                self._blames.append(rec)
            if over:
                self.budget_violations += 1
                exceeded = self.budget_violations
            else:
                exceeded = None
        try:
            reg = self._reg()
            reg.counter("compile.count").inc()
            reg.histogram("compile.ms").observe(wall_s * 1e3)
            if exceeded is not None:
                reg.gauge("compile.budget_exceeded").set(exceeded)
        except Exception:  # pragma: no cover - observers never raise
            pass

    # ----------------------------------------------------------- inspection
    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def blames(self) -> List[dict]:
        """Second-variant records (signature diffs attached), newest
        last."""
        with self._lock:
            return list(self._blames)

    # -------------------------------------------------------------- roofline
    def publish_roofline(self, wp: WatchedProgram, step_time_ms: float,
                         n_devices: int = 1,
                         device_kind: Optional[str] = None,
                         peak_flops: Optional[float] = None,
                         extra_flops: float = 0.0,
                         kv_positions: float = 0.0,
                         registry=None,
                         capture: bool = True) -> Optional[dict]:
        """Compute :func:`roofline` for ``wp``'s newest signature at the
        measured ``step_time_ms`` and ``kv_positions`` attended, and
        publish the ``device.<program>.*`` gauges (``registry``
        overrides this watch's own — the serving scheduler passes its
        latched one).  Returns the roofline dict, or ``None`` when no
        cost model is available.  ``capture=False`` publishes only off an
        already-built cost model (see
        :meth:`WatchedProgram.cost_analysis`)."""
        cost = wp.cost_analysis(capture=capture)
        if cost is None:
            return None
        r = roofline(cost, step_time_ms / 1e3, n_devices,
                     device_kind=device_kind, peak_flops=peak_flops,
                     extra_flops=extra_flops, kv_positions=kv_positions)
        if r is None:
            return None
        reg = registry if registry is not None else self._reg()
        p = wp.program
        reg.gauge(f"device.{p}.tflops").set(r["tflops_per_device"])
        if r["arithmetic_intensity"] is not None:
            reg.gauge(f"device.{p}.ai").set(r["arithmetic_intensity"])
        if r["mfu_pct"] is not None:
            reg.gauge(f"device.{p}.mfu_pct").set(r["mfu_pct"])
            reg.gauge(f"device.{p}.roofline_gap_x").set(
                r["roofline_gap_x"]
            )
        return r

    # ---------------------------------------------------------------- flight
    def flight_section(self) -> dict:
        """The ``"compile"`` flight-record section: per-program capture
        counts, replays and budgets for every live watched program, plus
        the most recent blame diffs (signatures elided — the diff names
        the changed arguments; full signatures live in the ring)."""
        progs = [{
            "program": wp.program,
            "compiles": wp.compiles,
            "replays": wp.replays,
            "budget": wp.budget,
            "over_budget": wp.over_budget,
        } for wp in self.functions()]
        with self._lock:
            blames = [
                {k: v for k, v in rec.items() if k != "signature"}
                for rec in list(self._blames)[-4:]
            ]
            return {
                "programs": progs,
                "total_compiles": self.total_compiles,
                "budget_violations": self.budget_violations,
                "ring_records": len(self._ring),
                "recent_blames": blames,
            }


# ------------------------------------------------------ process-wide wiring
_watch: Optional[CompileWatch] = None
_watch_lock = threading.Lock()
_provider_installed = False
#: Separate from ``_watch_lock``: the provider install runs inside
#: ``CompileWatch.__init__``, which ``watch()`` enters while holding
#: ``_watch_lock`` — sharing the (non-reentrant) lock would deadlock.
_provider_lock = threading.Lock()


def watch() -> CompileWatch:
    """THE per-process capture watch (lazy, like the metrics registry).
    It binds the global registry; the ``CMN_OBS`` latch is applied per
    :meth:`CompileWatch.register` call."""
    global _watch
    if _watch is None:
        with _watch_lock:
            if _watch is None:
                _watch = CompileWatch()
    return _watch


def _install_provider() -> None:
    """Keyed ``"compile"`` flight provider reading the PROCESS watch
    (installed once, on first CompileWatch construction)."""
    global _provider_installed
    with _provider_lock:
        if _provider_installed:
            return
        from chainermn_tpu_torch.observability import flight as _flight

        _flight.register_provider(
            "compile", lambda: watch().flight_section()
        )
        _provider_installed = True
