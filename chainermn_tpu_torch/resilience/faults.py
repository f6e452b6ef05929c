"""Deterministic fault injection: make failure modes testable.

One env var drives it, with the JAX package's grammar:

    CMN_FAULT=crash@serve_step:5        # raise at decode iteration 5
    CMN_FAULT=skew@serve_step:3:150ms   # from iteration 3 on, +150ms each
    CMN_FAULT=slow@send:50ms;crash@iter:7   # ';'-separated composition

Scoping env vars:

* ``CMN_FAULT_RANK`` — inject only on this rank (default: every rank).
* ``CMN_FAULT_ATTEMPT`` — inject only on this ``CMN_LAUNCH_ATTEMPT``
  (default 0: the first launch), so a supervised relaunch is fault-free.

Grammar: ``kind@site:arg`` where ``kind`` is one of :data:`KINDS`,
``site`` a hook-point name (any identifier parses; the serving scheduler
hooks ``serve_step``, counted by decode iteration), and ``arg`` a 1-based
hit count for one-shot kinds, a duration (``200ms``/``1.5s``) for
``slow``, or ``N:duration`` for ``skew`` (from hit N on, every hit is
stretched; a bare duration means ``1:duration``).  crash/hang/slow/skew
act inside :meth:`FaultInjector.hook`; the value-shaped kinds are
returned for the caller to apply.  The training loop applies them through
:func:`poison_batch` (``nan@grad``/``spike@loss`` on the iteration's
batch) and :func:`corrupt_params` (``flip@param`` on this rank's
parameters after the update).
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

KINDS = ("crash", "hang", "slow", "drop", "nan", "spike", "flip", "skew")
ONE_SHOT_KINDS = ("crash", "hang", "drop", "nan", "spike", "flip")
#: Value-shaped one-shot kinds: ``hook()`` returns them as the action (the
#: caller applies the corruption) instead of acting in-process.
VALUE_KINDS = ("drop", "nan", "spike", "flip")

#: ``spike@loss`` scales the batch's floating leaves by this.
SPIKE_SCALE = 1e3

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<site>[A-Za-z_][A-Za-z0-9_]*):(?P<arg>[^@;]+)$"
)
_DURATION_RE = re.compile(r"^(?P<num>\d+(?:\.\d+)?)(?P<unit>ms|s)$")


class InjectedFault(RuntimeError):
    """Raised by a ``crash`` spec — an ordinary uncaught exception."""


class FaultSpecError(ValueError):
    """Malformed ``CMN_FAULT`` value."""


@dataclass
class FaultSpec:
    kind: str
    site: str
    #: 1-based hit count at/after which a one-shot kind fires.
    n: Optional[int] = None
    #: per-hit delay for ``slow``/``skew``.
    duration_s: Optional[float] = None
    fired: bool = field(default=False, compare=False)

    @property
    def text(self) -> str:
        if self.kind == "skew":
            arg = f"{self.n}:{self.duration_s}s"
        elif self.n is not None:
            arg = f"{self.n}"
        else:
            arg = f"{self.duration_s}s"
        return f"{self.kind}@{self.site}:{arg}"


def _parse_duration(arg: str, part: str) -> float:
    dm = _DURATION_RE.match(arg)
    if not dm:
        raise FaultSpecError(
            f"need a duration arg like 200ms or 1.5s, got {arg!r} in {part!r}"
        )
    dur = float(dm.group("num"))
    if dm.group("unit") == "ms":
        dur /= 1000.0
    return dur


def parse_fault_spec(spec: str) -> List[FaultSpec]:
    """Parse a ``CMN_FAULT`` value into :class:`FaultSpec` s.

    Raises :class:`FaultSpecError` on any malformed component: a typo'd
    spec silently injecting nothing would invalidate the test built on
    it."""
    out: List[FaultSpec] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        m = _SPEC_RE.match(part)
        if not m:
            raise FaultSpecError(
                f"bad fault spec {part!r} (want kind@site:arg, e.g. "
                f"crash@iter:5 or slow@send:200ms)"
            )
        kind, site, arg = m.group("kind"), m.group("site"), m.group("arg")
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {part!r} (one of {KINDS})"
            )
        if kind == "slow":
            out.append(FaultSpec(kind=kind, site=site,
                                 duration_s=_parse_duration(arg, part)))
        elif kind == "skew":
            n, dur_text = 1, arg
            if ":" in arg:
                n_text, dur_text = arg.split(":", 1)
                if not n_text.isdigit() or int(n_text) < 1:
                    raise FaultSpecError(
                        f"skew fault needs N:duration with a 1-based start "
                        f"hit, got {arg!r} in {part!r}"
                    )
                n = int(n_text)
            out.append(FaultSpec(kind=kind, site=site, n=n,
                                 duration_s=_parse_duration(dur_text, part)))
        else:
            if not arg.isdigit() or int(arg) < 1:
                raise FaultSpecError(
                    f"{kind} fault needs a 1-based hit count, got {arg!r} "
                    f"in {part!r}"
                )
            out.append(FaultSpec(kind=kind, site=site, n=int(arg)))
    if not out:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return out


class FaultInjector:
    """Evaluates parsed specs at named hook points.

    ``hook(site)`` counts hits per site (1-based) and applies matching
    specs; ``count=`` matches against an externally maintained counter
    instead (the scheduler passes its decode iteration).  crash, hang,
    slow and skew act here; value-shaped kinds are returned (``"drop"``,
    ``"nan"``, ``"spike"``, ``"flip"``), else ``None``.
    """

    def __init__(self, specs: List[FaultSpec],
                 sleep: Callable[[float], None] = time.sleep):
        self.specs = list(specs)
        self._counts: Dict[str, int] = {}
        self._mu = threading.Lock()
        self._sleep = sleep

    def hook(self, site: str, count: Optional[int] = None) -> Optional[str]:
        with self._mu:
            if count is None:
                self._counts[site] = self._counts.get(site, 0) + 1
                count = self._counts[site]
            todo = [
                s for s in self.specs
                if s.site == site and (
                    s.kind == "slow"
                    or (s.kind == "skew" and count >= s.n)
                    or (s.kind in ONE_SHOT_KINDS and not s.fired
                        and s.n is not None and count >= s.n)
                )
            ]
            for s in todo:
                if s.kind in ONE_SHOT_KINDS:
                    s.fired = True
        action = None
        for s in todo:
            if s.kind in ("slow", "skew"):
                self._sleep(s.duration_s)
            elif s.kind == "crash":
                raise InjectedFault(f"injected fault: {s.text}")
            elif s.kind in VALUE_KINDS:
                action = s.kind
            elif s.kind == "hang":
                self._hang(s)
        return action

    def _hang(self, spec: FaultSpec) -> None:
        sys.stderr.write(
            f"[chainermn_tpu_torch.resilience] injected fault: {spec.text} "
            "— freezing this process\n"
        )
        sys.stderr.flush()
        while True:  # pragma: no cover - exercised only multiprocess
            self._sleep(3600)


# ----------------------------------------------------- fail-silent injection
def _map_batch(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_batch(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    return fn(batch)


def _is_float(x) -> bool:
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return hasattr(x, "dtype") and np.issubdtype(x.dtype, np.floating)


def poison_batch(injector: "FaultInjector", batch, iteration: int):
    """Apply ``nan@grad`` / ``spike@loss`` to this iteration's batch
    (numpy arrays or tensors, nested in tuples, lists or dicts).

    * ``nan`` -- every floating leaf becomes NaN, so the step's loss and
      gradients are poisoned as silent input corruption poisons them;
    * ``spike`` -- floating leaves scale by :data:`SPIKE_SCALE`: the loss
      and the gradient norm blow up but stay finite.

    Counted by trainer iteration (1-based).  A batch with no floating
    leaf cannot carry the fault, and injecting nothing would invalidate
    the test built on it, so that raises."""
    import numpy as np
    import torch

    def corrupt(fn, kind):
        hit = [0]

        def one(x):
            if not _is_float(x):
                return x
            hit[0] += 1
            return fn(x)

        out = _map_batch(one, batch)
        if not hit[0]:
            raise InjectedFault(
                f"injected fault {kind} at iteration {iteration} found no "
                "floating-point batch leaves to corrupt: an all-integer "
                "batch cannot carry this fault")
        return out

    def nan(x):
        return torch.full_like(x, float("nan")) \
            if isinstance(x, torch.Tensor) else np.full_like(x, np.nan)

    def spike(x):
        return x * SPIKE_SCALE if isinstance(x, torch.Tensor) \
            else x * x.dtype.type(SPIKE_SCALE)

    if injector.hook("grad", count=iteration) == "nan":
        batch = corrupt(nan, "nan@grad")
    if injector.hook("loss", count=iteration) == "spike":
        batch = corrupt(spike, "spike@loss")
    return batch


def corrupt_params(injector: "FaultInjector", state, iteration: int):
    """Apply ``flip@param``: after iteration N's update, corrupt one
    element of the first parameter ON THIS RANK ONLY (``-x - 1``, which
    changes even an exact zero), in place.  "First" is the first name in
    sorted order, as the JAX package's sorted parameter tree has it, so
    both packages flip the same element of the same model.  This rank's
    replica then silently disagrees with its peers."""
    if injector.hook("param", count=iteration) != "flip":
        return state
    import torch

    name, p = min(state.model.named_parameters(), key=lambda kv: kv[0])
    with torch.no_grad():
        flat = p.view(-1)
        flat[0] = -flat[0] - 1
    sys.stderr.write(
        f"[chainermn_tpu_torch.resilience] injected fault: flip@param "
        f"({name}) at iteration {iteration}: local replica diverged\n")
    return state


#: Process-wide injector cache (see :func:`process_injector`).
_process_injector = {"built": False, "inj": None}


def process_injector() -> Optional[FaultInjector]:
    """The one injector shared by every hook site in this process, built
    lazily from the env."""
    if not _process_injector["built"]:
        _process_injector["inj"] = from_env()
        _process_injector["built"] = True
    return _process_injector["inj"]


def from_env(rank: Optional[int] = None) -> Optional[FaultInjector]:
    """Build the process's injector from ``CMN_FAULT``; ``None`` (zero
    overhead) when unset or when rank/attempt scoping excludes us.
    ``rank`` defaults to ``RANK`` (``torch.distributed``'s launcher
    variable), then ``CMN_PROCESS_ID``."""
    spec = os.environ.get("CMN_FAULT", "")
    if not spec:
        return None
    want_attempt = int(os.environ.get("CMN_FAULT_ATTEMPT", "0"))
    attempt = int(os.environ.get("CMN_LAUNCH_ATTEMPT", "0"))
    if attempt != want_attempt:
        return None
    want_rank = os.environ.get("CMN_FAULT_RANK")
    if want_rank is not None:
        if rank is None:
            rank = int(os.environ.get(
                "RANK", os.environ.get("CMN_PROCESS_ID", "-1")
            ))
        if int(want_rank) != rank:
            return None
    return FaultInjector(parse_fault_spec(spec))
