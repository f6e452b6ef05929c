"""The device trace of a stretch of a run, read with ``torch.profiler``.

A :class:`DeviceTrace` profiles the work issued inside it, between two
synchronisations, and reduces the profile to what the per-layer metrics
read: every device operation's interval, their union (the seconds the
device was busy), the stretch's wall length, device time by kernel and
by group, and, where it records the host too, the idle gaps named by
what the host was doing when each began.  Recording the host's
operations slows a host-bound loop, so :func:`profiled` takes the busy
share and the kernels' times from a stretch that records the device
alone, and names the idle gaps from a second stretch that records both.
Nothing is written to disk: the profile is read in memory and dropped.

The lead kernels and the kernel groups are copied from the port's chip
smoke (``spin``, ``lm_group``, ``resnet_group``): a profile can lose its
first few kernel records, and the spin kernels launched before the
stretch take that loss instead of the work measured.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Tuple

#: kernels launched (and waited for) before and after the stretch.
LEAD_KERNELS = 16
SPIN_NAME = "spin_kernel"
#: the host span that marks the stretch in the profile.
WINDOW_SPAN = "portbench.window"
#: the profiler's own records on the host's timeline: no host work of
#: the run, so they name no idle gap.
PROFILER_OWN = ("Buffer Flush", "Activity Buffer Request")


def group(name: str) -> str:
    """The group of a device operation, by its name."""
    n = name.lower()
    if "flash_" in n:
        return "flash_attention"
    if "decode_paged" in n or "decode_fused" in n:
        return "decode_attention"
    if "matmul_affine" in n:
        return "k6"
    if "nccl" in n:
        return "collectives"
    if any(t in n for t in ("fprop", "dgrad", "wgrad", "conv", "implicit")):
        return "convolutions"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "matmul")):
        return "matrix_products"
    if "memcpy" in n or "memset" in n:
        return "copies_and_sets"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reductions"
    if any(t in n for t in ("elementwise", "vectorized", "copy", "fill")):
        return "elementwise"
    return "other"


def _spin(torch, n: int = LEAD_KERNELS) -> None:
    torch.cuda.synchronize()
    for _ in range(n):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_profile(device_ops: List[Tuple[str, float, float]],
                   host_ops: List[Tuple[str, float, float]],
                   window: Tuple[float, float]) -> dict:
    """The trace's reading from device operations ``(name, start_us,
    end_us)``, host operations in the same clock and the stretch's
    ``window`` (µs): busy and window seconds, device seconds and runs by
    kernel name and by group, and the idle gaps by the innermost host
    operation running where each began."""
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops
           if b > w0 and a < w1 and SPIN_NAME not in n]
    busy = merge([(a, b) for _, a, b in ops])
    busy_us = sum(b - a for a, b in busy)
    by_kernel: Dict[str, List[float]] = {}
    for n, a, b in ops:
        k = by_kernel.setdefault(n, [0.0, 0])
        k[0] += (b - a) / 1e6
        k[1] += 1
    by_group: Dict[str, float] = {}
    for n, (s, _) in by_kernel.items():
        by_group[group(n)] = by_group.get(group(n), 0.0) + s
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    hosts = sorted(h for h in host_ops
                   if h[0] != WINDOW_SPAN and h[0] not in PROFILER_OWN)
    starts = [h[1] for h in hosts]
    idle: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        # The innermost host operation that covers the gap's start.
        i = bisect.bisect_right(starts, a)
        name, width = "host", None
        for j in range(i - 1, max(-1, i - 400), -1):
            hn, ha, hb = hosts[j]
            if hb >= a and (width is None or hb - ha < width):
                name, width = hn, hb - ha
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "kernels": {n: (s, c) for n, (s, c) in by_kernel.items()},
        "groups": by_group,
        "idle": idle,
    }


def spin_window(device_ops: List[Tuple[str, float, float]]
                ) -> Optional[Tuple[float, float]]:
    """The stretch between the lead spin kernels and the trailing ones:
    from the end of the last that ended before the first other operation
    began, to the start of the first that began after the last ended."""
    work = [(a, b) for n, a, b in device_ops if SPIN_NAME not in n]
    if not work:
        return None
    first, last = min(a for a, _ in work), max(b for _, b in work)
    lead = [b for n, a, b in device_ops if SPIN_NAME in n and b <= first]
    trail = [a for n, a, b in device_ops if SPIN_NAME in n and a >= last]
    if not lead or not trail:
        return None
    return max(lead), min(trail)


class DeviceTrace:
    """``with DeviceTrace(torch) as tr: ...`` profiles the work issued in
    the block, from one synchronisation to another, and leaves its
    reading in ``tr.reading`` (see :func:`reduce_profile`).  With
    ``host=False`` only the device's activity is recorded: the stretch
    is bounded by the spin kernels, and no idle gap is named."""

    def __init__(self, torch, host: bool = True):
        self.torch = torch
        self.host = host
        self.reading: Optional[dict] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        torch = self.torch
        acts = [ProfilerActivity.CUDA]
        if self.host:
            acts.append(ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        _spin(torch)
        self._span = record_function(WINDOW_SPAN) if self.host else None
        if self._span is not None:
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.synchronize()
        if self._span is not None:
            self._span.__exit__(*exc)
        _spin(torch)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        device_ops, host_ops, window = [], [], None
        for e in self._prof.events():
            tr = e.time_range
            if getattr(e, "device_type", None) == cuda:
                # A host span (``record_function``) also shows on the
                # device's timeline, over the kernels issued inside it:
                # it is no device operation.
                if not getattr(e, "is_user_annotation", False):
                    device_ops.append((e.name, tr.start, tr.end))
            elif e.name == WINDOW_SPAN:
                window = (tr.start, tr.end)
            else:
                host_ops.append((e.name, tr.start, tr.end))
        self._prof = None
        spans = {h[0] for h in host_ops} | {WINDOW_SPAN}
        device_ops = [d for d in device_ops if d[0] not in spans]
        if not self.host:
            window = spin_window(device_ops)
        if window is None:
            raise RuntimeError("the profile holds no stretch to read")
        self.reading = reduce_profile(device_ops, host_ops, window)
        return False


def profiled(torch, work: Callable[[], None]) -> dict:
    """Run ``work`` under a profiler of the device alone, then again
    under one of the host and the device.  The reading is the first
    stretch's, with the second's idle gaps by host operation (``idle``)
    and its length (``named_window_s``)."""
    with DeviceTrace(torch, host=False) as dev:
        work()
    with DeviceTrace(torch, host=True) as named:
        work()
    out = dict(dev.reading)
    out["idle"] = named.reading["idle"]
    out["named_window_s"] = named.reading["window_s"]
    return out


def profile_cost(reading: dict, untraced_s: float, n: int, unit: str) -> str:
    """A log line: a step's (or tick's) seconds in the window, under the
    device's profiler and under the host's and the device's."""
    return (f"{unit} ms: window {untraced_s * 1e3:.3f}, device profile "
            f"{reading['window_s'] / n * 1e3:.3f}, host and device profile "
            f"{reading['named_window_s'] / n * 1e3:.3f}")


def breakdown(reading: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: device seconds by group, and idle
    seconds by what the host was doing, longest first."""
    ops = sorted(reading["groups"].items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(reading["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in idle]}


def kernel_seconds(reading: dict, symbol: str) -> Tuple[float, int]:
    """Device seconds and runs of the kernels whose name holds
    ``symbol``."""
    s, c = 0.0, 0
    for n, (secs, runs) in reading["kernels"].items():
        if symbol in n:
            s += secs
            c += runs
    return s, c
