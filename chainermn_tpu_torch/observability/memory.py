"""Device-memory observability — device watermarks, KV-pool occupancy,
leaks.

Everything else in the observability stack watches *time*; this module
watches *bytes*.  Three consumers drove the design:

* **Device watermarks** — the CUDA caching allocator's counters
  (``torch.cuda.memory_stats``: bytes allocated now and at peak) and the
  card's total memory published as ``mem.*``
  gauges, with a graceful host fallback (process RSS + peak RSS) on the
  CPU: the same code path runs everywhere, and the ``source`` field says
  which number you are reading.
* **KV-pool timeline** — the serving engine accounts its pools by hand
  (``bytes_per_block`` × blocks), so the pool's occupancy, prefix-cache
  share, and *fragmentation* (allocated-but-unwritten positions inside
  live slots' block tails) are pure host arithmetic — sampled into a
  bounded timeline (``CMN_OBS_MEM_TIMELINE``) on the scheduler's check
  cadence, zero device syncs.
* **Drain-cycle leak detection** — after a drain (no live slots) and a
  prefix-cache gc, every allocatable block must be back on the free
  list.  :meth:`MemoryMonitor.check_drained` asserts that and gauges
  ``mem.kv.leaked_blocks`` — refcount drift surfaces as a number, not
  as two requests scribbling on one block a week later.

A keyed ``"memory"`` flight-record provider (newest monitor wins, held
by weakref like the serving provider) puts the device snapshot and the
latest KV sample into every crash/SIGUSR1 record, so a post-mortem names
memory state alongside the in-flight span.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import List, Optional, Sequence, Tuple

from chainermn_tpu_torch.observability import metrics as _metrics

#: Memory-timeline capacity (samples) — ``CMN_OBS_MEM_TIMELINE``.
DEFAULT_TIMELINE = 4096


def _host_rss() -> Tuple[Optional[int], Optional[int]]:
    """(current RSS bytes, peak RSS bytes) for this process — the
    fallback watermark source when the backend has no memory stats."""
    cur = peak = None
    try:
        with open("/proc/self/statm") as f:
            cur = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux, bytes on macOS.
        scale = 1024 if os.uname().sysname == "Linux" else 1
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    except Exception:
        pass
    return cur, peak


def device_memory_stats(device=None) -> dict:
    """Best-available memory watermarks, uniformly shaped:

    ``{"source", "platform", "in_use_bytes", "peak_bytes",
    "limit_bytes"}`` — ``source`` is ``"device"`` on a CUDA device (the
    caching allocator's ``allocated_bytes.all.current`` / ``.peak`` and
    the card's total memory), else
    ``"host_rss"`` (process RSS — still catches a leaking host-side pool,
    which on the CPU *is* the device memory).  ``device`` is a
    ``torch.device`` or None (the current CUDA device when one exists).
    Never raises and never syncs a device stream: it reads allocator
    counters and the cached device properties, not buffers."""
    platform = "cpu"
    try:
        import torch

        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        if device is not None and torch.device(device).type == "cuda":
            platform = "gpu"
            stats = torch.cuda.memory_stats(device)
            total = torch.cuda.get_device_properties(device).total_memory
            return {
                "source": "device",
                "platform": platform,
                "in_use_bytes": int(
                    stats.get("allocated_bytes.all.current", 0)
                ),
                "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
                "limit_bytes": int(total),
            }
    except Exception:
        pass
    cur, peak = _host_rss()
    return {
        "source": "host_rss",
        "platform": platform,
        "in_use_bytes": cur,
        "peak_bytes": peak,
        "limit_bytes": None,
    }


def kv_pool_sample(engine, live_slots: Sequence[Tuple[int, int]] = ()
                   ) -> dict:
    """One KV-pool accounting sample from a serving engine's allocator —
    pure host arithmetic (the allocator is a Python free list; the
    engine's ``bytes_per_block`` comes from geometry, not arrays).

    ``live_slots`` is ``[(written_positions, blocks_held), ...]`` for
    the live decode slots; *fragmentation* is the fraction of live
    slots' allocated positions not (yet) holding K/V — block-tail waste,
    the paged layout's internal-fragmentation number (0 with no live
    slots)."""
    alloc = engine.pool.allocator
    allocatable = engine.pool.num_blocks - 1  # block 0 reserved
    used = alloc.used_blocks
    free = alloc.free_blocks
    cached = (
        engine.prefix.cached_blocks if engine.prefix is not None else 0
    )
    BL = engine.pool.block_len
    live_written = sum(min(pos, nb * BL) for pos, nb in live_slots)
    live_capacity = sum(nb * BL for _, nb in live_slots)
    return {
        "num_blocks": engine.pool.num_blocks,
        "block_len": BL,
        "bytes_per_block": engine.pool.bytes_per_block,
        "used_blocks": used,
        "free_blocks": free,
        "cached_blocks": cached,
        "occupancy": used / allocatable if allocatable else 0.0,
        "bytes_in_use": used * engine.pool.bytes_per_block,
        "fragmentation": (
            1.0 - live_written / live_capacity if live_capacity else 0.0
        ),
        "live_slots": len(live_slots),
    }


#: The newest monitor (weakref) — what the ``"memory"`` flight provider
#: reads.  A dropped monitor never pins its engine through the registry.
_latest_monitor: Optional["weakref.ref"] = None
_provider_installed = False
_provider_lock = threading.Lock()


def _flight_section() -> dict:
    """The ``"memory"`` flight-record section: a FRESH device/host
    watermark read (crash-time truth, not the last sample) plus the
    newest monitor's latest KV sample and timeline accounting."""
    out: dict = {"device": device_memory_stats()}
    mon = _latest_monitor() if _latest_monitor is not None else None
    if mon is not None:
        out["kv"] = mon.last_kv
        out["timeline_samples"] = len(mon)
        out["timeline_dropped"] = mon.dropped
    return out


def _install_provider() -> None:
    global _provider_installed
    with _provider_lock:
        if _provider_installed:
            return
        from chainermn_tpu_torch.observability import flight as _flight

        _flight.register_provider("memory", _flight_section)
        _provider_installed = True


class MemoryMonitor:
    """Watermark gauges + bounded memory timeline for one process.

    Publishing follows the stack's latch-at-construction rule: an
    explicitly passed ``registry`` always publishes; ``registry=None``
    resolves to the global registry while observability is enabled and
    to no-op instruments otherwise (the serving scheduler builds its
    monitor under the same decision as its other instruments).

    :meth:`sample` is the only recurring entry point: one
    ``memory_stats`` read (allocator counters — no device sync), a
    handful of gauge sets, a deque append.  The ``"memory"`` flight
    provider is installed as a construction side effect (module-keyed;
    the newest monitor's state wins, matching the ``"serving"``
    provider's replacement semantics).
    """

    def __init__(self, registry=None, capacity: Optional[int] = None,
                 device=None):
        import chainermn_tpu_torch.observability as _obs

        cap = int(
            capacity if capacity is not None
            else os.environ.get("CMN_OBS_MEM_TIMELINE",
                                str(DEFAULT_TIMELINE))
        )
        if cap < 1:
            raise ValueError(f"memory timeline capacity must be >= 1: {cap}")
        self.capacity = cap
        self.device = device
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=cap)
        self.total = 0
        #: newest KV sample (flight provider + tests read it).
        self.last_kv: Optional[dict] = None
        if registry is None and not _obs.enabled():
            noop = _metrics.NoopInstrument()
            self._g = {k: noop for k in (
                "in_use", "peak", "limit",
                "kv_used", "kv_free", "kv_cached", "kv_occ", "kv_frag",
                "kv_bytes", "kv_leaked",
            )}
        else:
            reg = registry if registry is not None else _metrics.registry()
            self._g = {
                "in_use": reg.gauge("mem.in_use_bytes"),
                "peak": reg.gauge("mem.peak_bytes"),
                "limit": reg.gauge("mem.limit_bytes"),
                "kv_used": reg.gauge("mem.kv.used_blocks"),
                "kv_free": reg.gauge("mem.kv.free_blocks"),
                "kv_cached": reg.gauge("mem.kv.cached_blocks"),
                "kv_occ": reg.gauge("mem.kv.occupancy"),
                "kv_frag": reg.gauge("mem.kv.fragmentation"),
                "kv_bytes": reg.gauge("mem.kv.bytes_in_use"),
                "kv_leaked": reg.gauge("mem.kv.leaked_blocks"),
            }
        global _latest_monitor
        _latest_monitor = weakref.ref(self)
        _install_provider()

    # -------------------------------------------------------------- sampling
    def sample(self, kv: Optional[dict] = None) -> dict:
        """Read watermarks (and fold in a KV-pool sample when given),
        publish the gauges, append to the timeline, return the sample."""
        dev = device_memory_stats(self.device)
        if dev["in_use_bytes"] is not None:
            self._g["in_use"].set(dev["in_use_bytes"])
        if dev["peak_bytes"] is not None:
            self._g["peak"].set(dev["peak_bytes"])
        if dev["limit_bytes"] is not None:
            self._g["limit"].set(dev["limit_bytes"])
        if kv is not None:
            self._g["kv_used"].set(kv["used_blocks"])
            self._g["kv_free"].set(kv["free_blocks"])
            self._g["kv_cached"].set(kv["cached_blocks"])
            self._g["kv_occ"].set(kv["occupancy"])
            self._g["kv_frag"].set(kv["fragmentation"])
            self._g["kv_bytes"].set(kv["bytes_in_use"])
            self.last_kv = kv
        s = {"t_mono": time.perf_counter(), "device": dev, "kv": kv}
        with self._lock:
            self._samples.append(s)
            self.total += 1
        return s

    def timeline(self) -> List[dict]:
        with self._lock:
            return list(self._samples)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self.total - len(self._samples)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    # ----------------------------------------------------------- leak check
    def check_drained(self, engine) -> int:
        """Drain-cycle leak check: with NO live work, a gc of the prefix
        cache (``drop_prefix_cache`` — trie pins are reuse potential,
        not owed memory) must return every allocatable block to the free
        list.  Returns the leaked-block count (0 = the zero-leak
        baseline holds) and gauges ``mem.kv.leaked_blocks``; any nonzero
        value means refcount drift — the bug class the allocator's
        over-free errors exist to keep loud."""
        engine.drop_prefix_cache()
        leaked = engine.pool.allocator.used_blocks
        self._g["kv_leaked"].set(leaked)
        # Resample so the timeline/flight provider reflect the post-gc
        # state (a drained pool, or the leak it just measured).
        self.sample(kv=kv_pool_sample(engine, ()))
        # The leak gauge only ever lands HERE — evaluate the incident
        # plane's watch rules now (the critical ``kv_leak`` rule has no
        # other moment at which the signal is live), if a run wired it.
        from chainermn_tpu_torch.observability import incident as _oincident

        _oincident.evaluate_if_built()
        return leaked
