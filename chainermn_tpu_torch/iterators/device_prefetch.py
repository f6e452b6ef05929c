"""Device-side batch prefetching: the port of
``chainermn_tpu/iterators/device_prefetch.py``.

Reference analog: the staging half of ``_memory_utility.py``'s pinned host
buffers (SURVEY.md §2.1): the reference overlapped host-to-device copies
with compute through pinned memory and CUDA streams, and so does this
module.  Each host batch is copied into one of ``depth + 1`` sets of
pinned staging buffers, then to the card by a ``non_blocking`` copy on a
side stream that records an event; the consumer's stream waits on that
event (no host sync) and the batch's tensors are marked with
``record_stream`` so that the caching allocator does not hand their
memory out again before the consumer is done with it.  A captured train
step copies the batch into its graph's static buffers on that same
stream, so the copy too waits on the batch's event.  A staging set is
rewritten only after its previous copy's event has completed.

Over a :class:`~chainermn_tpu_torch.iterators.PrefetchIterator` built with
``copy=False``, the host batch is a view into the native ring's slot; it is
copied into pinned memory before the next ``next()`` recycles the slot, so
no worker ever overwrites a slot a copy still reads.

Epoch bookkeeping (``epoch`` / ``is_new_epoch`` / ``iteration`` /
``epoch_detail``) reflects the CONSUMED batch, not the wrapped iterator's
submission cursor, so trainer triggers fire at the same ticks as without
the wrapper.  On the CPU the wrapper passes the host batches through
(copied, so a ring view never outlives its slot) with the same API and
bookkeeping.
"""

from __future__ import annotations

from collections import deque
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


def _leading_dim(batch: Any) -> int:
    if isinstance(batch, (tuple, list)):
        return _leading_dim(batch[0])
    return int(np.shape(batch)[0])


class _Entry(NamedTuple):
    batch: Any
    event: Optional[Any]
    epoch: int
    is_new_epoch: bool
    iteration: int
    epoch_detail: float
    n_samples: int
    # Inner iterator's checkpoint state captured just BEFORE this batch was
    # pulled: restoring from it replays this batch and everything after it.
    resume: Optional[dict]


class DevicePrefetchIterator:
    """Keeps up to ``depth`` batches on the communicator's device (or, on
    the CPU, in host memory), their copies issued ahead of consumption.

    Wraps any epoch-aware host iterator yielding a tuple of numpy arrays
    (:class:`~chainermn_tpu_torch.iterators.SerialIterator`,
    :class:`~chainermn_tpu_torch.iterators.PrefetchIterator`); on CUDA
    each yielded batch is a tuple of device tensors whose copy the current
    stream has been told to wait for.  ``h2d_ms`` (CUDA) holds the device
    time of each batch's copy once it is known (read from the events when
    the batch is consumed, so it never syncs; the newest 1024)."""

    def __init__(self, iterator, comm, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._it = iterator
        self._comm = comm
        self._depth = depth
        dev = getattr(comm, "device", None)
        self.device = torch.device(dev) if dev is not None \
            else torch.device("cpu")
        self._cuda = self.device.type == "cuda"
        self._queue: deque = deque()
        self._exhausted = False
        self.epoch = int(getattr(iterator, "epoch", 0))
        self.iteration = int(getattr(iterator, "iteration", 0))
        self.is_new_epoch = False
        self._epoch_detail = float(getattr(iterator, "epoch_detail", 0.0))
        # CUDA staging: depth + 1 pinned sets (one is being filled while
        # ``depth`` copies may still be in flight), each with the events
        # bracketing its newest copy.
        self._staging: list = []
        self._staging_events: list = []
        self._next_staging = 0
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        self.h2d_ms: deque = deque(maxlen=1024)
        self._fill()

    # ------------------------------------------------------------- pipeline
    def _stage(self, host):
        """Copy ``host`` (a tuple of arrays) into pinned memory, then to
        the device on the side stream; returns (device batch, (start,
        end) events)."""
        arrays = [np.ascontiguousarray(a) for a in host]
        k = self._next_staging
        self._next_staging = (k + 1) % (self._depth + 1)
        if k >= len(self._staging):
            self._staging.append(None)
            self._staging_events.append(None)
        bufs = self._staging[k]
        if bufs is None or [tuple(b.shape) for b in bufs] != \
                [a.shape for a in arrays] or \
                [b.dtype for b in bufs] != [torch.from_numpy(a[:0]).dtype
                                            for a in arrays]:
            if self._staging_events[k] is not None:
                self._staging_events[k][1].synchronize()
            bufs = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                pin_memory=True) for a in arrays]
            self._staging[k] = bufs
        elif self._staging_events[k] is not None:
            # This set's previous copy must be done before it is rewritten.
            self._staging_events[k][1].synchronize()
        for b, a in zip(bufs, arrays):
            b.copy_(torch.from_numpy(a))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record(self._stream)
            out = tuple(b.to(self.device, non_blocking=True) for b in bufs)
            end.record(self._stream)
        self._staging_events[k] = (start, end)
        return out, (start, end)

    def _fill(self) -> None:
        while not self._exhausted and len(self._queue) < self._depth:
            resume = self._snapshot_inner()
            try:
                host = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            if not isinstance(host, (tuple, list)):
                host = (host,)
            if self._cuda:
                batch, event = self._stage(host)
            else:
                batch, event = tuple(np.array(a) for a in host), None
            self._queue.append(_Entry(
                batch=batch, event=event,
                epoch=int(getattr(self._it, "epoch", 0)),
                is_new_epoch=bool(getattr(self._it, "is_new_epoch", False)),
                iteration=int(getattr(self._it, "iteration", 0)),
                epoch_detail=float(getattr(self._it, "epoch_detail", 0.0)),
                n_samples=_leading_dim(host),
                resume=resume,
            ))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._queue:
            raise StopIteration
        e = self._queue.popleft()
        if e.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(e.event[1])
            for t in e.batch:
                t.record_stream(stream)
            if e.event[1].query():
                self.h2d_ms.append(e.event[0].elapsed_time(e.event[1]))
        self.epoch = e.epoch
        self.is_new_epoch = e.is_new_epoch
        self.iteration = e.iteration
        self._epoch_detail = e.epoch_detail
        self._fill()
        return e.batch

    @property
    def epoch_detail(self) -> float:
        return self._epoch_detail

    # ---------------------------------------------------------- delegation
    def reset(self) -> None:
        self._it.reset()
        self._queue.clear()
        self._exhausted = False
        self.epoch = int(getattr(self._it, "epoch", 0))
        self.iteration = int(getattr(self._it, "iteration", 0))
        self.is_new_epoch = False
        self._epoch_detail = 0.0
        self._fill()

    def close(self) -> None:
        self._queue.clear()
        if self._cuda:
            for ev in self._staging_events:
                if ev is not None:
                    ev[1].synchronize()
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        # Passthrough for batch_size/_n/dataset/... (ProgressBar totals etc).
        it = self.__dict__.get("_it")
        if it is None:  # guard against recursion before __init__ ran
            raise AttributeError(name)
        return getattr(it, name)

    # ------------------------------------------------------- checkpointing
    def _snapshot_inner(self) -> Optional[dict]:
        """The inner iterator's checkpoint state, over both protocols: an
        inner ``checkpoint_loop_state`` (PrefetchIterator) is delegated
        to; a SerialIterator-shaped inner (``_pos``/``_order``/``_rng``)
        has the equivalent state synthesized here."""
        inner = getattr(self._it, "checkpoint_loop_state", None)
        if inner is not None:
            return inner()
        if hasattr(self._it, "_order") and hasattr(self._it, "_rng"):
            it = self._it
            mt, keys, pos, has_gauss, cached = it._rng.get_state()
            return {
                "pos": int(it._pos),
                "order": np.asarray(it._order, np.int64),
                "rng_keys": np.asarray(keys, np.uint32),
                "rng_pos": int(pos),
                "rng_has_gauss": int(has_gauss),
                "rng_cached": float(cached),
            }
        return None

    def checkpoint_loop_state(self) -> Optional[dict]:
        """Consumption-granular cursor for the multi-node checkpointer:
        the state captured just before the oldest unconsumed batch was
        pulled, so a restore replays the queue's contents exactly."""
        if self._queue:
            return self._queue[0].resume
        return self._snapshot_inner()

    def restore_loop_state(self, epoch: int, state: dict) -> None:
        self._queue.clear()
        self._exhausted = False
        inner = getattr(self._it, "restore_loop_state", None)
        if inner is not None:
            inner(epoch, state)
        else:
            it = self._it
            it.epoch = int(epoch)
            it.is_new_epoch = False
            it._pos = int(state["pos"])
            it._order = np.asarray(state["order"]).astype(np.int64)
            it._rng.set_state((
                "MT19937",
                np.asarray(state["rng_keys"]).astype(np.uint32),
                int(state["rng_pos"]),
                int(state["rng_has_gauss"]),
                float(state["rng_cached"]),
            ))
        self.epoch = int(getattr(self._it, "epoch", epoch))
        self.iteration = int(getattr(self._it, "iteration", 0))
        self.is_new_epoch = False
        self._fill()


def create_device_prefetch_iterator(iterator, communicator, depth: int = 2):
    """Wrap ``iterator`` so that batches reach the communicator's device
    ahead of the step that consumes them."""
    return DevicePrefetchIterator(iterator, communicator, depth=depth)
