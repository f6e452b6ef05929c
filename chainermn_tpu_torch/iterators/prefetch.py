"""Prefetching batch iterator over the native threaded batch assembler:
the port of ``chainermn_tpu/iterators/prefetch.py``.

Reference analog: the ImageNet example's multiprocess data loading
(SURVEY.md §2.9, Chainer ``MultiprocessIterator``).  Worker threads in C++
(``chainermn_tpu_torch/native/dataloader.cpp``) gather dataset rows into a
ring of preassembled batch buffers while the card runs the previous step;
Python wraps the ready slot in numpy.  The batch order is
:class:`~chainermn_tpu_torch.iterators.SerialIterator`'s for the same seed
(one shared index function), and so the JAX package's.

Unlike the JAX module, a library that cannot be built raises
(:class:`~chainermn_tpu_torch.native.NativeBuildError`): there is no
synchronous fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from chainermn_tpu_torch import native


class PrefetchIterator:
    """Epoch-aware iterator with native background batch assembly.

    Drop-in for :class:`~chainermn_tpu_torch.iterators.SerialIterator`
    over array-backed datasets (anything exposing ``.arrays``: a tuple of
    row-major numpy arrays sharing their leading dim) and ``SubDataset``
    views of them.  ``copy=False`` hands out views into the ring slot,
    valid until the next ``next()`` (the slot is recycled then): what
    :class:`~chainermn_tpu_torch.iterators.DevicePrefetchIterator` wants,
    which copies each batch into pinned memory at once.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        repeat: bool = True,
        shuffle: bool = True,
        seed: Optional[int] = None,
        depth: int = 4,
        n_workers: int = 4,
        copy: bool = True,
    ):
        # A scatter_dataset SubDataset view composes for free: gather from
        # the BASE arrays through the view's index map, so the native
        # workers page rows (mmap'd file-backed data included) off the
        # consumer thread instead of materializing the shard up front.
        translate = None
        src = dataset
        if not hasattr(src, "arrays"):
            inner = getattr(src, "base", None)
            if inner is not None and hasattr(inner, "arrays") and hasattr(
                src, "indices"
            ):
                translate = np.ascontiguousarray(
                    np.asarray(src.indices, np.int64)
                )
                src = inner
            else:
                raise TypeError(
                    "PrefetchIterator needs an array-backed dataset "
                    "(`.arrays`) or a SubDataset view of one; got "
                    f"{type(dataset).__name__}"
                )
        # No-copy for already-contiguous arrays (incl. np.memmap — the
        # file stays the backing store).
        arrays = tuple(np.ascontiguousarray(a) for a in src.arrays)
        self._arrays = arrays  # keep alive: native loader reads these bases
        self._translate = translate
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._depth = depth
        self._copy = copy
        self._n = len(dataset)

        lib = native.load_dataloader()
        self._lib = lib
        self._h = None
        bases = (ctypes.c_void_p * len(arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
        )
        row_bytes = (ctypes.c_uint64 * len(arrays))(
            *[a.strides[0] for a in arrays]
        )
        strides = (ctypes.c_uint64 * len(arrays))(
            *[a.strides[0] for a in arrays]
        )
        self._h = lib.loader_create(
            bases, row_bytes, strides, len(arrays), batch_size,
            depth, n_workers,
        )
        if not self._h:
            raise ValueError(
                f"loader_create refused batch_size={batch_size}, "
                f"depth={depth}, n_workers={n_workers}")
        self.reset()

    # ------------------------------------------------------------- ordering
    def reset(self):
        # Recycle the zero-copy held slot, then drain in-flight slots from a
        # previous run of the ring.
        if getattr(self, "_held_slot", None) is not None:
            self._lib.loader_release(self._h, self._held_slot)
        self._held_slot: Optional[int] = None
        if getattr(self, "_h", None) and getattr(self, "_pending", None):
            while self._pending:
                if self._pending.pop(0)[1] is None:  # native-assembled
                    slot = self._lib.loader_next(self._h, -1)
                    if slot >= 0:
                        self._lib.loader_release(self._h, slot)
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._consumed = 0  # samples consumed this epoch (not submitted)
        # Per-epoch (order, rng before/after its draw) in draw order; front =
        # the epoch currently being CONSUMED.  Lets the checkpoint cursor
        # stay exact even when the submission side has already drawn later
        # epochs' permutations (lookahead ring).
        self._epoch_log = []
        self._order = self._new_order()
        self._pos = 0
        # Per submitted batch: (epoch_completing, short_tail_indices_or_None).
        self._pending: list = []
        for _ in range(self._depth):
            self._submit_next()

    def _new_order(self):
        rng_before = self._rng.get_state()
        order = (
            self._rng.permutation(self._n)
            if self._shuffle
            else np.arange(self._n)
        )
        self._epoch_log.append({
            "order": np.asarray(order, np.int64),
            "rng_before": rng_before,
            "rng_after": self._rng.get_state(),
        })
        return order

    def _next_indices(self):
        """Next batch's ``(row indices, completes_epoch, wrapped)`` — the
        exact semantics shared with SerialIterator (one implementation, so
        the two iterators cannot drift)."""
        from chainermn_tpu_torch.iterators import _next_epoch_indices

        return _next_epoch_indices(self)

    def _submit_next(self) -> bool:
        nxt = self._next_indices()
        if nxt is None:
            return False
        idx, completes, wrapped = nxt
        if self._translate is not None:  # shard position → base row
            idx = np.ascontiguousarray(self._translate[idx])
        if len(idx) < self.batch_size:
            # repeat=False short tail: the native ring is fixed-batch, so
            # assemble this one in Python at consume time.
            self._pending.append((completes, idx, wrapped))
            return True
        buf = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        seq = self._lib.loader_submit(self._h, buf, len(idx))
        if seq < 0:
            raise RuntimeError(f"loader_submit failed (rc={seq})")
        self._pending.append((completes, None, wrapped))
        return True

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            raise StopIteration
        # zero-copy mode hands out views into the slot: recycle the previous
        # slot only now, once the caller is done with its views.
        if self._held_slot is not None:
            self._lib.loader_release(self._h, self._held_slot)
            self._held_slot = None
        completes, tail_idx, wrapped = self._pending.pop(0)
        if tail_idx is not None:  # Python-assembled short tail (repeat=False)
            self._finish_tick(completes, len(tail_idx), wrapped)
            return tuple(a[tail_idx] for a in self._arrays)
        slot = self._lib.loader_next(self._h, -1)
        if slot < 0:
            raise RuntimeError(f"loader_next failed (rc={slot})")
        out = []
        for f, a in enumerate(self._arrays):
            ptr = self._lib.loader_slot_ptr(self._h, slot, f)
            shape = (self.batch_size,) + a.shape[1:]
            arr = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(int(np.prod(shape)) * a.dtype.itemsize,),
            ).view(a.dtype).reshape(shape)
            out.append(arr.copy() if self._copy else arr)
        if self._copy:
            self._lib.loader_release(self._h, slot)
        else:
            self._held_slot = slot
        self._finish_tick(completes, self.batch_size, wrapped)
        self._submit_next()  # keep the ring full
        return tuple(out)

    def _finish_tick(self, completes: bool, n_samples: int, wrapped: int = 0):
        self.iteration += 1
        self._consumed += n_samples
        if completes:
            self.epoch += 1
            self.is_new_epoch = True
            # A boundary-spanning batch (n % batch_size != 0, repeat=True)
            # already consumed `wrapped` samples of the NEXT epoch — the
            # cursor must carry them or a mid-epoch checkpoint in the new
            # epoch is silently offset by that many samples.
            self._consumed = int(wrapped)
            if self._epoch_log:  # consumed epoch done; front = next epoch
                self._epoch_log.pop(0)
        else:
            self.is_new_epoch = False

    # --------------------------------------------------------- checkpointing
    def checkpoint_loop_state(self) -> dict:
        """Consumption-granular cursor for the multi-node checkpointer.

        The submission cursor (``_pos``) runs ``depth`` batches ahead of
        consumption in native mode, so the raw attributes must never be
        saved/restored directly (stale in-flight batches + a skewed cursor).
        ``pos`` here is SAMPLES CONSUMED this epoch.  EXACT everywhere: the
        per-epoch draw log reconstructs the consumption epoch's permutation
        and the RNG state as of just after (mid-epoch) or just before
        (boundary — restore's fresh draw then reproduces the very same
        upcoming permutation) its draw, no matter how far the lookahead has
        run ahead."""
        ent = self._epoch_log[0] if self._epoch_log else None
        if int(self._consumed) > 0 and ent is not None:
            # Mid-epoch: this epoch's order + the RNG just after its draw,
            # so post-restore wraps continue the original draw sequence.
            rng_state = ent["rng_after"]
            order = ent["order"]
            pos = int(self._consumed)
        else:
            # Epoch boundary: restore draws fresh from this state, which is
            # the state the upcoming epoch's order was (or will be) drawn
            # from — the draw reproduces it exactly.
            if ent is not None and ent["rng_before"] is not None:
                rng_state = ent["rng_before"]
            else:
                rng_state = self._rng.get_state()
            order = self._order
            pos = 0
        mt, keys, rpos, has_gauss, cached = rng_state
        return {
            "pos": pos,
            "order": np.asarray(order, np.int64),
            "rng_keys": np.asarray(keys, np.uint32),
            "rng_pos": int(rpos),
            "rng_has_gauss": int(has_gauss),
            "rng_cached": float(cached),
        }

    def restore_loop_state(self, epoch: int, state: dict) -> None:
        """Restore from :meth:`checkpoint_loop_state`: drain the ring,
        reinstall the cursor, refill the lookahead from the restored order."""
        # Drain in-flight slots (same recycle discipline as reset()).
        if self._held_slot is not None:
            self._lib.loader_release(self._h, self._held_slot)
            self._held_slot = None
        if self._h and self._pending:
            while self._pending:
                if self._pending.pop(0)[1] is None:
                    slot = self._lib.loader_next(self._h, -1)
                    if slot >= 0:
                        self._lib.loader_release(self._h, slot)
        self.epoch = int(epoch)
        self.is_new_epoch = False
        self._rng.set_state((
            "MT19937",
            np.asarray(state["rng_keys"]).astype(np.uint32),
            int(state["rng_pos"]),
            int(state["rng_has_gauss"]),
            float(state["rng_cached"]),
        ))
        self._consumed = int(state["pos"])
        self._pos = int(state["pos"])
        self._epoch_log = []
        if int(state["pos"]) > 0:
            self._order = np.asarray(state["order"]).astype(np.int64)
            # Seed the draw log: RNG is this epoch's post-draw state, so
            # later wraps continue the original permutation sequence.
            self._epoch_log.append({
                "order": self._order,
                "rng_before": None,
                "rng_after": self._rng.get_state(),
            })
        else:
            # Epoch boundary: fresh draw (reproduces the upcoming epoch's
            # permutation — the saved RNG state predates its draw).
            self._order = self._new_order()
        self._pending = []
        if self._h:
            for _ in range(self._depth):
                self._submit_next()

    @property
    def epoch_detail(self):
        # Consumption-based (the submission cursor runs `depth` batches ahead
        # in native mode and must not leak into schedules keyed on progress).
        return self.epoch + min(self._consumed / max(self._n, 1), 1.0)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
