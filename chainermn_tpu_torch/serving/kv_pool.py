"""Block-granular KV allocator over a fixed device-resident pool.

The static-batch decode path (:func:`~chainermn_tpu_torch.models.lm_generate`)
sizes one contiguous cache to the longest request and holds it for the
whole batch.  The serving engine instead draws from one physical **block
pool** per layer, laid out kv-head major exactly as the paged decode
kernel reads it:

    ``{"k", "v"}``:  ``(KH, num_blocks, block_len, Dh)``
    ``{"k_scale", "v_scale"}`` (int8 pools): ``(KH, num_blocks, block_len)``

A decode slot owns an ordered list of physical blocks (its *block table*);
logical position ``p`` lives at ``(table[p // block_len], p % block_len)``.
Blocks are recycled through a host-side free list the moment a request
retires or is evicted (vLLM's PagedAttention memory model, Kwon et al.
2023).

Accounting is pure host state: :class:`BlockAllocator` is a Python free
list plus a per-block refcount map, so allocation, sharing and freeing
never read device memory.  Refcounts make prefix sharing safe: one
physical block can back the same prompt prefix in many block tables (and
stay pinned by the prefix trie after its requests retire); it returns to
the free list only when the last holder lets go.

Physical block 0 is reserved as the **parking block**: the paged decode
branch redirects idle slots' writes there.  The allocator never hands it
out, and no live slot reads it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


class PoolExhausted(RuntimeError):
    """A request needs more blocks than the pool can ever provide."""


class BlockAllocator:
    """Host-side refcounted free-list accounting for the physical pool.

    ``alloc`` hands a block out at refcount 1; :meth:`share` lends it to
    another holder (prefix sharing, or the prefix trie's pin); ``free``
    drops one reference and reclaims the block only when the count hits
    zero.  Freeing a block nobody holds raises: silent accounting drift
    would surface later as two slots writing the same physical block.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (block 0 is reserved), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are re-issued first.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        """Current holder count (0 = free or reserved)."""
        return self._ref.get(block, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical block ids at refcount 1 each, or ``None`` when
        the pool is exhausted (the scheduler's backpressure signal; never
        raises)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, blocks: Sequence[int]) -> None:
        """Add one reference per block (the block must be live: sharing a
        free block would resurrect reclaimed memory)."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"sharing block {b} that is not allocated: a borrowed "
                    "reference must come from a live holder"
                )
        for b in blocks:
            self._ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block returns to the free list
        when its count reaches zero.  Freeing an unallocated block
        (over-free or foreign id) raises."""
        for b in blocks:
            n = self._ref.get(b, 0)
            if n == 0:
                raise ValueError(
                    f"freeing block {b} that was never allocated (over-"
                    "free or foreign id): allocator state is corrupt"
                )
            if n == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = n - 1


def blocks_for(tokens: int, block_len: int) -> int:
    """Blocks needed to hold ``tokens`` positions."""
    return max(1, math.ceil(tokens / block_len))


class PagedKVPool:
    """The device-resident pools (one ``{"k", "v"[, scales]}`` dict of
    tensors per layer) plus their :class:`BlockAllocator`.

    Built from the model's geometry, so the pool entries are exactly what
    :class:`~chainermn_tpu_torch.models.TransformerLM`'s paged decode
    branch expects.  ``kv_dtype=torch.int8`` models get int8 pools with
    fp32 scale planes.  The pools live on ``device`` (the model's device
    when None).
    """

    def __init__(self, model, num_blocks: int, block_len: int,
                 device=None):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        kvh = model.n_kv_heads or model.n_heads
        dh = model.d_model // model.n_heads
        kvd = model.kv_dtype if model.kv_dtype is not None else model.dtype
        dev = torch.device(device) if device is not None else model.device
        shape = (kvh, num_blocks, block_len, dh)
        self.block_len = block_len
        self.num_blocks = num_blocks
        self.device = dev
        self.allocator = BlockAllocator(num_blocks)
        if kvd == torch.int8:
            self.pools: List[Dict[str, torch.Tensor]] = [
                {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.zeros(shape[:3], device=dev),
                 "v_scale": torch.zeros(shape[:3], device=dev)}
                for _ in range(model.n_layers)
            ]
            per_layer = 2 * kvh * block_len * (dh + 4)  # int8 k+v + scales
        else:
            if not kvd.is_floating_point:
                raise ValueError(
                    f"kv_dtype must be a float dtype or torch.int8, got {kvd}"
                )
            self.pools = [
                {"k": torch.zeros(shape, dtype=kvd, device=dev),
                 "v": torch.zeros(shape, dtype=kvd, device=dev)}
                for _ in range(model.n_layers)
            ]
            per_layer = 2 * kvh * block_len * dh * kvd.itemsize
        #: device bytes one physical block costs across all layers.
        self.bytes_per_block = int(per_layer * model.n_layers)
