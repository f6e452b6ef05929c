"""Continuous-batching serving on the port: a paged KV pool, a
fixed-shape decode engine whose hot loop runs the hand-written paged
decode kernel, a prefix trie, and an iteration-level scheduler.

Typical use::

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine, Request, Scheduler

    model = TransformerLM(vocab=32768, n_layers=12, d_model=768,
                          n_heads=12, d_ff=3072, pos_enc="rope",
                          decode_attention="fused")
    eng = DecodeEngine(model, capacity=8, num_blocks=512, block_len=16,
                       prefill_chunk=32)
    done = Scheduler(eng).run([Request(id=0, prompt=[1, 2, 3],
                                       max_new_tokens=16)])

The router, disaggregated prefill/decode, elastic fleet, policy plane and
tensor-parallel engine are not ported yet.
"""

from chainermn_tpu_torch.serving.engine import DecodeEngine
from chainermn_tpu_torch.serving.kv_pool import (
    BlockAllocator,
    PagedKVPool,
    PoolExhausted,
    blocks_for,
)
from chainermn_tpu_torch.serving.prefix_cache import PrefixCache
from chainermn_tpu_torch.serving.recovery import deadline_ms_from_env
from chainermn_tpu_torch.serving.scheduler import (
    Completion,
    Request,
    Scheduler,
)

__all__ = [
    "BlockAllocator",
    "Completion",
    "DecodeEngine",
    "PagedKVPool",
    "PoolExhausted",
    "PrefixCache",
    "Request",
    "Scheduler",
    "blocks_for",
    "deadline_ms_from_env",
]
