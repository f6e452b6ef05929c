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

``Scheduler`` takes the JAX scheduler's planes (``slo``, ``timeline``,
``memory``, ``incidents``, ``ledger``; on by default under ``CMN_OBS``)
and a :class:`PolicyPlane` (``policy=``).  On a CUDA device the engine
captures its decode step once as a CUDA graph and replays it.  The
router, disaggregated prefill/decode, elastic fleet and tensor-parallel
engine are not ported yet.
"""

from chainermn_tpu_torch.serving.engine import DecodeEngine
from chainermn_tpu_torch.serving.kv_pool import (
    BlockAllocator,
    PagedKVPool,
    PoolExhausted,
    blocks_for,
)
from chainermn_tpu_torch.serving.policy import PolicyPlane, TenantPolicy
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
    "PolicyPlane",
    "PoolExhausted",
    "PrefixCache",
    "Request",
    "Scheduler",
    "TenantPolicy",
    "blocks_for",
    "deadline_ms_from_env",
]
