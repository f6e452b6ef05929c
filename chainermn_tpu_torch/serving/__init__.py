"""Continuous-batching serving on the port: a paged KV pool, a
fixed-shape decode engine whose hot loop runs the hand-written paged
decode kernel, a prefix trie, an iteration-level scheduler, and the
serving fleet over it.

Typical use::

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import DecodeEngine, Request, Router

    model = TransformerLM(vocab=32768, n_layers=12, d_model=768,
                          n_heads=12, d_ff=3072, pos_enc="rope",
                          decode_attention="fused")
    engines = [DecodeEngine(model, capacity=8, num_blocks=512,
                            block_len=16, prefill_chunk=32)
               for _ in range(2)]
    done = Router(engines).run([Request(id=0, prompt=[1, 2, 3],
                                        max_new_tokens=16)])

``Scheduler`` takes the JAX scheduler's planes (``slo``, ``timeline``,
``memory``, ``incidents``, ``ledger``; on by default under ``CMN_OBS``)
and a :class:`PolicyPlane` (``policy=``).  On a CUDA device the engine
captures its decode step once as a CUDA graph and replays it.

The fleet runs its replicas in one process (they may share one model's
weights on one card):

* :mod:`~chainermn_tpu_torch.serving.router` — least-loaded dispatch
  over the replicas' live gauges, backpressure, queued-work rebalance,
  one shared clock, ledger and policy plane, and a merged fleet trace;
* :mod:`~chainermn_tpu_torch.serving.recovery` — the failure plane
  (per-replica fault boundary, retry budgets and poison quarantine,
  probation, deadlines, load shedding) and the seeded chaos harness
  with its terminal invariant;
* :mod:`~chainermn_tpu_torch.serving.disagg` — disaggregated
  prefill/decode roles with byte-identical KV-block migration over an
  object plane (the in-process :class:`LocalComm`), and the zero-loss
  drain;
* :mod:`~chainermn_tpu_torch.serving.elastic` — the closed-loop
  :class:`Autoscaler` and the health-gated :class:`RollingDeploy`.

The JAX package's tensor-parallel engine (``serving_mesh``,
``DecodeEngine(mesh=)``) is not ported.
"""

from chainermn_tpu_torch.serving.disagg import (
    DecodeRole,
    LocalComm,
    MigrationError,
    MigrationTransport,
    PrefillRole,
    drain_all,
    serve_disaggregated,
)
from chainermn_tpu_torch.serving.elastic import Autoscaler, RollingDeploy
from chainermn_tpu_torch.serving.engine import DecodeEngine
from chainermn_tpu_torch.serving.kv_pool import (
    BlockAllocator,
    PagedKVPool,
    PoolExhausted,
    blocks_for,
)
from chainermn_tpu_torch.serving.policy import PolicyPlane, TenantPolicy
from chainermn_tpu_torch.serving.prefix_cache import PrefixCache
from chainermn_tpu_torch.serving.recovery import (
    ChaosHarness,
    FleetHealth,
    chaos_schedule,
    deadline_ms_from_env,
    verify_terminal_invariant,
)
from chainermn_tpu_torch.serving.router import Router
from chainermn_tpu_torch.serving.scheduler import (
    Completion,
    Request,
    Scheduler,
)

__all__ = [
    "Autoscaler",
    "BlockAllocator",
    "ChaosHarness",
    "Completion",
    "DecodeEngine",
    "DecodeRole",
    "FleetHealth",
    "LocalComm",
    "MigrationError",
    "MigrationTransport",
    "PagedKVPool",
    "PolicyPlane",
    "PoolExhausted",
    "PrefillRole",
    "PrefixCache",
    "Request",
    "RollingDeploy",
    "Router",
    "Scheduler",
    "TenantPolicy",
    "blocks_for",
    "chaos_schedule",
    "deadline_ms_from_env",
    "drain_all",
    "serve_disaggregated",
    "verify_terminal_invariant",
]
