"""Parallelism strategies of the port (``chainermn_tpu/parallel``):

* :mod:`ring_attention` -- ring context parallelism: K/V blocks rotate
  around the sequence ranks, plain blocks or the flash kernels per block;
* :mod:`zigzag` -- the load-balanced causal ring over chunk pairs;
* :mod:`ulysses` -- sequence <-> heads all-to-alls around any local
  attention;
* :mod:`moe` -- expert parallelism: capacity-based top-k dispatch over
  an expert communicator, and the routing the single-card MoE FFN runs.

Each takes the communicator of the ranks it spans where the JAX package
takes a mesh axis name; every rank of it calls the function.
"""

from chainermn_tpu_torch.parallel.moe import (
    MoELayer,
    moe_combine,
    moe_dispatch,
)
from chainermn_tpu_torch.parallel.ring_attention import (
    ring_flash_self_attention,
    ring_self_attention,
)
from chainermn_tpu_torch.parallel.ulysses import ulysses_attention
from chainermn_tpu_torch.parallel.zigzag import (
    zigzag_order,
    zigzag_ring_self_attention,
    zigzag_shard,
    zigzag_unshard,
)

__all__ = [
    "MoELayer",
    "moe_combine",
    "moe_dispatch",
    "ring_flash_self_attention",
    "ring_self_attention",
    "ulysses_attention",
    "zigzag_order",
    "zigzag_ring_self_attention",
    "zigzag_shard",
    "zigzag_unshard",
]
