"""Hot ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them, and the elementwise helpers around them.

The kernels build from ``chainermn_tpu_torch/csrc/`` at first use on a
CUDA host (:mod:`chainermn_tpu_torch.ops._kernels`); on the CPU each
wrapper runs its plain version.
"""

from chainermn_tpu_torch.ops.decode_attention import (
    MAX_FUSED_LEN,
    MAX_VERIFY_T,
    fused_decode_attention,
    fused_decode_attention_reference,
    paged_decode_attention,
    paged_decode_attention_reference,
)
from chainermn_tpu_torch.ops.rope import apply_rope, rope_tables

__all__ = [
    "MAX_FUSED_LEN",
    "MAX_VERIFY_T",
    "fused_decode_attention",
    "fused_decode_attention_reference",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "apply_rope",
    "rope_tables",
]
