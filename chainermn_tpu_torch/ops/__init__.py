"""Hot ops of the port: hand-written Hopper kernels with their plain
PyTorch versions beside them, and the elementwise helpers around them.

The kernels build from ``chainermn_tpu_torch/csrc/`` at first use on a
CUDA host (:mod:`chainermn_tpu_torch.ops._kernels`); on the CPU each
wrapper runs its plain version.  The max-pool with its first-max-wins
backward (``pooling``) and the crop/flip augmentation (``augment``) are
plain PyTorch in both packages.
"""

from chainermn_tpu_torch.ops.augment import (
    crop,
    flip,
    random_crop,
    random_crop_flip,
    random_flip,
)
from chainermn_tpu_torch.ops.chunked_ce import chunked_softmax_cross_entropy
from chainermn_tpu_torch.ops.conv_fused import (
    MatmulAffineFunction,
    conv1x1_bn_relu,
    matmul_affine,
    matmul_affine_fwd,
    matmul_affine_reference,
)
from chainermn_tpu_torch.ops.decode_attention import (
    MAX_FUSED_LEN,
    MAX_VERIFY_T,
    fused_decode_attention,
    fused_decode_attention_reference,
    paged_decode_attention,
    paged_decode_attention_reference,
    sharded_fused_decode_attention,
    sharded_paged_decode_attention,
)
from chainermn_tpu_torch.ops.flash_attention import (
    FLASH_MIN_SEQ,
    FLASH_MIN_SEQ_NONCAUSAL,
    FlashAttentionFunction,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
    flash_attention_lse,
    reference_attention,
    resolve_attention,
)
from chainermn_tpu_torch.ops.pooling import max_pool_fused
from chainermn_tpu_torch.ops.rope import apply_rope, rope_tables

__all__ = [
    "crop",
    "flip",
    "random_crop",
    "random_crop_flip",
    "random_flip",
    "max_pool_fused",
    "chunked_softmax_cross_entropy",
    "MatmulAffineFunction",
    "conv1x1_bn_relu",
    "matmul_affine",
    "matmul_affine_fwd",
    "matmul_affine_reference",
    "MAX_FUSED_LEN",
    "MAX_VERIFY_T",
    "fused_decode_attention",
    "fused_decode_attention_reference",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "sharded_fused_decode_attention",
    "sharded_paged_decode_attention",
    "FLASH_MIN_SEQ",
    "FLASH_MIN_SEQ_NONCAUSAL",
    "FlashAttentionFunction",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_reference",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "flash_attention_lse",
    "reference_attention",
    "resolve_attention",
    "apply_rope",
    "rope_tables",
]
