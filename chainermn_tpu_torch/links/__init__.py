"""Links of the port: so far the cross-rank batch normalization."""

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
    sync_batch_norm,
)

__all__ = ["MultiNodeBatchNormalization", "sync_batch_norm"]
