"""Links of the port: the cross-rank batch normalization and the
model-parallel chain (``MultiNodeChainList``)."""

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
    sync_batch_norm,
)
from chainermn_tpu_torch.links.chain_list import MultiNodeChainList

__all__ = ["MultiNodeBatchNormalization", "MultiNodeChainList",
           "sync_batch_norm"]
