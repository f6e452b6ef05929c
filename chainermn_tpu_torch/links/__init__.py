"""Links of the port: the cross-rank batch normalization, the
model-parallel chain (``MultiNodeChainList``) and the GPipe pipelines
(``PipelineChain``, ``HeteroPipelineChain``)."""

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
    sync_batch_norm,
)
from chainermn_tpu_torch.links.chain_list import (
    HeteroPipelineChain,
    MultiNodeChainList,
    PipelineChain,
)

__all__ = ["HeteroPipelineChain", "MultiNodeBatchNormalization",
           "MultiNodeChainList", "PipelineChain", "sync_batch_norm"]
