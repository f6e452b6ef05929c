"""Model zoo of the port: the Transformer LM (dense or mixture of
experts), its generation loop (the serving slice), beam search and
speculative generation, and its training losses; ResNet and its stateful
loss; the MNIST example's MLP and its classification loss and metrics."""

from chainermn_tpu_torch.models.decoding import (
    lm_beam_search,
    lm_speculative_generate,
)
from chainermn_tpu_torch.models.mlp import (
    MLP,
    classification_loss,
    classification_metrics,
)
from chainermn_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    FusedConv1x1,
    ResNet,
    ResNet18,
    ResNet50,
    ResNetTiny,
    resnet_loss,
    s2d_stem_kernel,
    space_to_depth,
)
from chainermn_tpu_torch.models.transformer import (
    DecoderBlock,
    TransformerLM,
    lm_generate,
    lm_loss,
    lm_loss_chunked,
    moe_stats,
    segment_positions,
)
from chainermn_tpu_torch.ops.flash_attention import reference_attention

__all__ = ["MLP", "classification_loss", "classification_metrics",
           "BasicBlock", "BottleneckBlock", "DecoderBlock", "FusedConv1x1",
           "ResNet", "ResNet18", "ResNet50", "ResNetTiny", "TransformerLM",
           "lm_beam_search", "lm_generate", "lm_loss", "lm_loss_chunked",
           "lm_speculative_generate", "moe_stats", "reference_attention",
           "resnet_loss",
           "s2d_stem_kernel", "segment_positions", "space_to_depth"]
