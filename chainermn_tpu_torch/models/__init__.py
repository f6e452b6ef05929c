"""Model zoo of the port: the Transformer LM, its generation loop (the
serving slice) and its training loss; ResNet and its stateful loss."""

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
    segment_positions,
)
from chainermn_tpu_torch.ops.flash_attention import reference_attention

__all__ = ["BasicBlock", "BottleneckBlock", "DecoderBlock", "FusedConv1x1",
           "ResNet", "ResNet18", "ResNet50", "ResNetTiny", "TransformerLM",
           "lm_generate", "lm_loss", "reference_attention", "resnet_loss",
           "s2d_stem_kernel", "segment_positions", "space_to_depth"]
