"""Model zoo of the port: the Transformer LM (dense or mixture of
experts), its generation loop (the serving slice), beam search and
speculative generation, and its training losses; ResNet and its stateful
loss; the MNIST example's MLP and its classification loss and metrics;
the seq2seq family (LSTM and Transformer encoder-decoders, their loss and
decoders); ViT; LoRA adapters over any of them; VGG's stages, their
model-parallel chain and pipeline; the 5-way-parallel ``ParallelLM``;
the channel-parallel convnet and the data-parallel DCGAN."""

from chainermn_tpu_torch.models.dcgan import (
    Discriminator,
    GanState,
    Generator,
    gan_init,
    make_gan_train_step,
)
from chainermn_tpu_torch.models.decoding import (
    lm_beam_search,
    lm_speculative_generate,
)
from chainermn_tpu_torch.models.lora import (
    DEFAULT_TARGETS,
    LoRA,
    lora_init,
    lora_merge,
    lora_param_count,
    make_lora_loss,
)
from chainermn_tpu_torch.models.mlp import (
    MLP,
    classification_loss,
    classification_metrics,
)
from chainermn_tpu_torch.models.parallel_convnet import (
    channel_parallel_apply,
    channel_parallel_leaves,
    channel_parallel_loss,
    channel_parallel_specs,
    dense_reference_apply,
    init_channel_parallel,
    make_channel_parallel_train_step,
    shard_channel_parallel,
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
from chainermn_tpu_torch.models.seq2seq import (
    Seq2Seq,
    TransformerSeq2Seq,
    beam_decode,
    greedy_decode,
    seq2seq_loss,
)
from chainermn_tpu_torch.models.transformer import (
    PARALLEL_LM_AXES,
    DecoderBlock,
    ParallelLM,
    ParallelLMConfig,
    TransformerLM,
    dense_lm_reference,
    init_parallel_lm,
    lm_generate,
    lm_loss,
    lm_loss_chunked,
    moe_stats,
    parallel_lm_specs,
    segment_positions,
)
from chainermn_tpu_torch.models.vgg import (
    VGG_CFGS,
    VGGHead,
    VGGStage,
    apply_sequential,
    build_chain,
    build_hetero_pipeline,
    vgg_loss,
    vgg_stage_modules,
)
from chainermn_tpu_torch.models.vit import ViT, vit_loss
from chainermn_tpu_torch.ops.flash_attention import reference_attention

__all__ = ["Discriminator", "GanState", "Generator", "gan_init",
           "make_gan_train_step", "channel_parallel_apply",
           "channel_parallel_leaves", "channel_parallel_loss",
           "channel_parallel_specs", "dense_reference_apply",
           "init_channel_parallel", "make_channel_parallel_train_step",
           "shard_channel_parallel",
           "MLP", "PARALLEL_LM_AXES", "ParallelLM", "ParallelLMConfig",
           "dense_lm_reference", "init_parallel_lm", "parallel_lm_specs",
           "classification_loss", "classification_metrics",
           "BasicBlock", "BottleneckBlock", "DEFAULT_TARGETS", "DecoderBlock",
           "FusedConv1x1", "LoRA", "ResNet", "ResNet18", "ResNet50",
           "ResNetTiny", "Seq2Seq", "TransformerLM", "TransformerSeq2Seq",
           "ViT", "beam_decode", "greedy_decode", "lm_beam_search",
           "lm_generate", "lm_loss", "lm_loss_chunked",
           "lm_speculative_generate", "lora_init", "lora_merge",
           "lora_param_count", "make_lora_loss", "moe_stats",
           "reference_attention", "resnet_loss", "s2d_stem_kernel",
           "segment_positions", "seq2seq_loss", "space_to_depth",
           "VGG_CFGS", "VGGHead", "VGGStage", "apply_sequential",
           "build_chain", "build_hetero_pipeline", "vgg_loss",
           "vgg_stage_modules", "vit_loss"]
