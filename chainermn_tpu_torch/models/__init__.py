"""Model zoo of the port: so far the Transformer LM, its generation
loop (the serving slice) and its training loss."""

from chainermn_tpu_torch.models.transformer import (
    DecoderBlock,
    TransformerLM,
    lm_generate,
    lm_loss,
    segment_positions,
)
from chainermn_tpu_torch.ops.flash_attention import reference_attention

__all__ = ["DecoderBlock", "TransformerLM", "lm_generate", "lm_loss",
           "reference_attention", "segment_positions"]
