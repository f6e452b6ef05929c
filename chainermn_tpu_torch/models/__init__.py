"""Model zoo of the port: so far the Transformer LM and its generation
loop (the serving slice)."""

from chainermn_tpu_torch.models.transformer import (
    DecoderBlock,
    TransformerLM,
    lm_generate,
    reference_attention,
)

__all__ = ["DecoderBlock", "TransformerLM", "lm_generate",
           "reference_attention"]
