"""Utilities of the port: device resolution and the Flax weight bridge."""

from chainermn_tpu_torch.utils.bridge import (
    flax_shapes,
    lora_params_from_flax,
    lora_params_to_flax,
    lstm_seq2seq_params_from_flax,
    lstm_seq2seq_params_to_flax,
    mlp_params_from_flax,
    mlp_params_to_flax,
    params_from_flax,
    params_to_flax,
    resnet_params_from_flax,
    resnet_params_to_flax,
    seq2seq_params_from_flax,
    seq2seq_params_to_flax,
    vit_params_from_flax,
    vit_params_to_flax,
)
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["flax_shapes", "lora_params_from_flax", "lora_params_to_flax",
           "lstm_seq2seq_params_from_flax", "lstm_seq2seq_params_to_flax",
           "mlp_params_from_flax", "mlp_params_to_flax", "params_from_flax",
           "params_to_flax", "resnet_params_from_flax",
           "resnet_params_to_flax", "resolve_device",
           "seq2seq_params_from_flax", "seq2seq_params_to_flax",
           "vit_params_from_flax", "vit_params_to_flax"]
