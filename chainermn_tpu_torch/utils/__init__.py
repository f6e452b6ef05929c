"""Utilities of the port: device resolution and the Flax weight bridge."""

from chainermn_tpu_torch.utils.bridge import (
    mlp_params_from_flax,
    mlp_params_to_flax,
    params_from_flax,
    params_to_flax,
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["mlp_params_from_flax", "mlp_params_to_flax", "params_from_flax",
           "params_to_flax", "resnet_params_from_flax",
           "resnet_params_to_flax", "resolve_device"]
