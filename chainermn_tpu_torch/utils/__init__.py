"""Utilities of the port: device resolution and the Flax weight bridge."""

from chainermn_tpu_torch.utils.bridge import params_from_flax
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_flax", "resolve_device"]
