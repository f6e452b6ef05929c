"""Carry trained weights across: Flax parameter trees -> the port's
``state_dict``.

The input is the JAX package's ``TransformerLM`` parameter tree with
every leaf as a numpy array (``jax.tree_util.tree_map(np.asarray,
params)``), so this module needs neither JAX nor Flax.  Layouts:

==========================================  ================================
Flax                                         port
==========================================  ================================
``embed.embedding (V, D)``                   ``embed.weight (V, D)``
``pos (max_len, D)``                         ``pos``
``block_i.ln1/ln2 .scale/.bias``             ``blocks.i.ln1/ln2 .weight/.bias``
``block_i.qkv.kernel (D, 3, H, Dh)``         ``blocks.i.qkv.weight (3·H·Dh, D)``
``block_i.q.kernel (D, H, Dh)``              ``blocks.i.q.weight (H·Dh, D)``
``block_i.kv.kernel (D, 2, KH, Dh)``         ``blocks.i.kv.weight (2·KH·Dh, D)``
``block_i.proj.kernel (H, Dh, D)``           ``blocks.i.proj.weight (D, H·Dh)``
``block_i.ff1/ff2.kernel (in, out)``         ``blocks.i.ff1/ff2.weight (out, in)``
``ln_f``, ``lm_head.kernel (D, V)``          ``ln_f``, ``lm_head.weight (V, D)``
==========================================  ================================

Biases flatten the same way as their kernels' output axes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from chainermn_tpu_torch.utils.device import resolve_device


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: not a numpy-native type
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16
        )
    # A copy: arrays from JAX are read-only, torch tensors are writable.
    return torch.from_numpy(np.array(arr)).to(device)


def _dense(out: Dict, name: str, p: Dict, device) -> None:
    """A Flax ``Dense``/``DenseGeneral`` whose kernel contracts its first
    axis: kernel ``(D, *out_axes)`` -> weight ``(prod(out_axes), D)``."""
    k = np.asarray(p["kernel"])
    out[f"{name}.weight"] = _tensor(k.reshape(k.shape[0], -1).T, device)
    out[f"{name}.bias"] = _tensor(np.asarray(p["bias"]).reshape(-1), device)


def _ln(out: Dict, name: str, p: Dict, device) -> None:
    out[f"{name}.weight"] = _tensor(p["scale"], device)
    out[f"{name}.bias"] = _tensor(p["bias"], device)


def params_from_flax(params: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerLM`` ``state_dict`` from a Flax parameter
    tree of numpy arrays.  ``device`` None means the current CUDA device
    (raises where there is none).  Load it with
    ``model.load_state_dict(...)``."""
    dev = resolve_device(device, "params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    out["embed.weight"] = _tensor(params["embed"]["embedding"], dev)
    if "pos" in params:
        out["pos"] = _tensor(params["pos"], dev)
    i = 0
    while f"block_{i}" in params:
        b = params[f"block_{i}"]
        pre = f"blocks.{i}"
        if "router" in b or "moe_w1" in b:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet (ROADMAP "
                "Queue 1, TransformerLM training)"
            )
        _ln(out, f"{pre}.ln1", b["ln1"], dev)
        _ln(out, f"{pre}.ln2", b["ln2"], dev)
        if "qkv" in b:
            _dense(out, f"{pre}.qkv", b["qkv"], dev)
        else:
            _dense(out, f"{pre}.q", b["q"], dev)
            _dense(out, f"{pre}.kv", b["kv"], dev)
        # proj contracts its two leading axes (H, Dh) into D.
        pk = np.asarray(b["proj"]["kernel"])
        out[f"{pre}.proj.weight"] = _tensor(
            pk.reshape(-1, pk.shape[-1]).T, dev
        )
        out[f"{pre}.proj.bias"] = _tensor(b["proj"]["bias"], dev)
        _dense(out, f"{pre}.ff1", b["ff1"], dev)
        _dense(out, f"{pre}.ff2", b["ff2"], dev)
        i += 1
    _ln(out, "ln_f", params["ln_f"], dev)
    _dense(out, "lm_head", params["lm_head"], dev)
    return out
