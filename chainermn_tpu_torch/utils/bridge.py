"""Carry weights across: Flax parameter trees -> the port's
``state_dict`` (:func:`params_from_flax` for ``TransformerLM``,
:func:`resnet_params_from_flax` for ``ResNet``), and the port's parameters
or gradients back into the Flax layout (:func:`params_to_flax`,
:func:`resnet_params_to_flax`).

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
``block_i.router (D, E)``, ``moe_w1 (E, D,    ``blocks.i.router``, ``moe_w1``, ...
F)``, ``moe_b1 (E, F)``, ``moe_w2 (E, F,      (the same layouts)
D)``, ``moe_b2 (E, D)`` (MoE blocks)
``ln_f``, ``lm_head.kernel (D, V)``          ``ln_f``, ``lm_head.weight (V, D)``
==========================================  ================================

Biases flatten the same way as their kernels' output axes.  The ResNet
and MLP mappings are described beside their functions below.
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


#: a MoE block's parameters, named and laid out alike on both sides.
MOE_PARAMS = ("router", "moe_w1", "moe_b1", "moe_w2", "moe_b2")


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
        if "router" in b:
            for n in MOE_PARAMS:
                out[f"{pre}.{n}"] = _tensor(b[n], dev)
        else:
            _dense(out, f"{pre}.ff1", b["ff1"], dev)
            _dense(out, f"{pre}.ff2", b["ff2"], dev)
        i += 1
    _ln(out, "ln_f", params["ln_f"], dev)
    _dense(out, "lm_head", params["lm_head"], dev)
    return out


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()


def _dense_back(sd, name: str, out_axes) -> Dict:
    w = _np(sd[f"{name}.weight"])
    return {"kernel": w.T.reshape(w.shape[1], *out_axes),
            "bias": _np(sd[f"{name}.bias"]).reshape(out_axes)}


def _ln_back(sd, name: str) -> Dict:
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def params_to_flax(tensors: Dict[str, torch.Tensor], n_heads: int,
                   n_kv_heads: int = 0) -> Dict:
    """The inverse of :func:`params_from_flax`: the port's
    ``TransformerLM`` parameters -- or their gradients, as
    ``{name: p.grad}`` -- in the Flax tree layout as numpy arrays (bf16
    read back as float32), so they compare leaf by leaf with the JAX
    package's under Flax names."""
    sd = dict(tensors)
    V, D = sd["embed.weight"].shape
    H = n_heads
    KH = n_kv_heads or H
    Dh = D // H
    out: Dict = {"embed": {"embedding": _np(sd["embed.weight"])}}
    if "pos" in sd:
        out["pos"] = _np(sd["pos"])
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        pre = f"blocks.{i}"
        b = {"ln1": _ln_back(sd, f"{pre}.ln1"),
             "ln2": _ln_back(sd, f"{pre}.ln2")}
        if f"{pre}.qkv.weight" in sd:
            b["qkv"] = _dense_back(sd, f"{pre}.qkv", (3, H, Dh))
        else:
            b["q"] = _dense_back(sd, f"{pre}.q", (H, Dh))
            b["kv"] = _dense_back(sd, f"{pre}.kv", (2, KH, Dh))
        pw = _np(sd[f"{pre}.proj.weight"])  # (D, H*Dh)
        b["proj"] = {"kernel": pw.T.reshape(H, Dh, D),
                     "bias": _np(sd[f"{pre}.proj.bias"])}
        if f"{pre}.router" in sd:
            b.update({n: _np(sd[f"{pre}.{n}"]) for n in MOE_PARAMS})
        else:
            F_ = sd[f"{pre}.ff1.weight"].shape[0]
            b["ff1"] = _dense_back(sd, f"{pre}.ff1", (F_,))
            b["ff2"] = _dense_back(sd, f"{pre}.ff2", (D,))
        out[f"block_{i}"] = b
        i += 1
    out["ln_f"] = _ln_back(sd, "ln_f")
    out["lm_head"] = _dense_back(sd, "lm_head", (V,))
    return out


# ------------------------------------------------------------------ ResNet
# Flax module names -> the port's: a block ``BottleneckBlock_i`` or
# ``BasicBlock_i`` is ``blocks.i``; inside it ``Conv_j`` is ``conv{j}`` and
# ``MultiNodeBatchNormalization_j`` is ``bn{j}``; every other name (``fc1``,
# ``fc3``, ``proj_f``, ``proj``, ``proj_bn``, ``conv_init``,
# ``conv_init_s2d``, ``bn_init``, ``head``) is the same.  Leaves: a 4-D conv
# ``kernel`` (HWIO) is ``weight`` (OIHW); the ``head`` Dense ``kernel`` (in,
# out) is ``weight`` (out, in); a ``FusedConv1x1`` ``kernel`` (Cin, Cout)
# and every ``scale``/``bias`` keep name and layout; ``batch_stats``
# ``mean``/``var`` are buffers of the same names.
_BLOCKS = ("BottleneckBlock_", "BasicBlock_")


def _port_module(name: str) -> str:
    for pre in _BLOCKS:
        if name.startswith(pre):
            return f"blocks.{name[len(pre):]}"
    if name.startswith("Conv_"):
        return f"conv{name[5:]}"
    if name.startswith("MultiNodeBatchNormalization_"):
        return f"bn{name[len('MultiNodeBatchNormalization_'):]}"
    return name


def _flax_module(name: str) -> str:
    if name.startswith("conv") and name[4:].isdigit():
        return f"Conv_{name[4:]}"
    if name.startswith("bn") and name[2:].isdigit():
        return f"MultiNodeBatchNormalization_{name[2:]}"
    return name


def _walk(tree: Dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def resnet_params_from_flax(params: Dict, batch_stats: Dict = None,
                            device=None) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet`` ``state_dict`` from the JAX package's
    ``ResNet`` variables as numpy trees (``params`` and, for the BN
    buffers, ``batch_stats``).  ``device`` None means the current CUDA
    device (raises where there is none).  Load it with
    ``model.load_state_dict(...)``."""
    dev = resolve_device(device, "resnet_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _walk(tree):
            mods, leaf_name = path[:-1], path[-1]
            key = ".".join(_port_module(m) for m in mods)
            arr = np.asarray(leaf)
            if leaf_name == "kernel" and arr.ndim == 4:
                out[f"{key}.weight"] = _tensor(arr.transpose(3, 2, 0, 1), dev)
            elif leaf_name == "kernel" and mods[-1] == "head":
                out[f"{key}.weight"] = _tensor(arr.T, dev)
            else:
                out[f"{key}.{leaf_name}"] = _tensor(arr, dev)
    return out


def resnet_params_to_flax(tensors: Dict[str, torch.Tensor]):
    """The inverse of :func:`resnet_params_from_flax`: the port's
    ``ResNet`` tensors (parameters, buffers, or gradients as ``{name:
    p.grad}``) as ``(params, batch_stats)`` Flax trees of numpy arrays
    (bf16 read back as float32); BN buffers (``mean``, ``var``) go to
    ``batch_stats``, everything else to ``params``."""
    def has(*names):
        return any(f".{n}." in k for k in tensors for n in names)

    # Only the basic block has a second module and never a third.
    basic = has("conv1", "bn1") and not has("conv2", "bn2", "fc1")
    block = "BasicBlock_" if basic else "BottleneckBlock_"
    params: Dict = {}
    stats: Dict = {}
    for key, t in tensors.items():
        parts = key.split(".")
        leaf = parts[-1]
        mods, i = [], 0
        while i < len(parts) - 1:
            if parts[i] == "blocks":
                mods.append(f"{block}{parts[i + 1]}")
                i += 2
            else:
                mods.append(_flax_module(parts[i]))
                i += 1
        arr = _np(t)
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight":  # the head
            leaf, arr = "kernel", arr.T
        node = stats if leaf in ("mean", "var") else params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return params, stats


def mlp_params_from_flax(params: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``MLP`` ``state_dict`` from the JAX package's ``MLP``
    parameters (numpy trees): ``Dense_i.kernel (in, out)`` ->
    ``layers.i.weight (out, in)``, ``Dense_i.bias`` -> ``layers.i.bias``.
    ``device`` None means the current CUDA device (raises where there is
    none)."""
    dev = resolve_device(device, "mlp_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        i = int(name.split("_")[-1])
        out[f"layers.{i}.weight"] = _tensor(np.asarray(p["kernel"]).T, dev)
        out[f"layers.{i}.bias"] = _tensor(p["bias"], dev)
    return out


def mlp_params_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`mlp_params_from_flax`, for parameters or
    gradients (``{name: p.grad}``)."""
    out: Dict = {}
    for key, t in tensors.items():
        _, i, leaf = key.split(".")
        arr = _np(t)
        node = out.setdefault(f"Dense_{i}", {})
        if leaf == "weight":
            node["kernel"] = arr.T
        else:
            node["bias"] = arr
    return out
