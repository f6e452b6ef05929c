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

Biases flatten the same way as their kernels' output axes.  The ResNet,
MLP, seq2seq, ViT and LoRA mappings are described beside their functions
below (VGG's stages at :func:`vgg_stage_params_from_flax`).
:func:`flax_shapes` reads a model's Flax shapes off its ``*_to_flax``
mapping, for the optimizers that follow the JAX layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

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


def _dense(out: Dict, name: str, p: Dict, device, in_axes: int = 1) -> None:
    """A Flax ``Dense``/``DenseGeneral`` whose kernel contracts its first
    ``in_axes`` axes: kernel ``(*in_axes, *out_axes)`` -> weight
    ``(prod(out_axes), prod(in_axes))``."""
    k = np.asarray(p["kernel"])
    n_in = int(np.prod(k.shape[:in_axes]))
    out[f"{name}.weight"] = _tensor(k.reshape(n_in, -1).T, device)
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


def _dense_back(sd, name: str, out_axes, in_axes=None) -> Dict:
    w = _np(sd[f"{name}.weight"])
    ins = (w.shape[1],) if in_axes is None else tuple(in_axes)
    return {"kernel": w.T.reshape(*ins, *out_axes),
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


# --------------------------------------------------------------- seq2seq
# TransformerSeq2Seq: ``enc_i`` -> ``enc.i`` (``ln1``, ``qkv`` (D, 3, H,
# Dh), ``proj`` (H, Dh, D), ``ln2``, ``ff1``, ``ff2``), ``dec_i`` -> ``dec.i``
# (``ln1``, ``qkv``, ``self_proj`` (H, Dh, D), ``ln2``, ``cross_q`` (D, H,
# Dh), ``cross_kv`` (D, 2, H, Dh), ``cross_proj`` (H, Dh, D), ``ln3``,
# ``ff1``, ``ff2``); ``embed_src``/``embed_tgt`` ``.embedding`` ->
# ``.weight``; ``pos``, ``ln_enc``, ``ln_dec`` and the head ``proj`` (D, V)
# keep their names.  Kernels contracting ``(H, Dh)`` flatten it as the
# port's ``(D, H·Dh)`` weight; output axes flatten as for the LM.
_S2S_ENC = (("ln1", None), ("qkv", 1), ("proj", 2), ("ln2", None),
            ("ff1", 1), ("ff2", 1))
_S2S_DEC = (("ln1", None), ("qkv", 1), ("self_proj", 2), ("ln2", None),
            ("cross_q", 1), ("cross_kv", 1), ("cross_proj", 2),
            ("ln3", None), ("ff1", 1), ("ff2", 1))


def _block_from(out, pre, b, layout, dev) -> None:
    for name, in_axes in layout:
        if in_axes is None:
            _ln(out, f"{pre}.{name}", b[name], dev)
        else:
            _dense(out, f"{pre}.{name}", b[name], dev, in_axes)


def seq2seq_params_from_flax(params: Dict, device=None
                             ) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerSeq2Seq`` ``state_dict`` from the JAX
    package's parameter tree (numpy leaves).  ``device`` None means the
    current CUDA device (raises where there is none)."""
    dev = resolve_device(device, "seq2seq_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for side in ("src", "tgt"):
        out[f"embed_{side}.weight"] = _tensor(
            params[f"embed_{side}"]["embedding"], dev)
    out["pos"] = _tensor(params["pos"], dev)
    for kind, layout in (("enc", _S2S_ENC), ("dec", _S2S_DEC)):
        i = 0
        while f"{kind}_{i}" in params:
            _block_from(out, f"{kind}.{i}", params[f"{kind}_{i}"], layout,
                        dev)
            i += 1
    _ln(out, "ln_enc", params["ln_enc"], dev)
    _ln(out, "ln_dec", params["ln_dec"], dev)
    _dense(out, "proj", params["proj"], dev)
    return out


def seq2seq_params_to_flax(tensors: Dict[str, torch.Tensor],
                           n_heads: int) -> Dict:
    """The inverse of :func:`seq2seq_params_from_flax`, for parameters or
    gradients (``{name: p.grad}``), as numpy Flax trees."""
    sd = dict(tensors)
    D = sd["pos"].shape[1]
    H = n_heads
    Dh = D // H
    axes = {"qkv": ((3, H, Dh), None), "proj": ((D,), (H, Dh)),
            "self_proj": ((D,), (H, Dh)), "cross_proj": ((D,), (H, Dh)),
            "cross_q": ((H, Dh), None), "cross_kv": ((2, H, Dh), None)}
    out: Dict = {f"embed_{s}": {"embedding": _np(sd[f"embed_{s}.weight"])}
                 for s in ("src", "tgt")}
    out["pos"] = _np(sd["pos"])
    for kind, layout in (("enc", _S2S_ENC), ("dec", _S2S_DEC)):
        i = 0
        while f"{kind}.{i}.ln1.weight" in sd:
            pre, b = f"{kind}.{i}", {}
            for name, in_axes in layout:
                if in_axes is None:
                    b[name] = _ln_back(sd, f"{pre}.{name}")
                    continue
                outs, ins = axes.get(
                    name, ((sd[f"{pre}.{name}.weight"].shape[0],), None))
                b[name] = _dense_back(sd, f"{pre}.{name}", outs, ins)
            out[f"{kind}_{i}"] = b
            i += 1
    out["ln_enc"] = _ln_back(sd, "ln_enc")
    out["ln_dec"] = _ln_back(sd, "ln_dec")
    out["proj"] = _dense_back(sd, "proj", (sd["proj.weight"].shape[0],))
    return out


# The LSTM Seq2Seq: Flax's ``OptimizedLSTMCell_0`` (the encoder) and
# ``OptimizedLSTMCell_1`` (the decoder) keep one kernel per gate, input
# kernels ``ii``/``if``/``ig``/``io`` (E, H) without bias and recurrent
# ``hi``/``hf``/``hg``/``ho`` (H, H) with bias; the port's ``_LSTM`` stacks
# them in the gate order i, f, g, o: ``weight_ih`` (4H, E), ``weight_hh``
# (4H, H), ``bias`` (4H,).  ``embed_*`` and ``proj`` as above.
_GATES = ("i", "f", "g", "o")
_CELLS = (("OptimizedLSTMCell_0", "encoder"),
          ("OptimizedLSTMCell_1", "decoder"))


def lstm_seq2seq_params_from_flax(params: Dict, device=None
                                  ) -> Dict[str, torch.Tensor]:
    """The port's LSTM ``Seq2Seq`` ``state_dict`` from the JAX package's
    ``Seq2Seq`` parameters (numpy trees)."""
    dev = resolve_device(device, "lstm_seq2seq_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for side in ("src", "tgt"):
        out[f"embed_{side}.weight"] = _tensor(
            params[f"embed_{side}"]["embedding"], dev)
    for flax_name, port in _CELLS:
        c = params[flax_name]
        out[f"{port}.weight_ih"] = _tensor(np.concatenate(
            [np.asarray(c[f"i{g}"]["kernel"]) for g in _GATES], 1).T, dev)
        out[f"{port}.weight_hh"] = _tensor(np.concatenate(
            [np.asarray(c[f"h{g}"]["kernel"]) for g in _GATES], 1).T, dev)
        out[f"{port}.bias"] = _tensor(np.concatenate(
            [np.asarray(c[f"h{g}"]["bias"]) for g in _GATES]), dev)
    _dense(out, "proj", params["proj"], dev)
    return out


def lstm_seq2seq_params_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`lstm_seq2seq_params_from_flax`, for
    parameters or gradients."""
    sd = dict(tensors)
    out: Dict = {f"embed_{s}": {"embedding": _np(sd[f"embed_{s}.weight"])}
                 for s in ("src", "tgt")}
    for flax_name, port in _CELLS:
        wi = np.split(_np(sd[f"{port}.weight_ih"]).T, 4, axis=1)
        wh = np.split(_np(sd[f"{port}.weight_hh"]).T, 4, axis=1)
        bh = np.split(_np(sd[f"{port}.bias"]), 4)
        cell = {}
        for k, g in enumerate(_GATES):
            cell[f"i{g}"] = {"kernel": wi[k]}
            cell[f"h{g}"] = {"kernel": wh[k], "bias": bh[k]}
        out[flax_name] = cell
    out["proj"] = _dense_back(sd, "proj", (sd["proj.weight"].shape[0],))
    return out


# ------------------------------------------------------------------- ViT
# ``patch_embed.kernel`` (p, p, C, D) HWIO -> ``patch_embed.weight`` (D, C,
# p, p); ``pos_embed`` (1, T, D) as it is; ``block{i}`` -> ``blocks.i``
# with the encoder block's layout above; ``ln_f``; ``head.kernel`` (D, K)
# -> ``head.weight`` (K, D).
def vit_params_from_flax(params: Dict, device=None
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``ViT`` ``state_dict`` from the JAX package's ``ViT``
    parameters (numpy trees)."""
    dev = resolve_device(device, "vit_params_from_flax")
    pk = np.asarray(params["patch_embed"]["kernel"])
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": _tensor(pk.transpose(3, 2, 0, 1), dev),
        "patch_embed.bias": _tensor(params["patch_embed"]["bias"], dev),
        "pos_embed": _tensor(params["pos_embed"], dev)}
    i = 0
    while f"block{i}" in params:
        _block_from(out, f"blocks.{i}", params[f"block{i}"], _S2S_ENC, dev)
        i += 1
    _ln(out, "ln_f", params["ln_f"], dev)
    _dense(out, "head", params["head"], dev)
    return out


def vit_params_to_flax(tensors: Dict[str, torch.Tensor], n_heads: int
                       ) -> Dict:
    """The inverse of :func:`vit_params_from_flax`, for parameters or
    gradients."""
    sd = dict(tensors)
    D = sd["pos_embed"].shape[-1]
    H = n_heads
    Dh = D // H
    out: Dict = {
        "patch_embed": {
            "kernel": _np(sd["patch_embed.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd["patch_embed.bias"])},
        "pos_embed": _np(sd["pos_embed"])}
    i = 0
    while f"blocks.{i}.ln1.weight" in sd:
        pre = f"blocks.{i}"
        F_ = sd[f"{pre}.ff1.weight"].shape[0]
        out[f"block{i}"] = {
            "ln1": _ln_back(sd, f"{pre}.ln1"),
            "qkv": _dense_back(sd, f"{pre}.qkv", (3, H, Dh)),
            "proj": _dense_back(sd, f"{pre}.proj", (D,), (H, Dh)),
            "ln2": _ln_back(sd, f"{pre}.ln2"),
            "ff1": _dense_back(sd, f"{pre}.ff1", (F_,)),
            "ff2": _dense_back(sd, f"{pre}.ff2", (D,))}
        i += 1
    out["ln_f"] = _ln_back(sd, "ln_f")
    out["head"] = _dense_back(sd, "head", (sd["head.weight"].shape[0],))
    return out


# ------------------------------------------------------------------ LoRA
# The adapter tree: a Flax module path (``block_0/qkv``, ``enc_1/proj``,
# the seq2seq head ``proj``) -> the ``LoRA`` module's ``adapters.<port
# path>`` (``blocks.0.qkv``, ``enc.1.proj``, ``proj``).  ``a`` (d_in,
# rank) and ``b`` (rank, d_out) keep their layouts: ``d_in``/``d_out`` are
# the JAX ``_split_shape`` of the kernel, which are the port's
# ``in_features``/``out_features``, including the ``proj`` kernel's
# ``(heads, head_dim)`` input axes.
_FLAX_BLOCKS = (("block_", "blocks"), ("enc_", "enc"), ("dec_", "dec"))


def _port_lora_path(path) -> str:
    parts = []
    for name in path:
        for pre, port in _FLAX_BLOCKS:
            if name.startswith(pre) and name[len(pre):].isdigit():
                parts += [port, name[len(pre):]]
                break
        else:
            parts.append(name)
    return ".".join(parts)


def lora_params_from_flax(lora: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The port's ``LoRA`` module ``state_dict`` from the JAX package's
    adapter tree (numpy leaves ``{... {"a", "b"}}``)."""
    dev = resolve_device(device, "lora_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(lora):
        key = _port_lora_path(path[:-1])
        out[f"adapters.{key}.{path[-1]}"] = _tensor(leaf, dev)
    return out


def lora_params_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`lora_params_from_flax`, for parameters or
    gradients."""
    out: Dict = {}
    for key, t in tensors.items():
        parts = key.split(".")[1:]  # drop "adapters"
        mods, i = [], 0
        while i < len(parts) - 1:
            if parts[i] in ("blocks", "enc", "dec") and i + 1 < len(parts) - 1:
                pre = "block" if parts[i] == "blocks" else parts[i]
                mods.append(f"{pre}_{parts[i + 1]}")
                i += 2
            else:
                mods.append(parts[i])
                i += 1
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[parts[-1]] = _np(t)
    return out


def vgg_stage_params_from_flax(params: Dict, device=None
                               ) -> Dict[str, torch.Tensor]:
    """One VGG stage's ``state_dict`` from the JAX package's stage
    parameters (numpy trees; a pool-only stage's are empty).  A conv
    stage's ``Conv_i.kernel (3, 3, in, out)`` (HWIO) -> ``convs.i.weight
    (out, in, 3, 3)`` (OIHW); the head's ``Dense_0``/``Dense_1.kernel (in,
    out)`` -> ``fc1``/``fc2.weight (out, in)``; biases as they are.
    ``device`` None means the current CUDA device."""
    dev = resolve_device(device, "vgg_stage_params_from_flax")
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        kind, i = name.rsplit("_", 1)
        k = np.asarray(p["kernel"])
        if kind == "Conv":
            out[f"convs.{i}.weight"] = _tensor(k.transpose(3, 2, 0, 1), dev)
            out[f"convs.{i}.bias"] = _tensor(p["bias"], dev)
        else:
            out[f"fc{int(i) + 1}.weight"] = _tensor(k.T, dev)
            out[f"fc{int(i) + 1}.bias"] = _tensor(p["bias"], dev)
    return out


def vgg_stage_params_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`vgg_stage_params_from_flax`, for a stage's
    parameters or gradients (``{name: p.grad}``)."""
    out: Dict = {}
    for key, t in tensors.items():
        mod, leaf = key.rsplit(".", 1)
        arr = _np(t)
        if mod.startswith("convs."):
            node = out.setdefault(f"Conv_{mod.split('.')[1]}", {})
            if leaf == "weight":
                arr = arr.transpose(2, 3, 1, 0)
        else:
            node = out.setdefault(f"Dense_{int(mod[2:]) - 1}", {})
            if leaf == "weight":
                arr = arr.T
        node["kernel" if leaf == "weight" else "bias"] = arr
    return out


# ------------------------------------------------------- ParallelLM
def _spec_slice(spec, shape, coords, n_model: int):
    """The index of one rank's block of a leaf with ``spec`` (see
    ``parallel_lm_specs``): an int for ``"stage"`` (the axis drops), the
    rank's ``1/n_model`` block for ``"model"``."""
    idx = []
    for dim, ax in enumerate(spec):
        if ax == "stage":
            idx.append(int(coords["stage"]))
        elif ax == "model":
            if shape[dim] % n_model:
                raise ValueError(f"axis {dim} of {tuple(shape)} does not "
                                 f"split over {n_model} model ranks")
            n = shape[dim] // n_model
            m = int(coords["model"])
            idx.append(slice(m * n, (m + 1) * n))
        else:
            idx.append(slice(None))
    return tuple(idx)


def parallel_lm_shard(params: Dict, cfg, coords, device=None
                      ) -> Dict[str, torch.Tensor]:
    """One rank's slice of ``init_parallel_lm``'s tree (numpy), by
    ``parallel_lm_specs``: ``coords`` gives the rank's ``"stage"`` and
    ``"model"`` positions (``ParallelLM.coords``).  Stage leaves lose
    their stage axis; head and expert axes keep this rank's block.
    Returns leaf tensors that require grad, on ``device`` (None: the
    current CUDA device)."""
    from chainermn_tpu_torch.models.transformer import (
        _tree_get,
        _tree_items,
        _tree_set,
        parallel_lm_specs,
    )

    dev = resolve_device(device, "parallel_lm_shard")
    specs = parallel_lm_specs(cfg)
    out: Dict = {}
    for path, spec in _tree_items(specs):
        arr = np.asarray(_tree_get(params, path))
        block = arr[_spec_slice(spec, arr.shape, coords, cfg.n_experts)]
        _tree_set(out, path, _tensor(np.ascontiguousarray(block), dev)
                  .requires_grad_())
    return out


def parallel_lm_unshard(shards, cfg) -> Dict:
    """The full numpy tree from ranks' slices: ``shards`` is a sequence of
    ``(coords, tree)`` (a tree like :func:`parallel_lm_shard`'s, of
    tensors or arrays: parameters or reduced gradients), which together
    cover every ``(stage, model)`` block; a replicated leaf is taken from
    any of them."""
    from chainermn_tpu_torch.models.transformer import (
        _tree_get,
        _tree_items,
        _tree_set,
        parallel_lm_specs,
    )

    specs = parallel_lm_specs(cfg)
    out: Dict = {}
    for path, spec in _tree_items(specs):
        full = None
        for coords, tree in shards:
            block = _tree_get(tree, path)
            block = _np(block) if isinstance(block, torch.Tensor) \
                else np.asarray(block)
            if full is None:
                shape, at = [], 0
                for ax in spec:
                    if ax == "stage":
                        shape.append(cfg.n_stages)
                        continue
                    shape.append(block.shape[at] * (
                        cfg.n_experts if ax == "model" else 1))
                    at += 1
                full = np.zeros(shape or block.shape, block.dtype)
            full[_spec_slice(spec, full.shape, coords, cfg.n_experts)] = \
                block
        _tree_set(out, path, full)
    return out


# ---------------------------------------------------------- Flax shapes
#: a stand-in's row code: parameter ``k``'s row ``r`` holds ``k + r / 2**20``
#: (exact in float64 for up to 2**20 parameters of up to 2**20 rows).
_ROW = 2.0 ** -20


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def flax_shapes(model: torch.nn.Module, to_flax: Callable
                ) -> Dict[torch.nn.Parameter, Tuple[int, ...]]:
    """``{parameter: shape}``: each parameter's shape in the JAX package's
    layout, read off ``to_flax``, the model's mapping into it in this
    module (``functools.partial(params_to_flax, n_heads=H)``,
    ``vit_params_to_flax``, ``resnet_params_to_flax``, ...).

    The mapping runs on stand-ins of the parameters' shapes that allocate
    a row each, not the model: parameter ``k``'s row ``r`` holds ``k + r
    * 2**-20``, broadcast along the other axes.  A leaf's first element
    names its parameter; a parameter that the mapping splits (the LSTM's
    stacked gates) takes its first leaf's shape.  A 2-D weight whose Flax
    kernel has another rank must be that kernel transposed, its axes
    split (``_dense_back``'s rule for an ``nn.Linear``): the optimizers
    view it so, and any other mapping raises."""
    named = list(model.named_parameters())
    stand = {}
    for k, (n, p) in enumerate(named):
        rows = k + _ROW * torch.arange(p.shape[0] if p.dim() else 1,
                                       dtype=torch.float64)
        stand[n] = rows.view(-1, *[1] * (p.dim() - 1)).expand(p.shape) \
            if p.dim() else rows[0]
    out: Dict[torch.nn.Parameter, Tuple[int, ...]] = {}
    for leaf in _leaves(to_flax(stand)):
        leaf = np.asarray(leaf)
        if leaf.size == 0:
            continue
        k = math.floor(float(leaf.flat[0]))
        p = named[k][1]
        if p in out:
            continue
        out[p] = tuple(leaf.shape)
        if p.dim() == 2 and leaf.ndim != 2 and min(p.shape) > 1 \
                and float(leaf.flat[1]) == float(leaf.flat[0]):
            raise ValueError(
                f"{named[k][0]}: the mapping splits the axes of the "
                f"(out, in) weight {tuple(p.shape)} into {leaf.shape} "
                "without transposing it")
    return out
