"""The tensor-parallel cut of the serving engine: the port of
``chainermn_tpu/serving/sharding.py``.

The JAX package lays the model's parameters and the paged KV pools out
over a 1-D ``Mesh(("model",))`` and lets GSPMD insert the two
reductions tensor parallelism needs.  Here each model rank is a process
(MPMD): it holds its own slice of every sharded parameter and its own
``KH / M`` heads of every pool, and the model's forward runs the
collectives itself (:class:`~chainermn_tpu_torch.models.TransformerLM`
with ``tp=``).  The cut is the JAX package's, axis for axis (Megatron's):

* **attention** head-major: ``qkv``/``q`` on the query-head axis, ``kv``
  on the KV-head axis, ``proj`` on its contracted head axis (row
  parallel: one all-reduce);
* **FFN / MoE** on the hidden axis: ``ff1`` and ``moe_w1``/``moe_b1``
  column parallel, ``ff2`` and ``moe_w2`` row parallel (the second
  all-reduce);
* **LM head** on the vocab (column parallel): each rank's fp32 logits
  are all-gathered, so every rank argmaxes and samples the same row;
* **KV pools** kv-head-major on axis 0, so a block id means the same
  block on every rank and the host-side books (allocator, prefix trie,
  block tables) are the same on every rank;
* **everything else** (embeddings, LayerNorms, positions, the router,
  the biases of row-parallel layers) replicated.

A leaf whose nominated axis does not divide ``M`` (an odd vocab, a prime
``d_ff``) stays whole, as in the JAX package; only the KV-head axis must
split (:func:`validate_geometry`).

Parameter names are the port's (``blocks.0.qkv.weight``); a torch
``nn.Linear`` weight is ``(out, in)``, the transpose of Flax's kernel, so
the axes below are the torch ones.  A fused projection's output axis
holds several pieces one after another (``qkv``: q, k, v; ``kv``: k, v),
each cut alike: :class:`Cut` records the piece count.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

__all__ = [
    "MODEL_AXIS",
    "Cut",
    "divides",
    "mesh_model_size",
    "param_spec",
    "pool_placement",
    "serving_mesh",
    "shard_leaf",
    "shard_model",
    "shard_params",
    "validate_geometry",
]

#: The serving mesh's axis name, as in the JAX package.
MODEL_AXIS = "model"


class Cut(NamedTuple):
    """One parameter's shard: ``axis`` (torch layout) split in ``M``
    parts within each of its ``pieces`` equal consecutive pieces."""

    axis: int
    pieces: int = 1


def serving_mesh(n_model: int, comm):
    """The communicator over this rank's ``n_model`` model ranks: ``comm``
    itself when it has ``n_model`` ranks, else the group of consecutive
    ranks ``[k * n_model, (k + 1) * n_model)`` holding this rank (a job
    of several tensor-parallel replicas).  Every rank of ``comm`` calls it
    together (the groups are made on every rank)."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if comm is None:
        raise ValueError(
            "serving_mesh needs the communicator over the job's ranks "
            "(create_communicator(...)): one process drives one model "
            "rank")
    if comm.size == n_model:
        return comm
    if comm.size % n_model:
        raise ValueError(
            f"serving_mesh(n_model={n_model}) needs a multiple of "
            f"{n_model} ranks, the communicator has {comm.size}")
    colors = [r // n_model for r in range(comm.size)]
    return comm.split(colors)[comm.rank // n_model]


def mesh_model_size(mesh) -> int:
    """The number of model ranks (1 = unsharded)."""
    return 1 if mesh is None else int(mesh.size)


def validate_geometry(model, mesh) -> None:
    """Fail fast when ``model``'s KV heads cannot split over the model
    ranks: the pools shard kv-head-major and the decode kernels need a
    whole number of local KV heads (with grouped queries ``H = KH ·
    groups``, so the query heads divide whenever the KV heads do)."""
    n = mesh_model_size(mesh)
    if n == 1:
        return
    kvh = model.n_kv_heads or model.n_heads
    if kvh % n:
        raise ValueError(
            f"model kv heads ({kvh}, the pools' shard axis 0) are not "
            f"divisible by the mesh's '{MODEL_AXIS}' axis ({n}) — the "
            "paged pools shard kv-head-major and the per-shard decode "
            "kernels need whole local KV heads, so KH is the one axis "
            "that must split")


def param_spec(name: str, leaf: Optional[torch.Tensor] = None
               ) -> Optional[Cut]:
    """The :class:`Cut` of one parameter by its port name, or None for a
    replicated one (the JAX ``param_spec`` table on torch layouts)."""
    parts = name.split(".")
    leafname = parts[-1]
    layer = parts[-2] if len(parts) >= 2 else ""
    if leafname == "weight":
        if layer == "qkv":       # (3·H·Dh, D): Flax (D, 3, H, Dh) on H
            return Cut(0, 3)
        if layer == "q":         # (H·Dh, D)
            return Cut(0)
        if layer == "kv":        # (2·KH·Dh, D): Flax (D, 2, KH, Dh) on KH
            return Cut(0, 2)
        if layer == "proj":      # (D, H·Dh): row parallel
            return Cut(1)
        if layer == "ff1":       # (F, D): column parallel
            return Cut(0)
        if layer == "ff2":       # (D, F): row parallel
            return Cut(1)
        if layer == "lm_head":   # (V, D): vocab-sharded head
            return Cut(0)
    elif leafname == "bias":
        if layer == "qkv":
            return Cut(0, 3)
        if layer in ("q", "ff1", "lm_head"):
            return Cut(0)
        if layer == "kv":
            return Cut(0, 2)
        # proj / ff2 biases join once, after the reduction: replicated.
    elif leafname == "moe_w1":   # (E, D, F): per-expert column cut
        return Cut(2)
    elif leafname == "moe_b1":   # (E, F)
        return Cut(1)
    elif leafname == "moe_w2":   # (E, F, D): per-expert row cut
        return Cut(1)
    return None


def divides(cut: Optional[Cut], shape, n: int) -> bool:
    """Whether ``cut`` splits a leaf of ``shape`` over ``n`` ranks."""
    if cut is None or n == 1:
        return False
    size = shape[cut.axis]
    return size % cut.pieces == 0 and (size // cut.pieces) % n == 0


def shard_leaf(t: torch.Tensor, cut: Optional[Cut], rank: int, n: int
               ) -> torch.Tensor:
    """Rank ``rank``'s part of ``t`` under ``cut`` over ``n`` ranks (a
    new tensor); the whole of ``t`` when the leaf is replicated or its
    axis does not divide."""
    if not divides(cut, t.shape, n):
        return t.detach().clone()
    shape = list(t.shape)
    ax, k = cut.axis, cut.pieces
    piece = shape[ax] // k
    w = piece // n
    view = t.detach().reshape(shape[:ax] + [k, piece] + shape[ax + 1:])
    part = view.narrow(ax + 1, rank * w, w)
    return part.reshape(shape[:ax] + [k * w] + shape[ax + 1:]).clone()


def shard_params(state: Dict[str, torch.Tensor], mesh,
                 rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter of ``state`` (a model's
    ``state_dict`` of the full model) under :func:`param_spec` — the
    layout step a tensor-parallel engine pays at construction.  A leaf
    whose axis does not divide the model ranks stays whole.  ``rank``
    defaults to this process's rank in ``mesh``."""
    n = mesh_model_size(mesh)
    r = (mesh.rank if mesh is not None else 0) if rank is None else rank
    return {name: shard_leaf(t, param_spec(name, t), r, n)
            for name, t in state.items()}


def pool_placement(mesh, rank: Optional[int] = None) -> Callable:
    """``place(arr)``: this rank's part of one full pool entry — its
    ``KH / M`` heads (axis 0) of a ``(KH, num_blocks, block_len[, Dh])``
    pool or scale plane; anything smaller stays whole, as the JAX
    placement replicates it.  The engine allocates its pools at the local
    shape directly (``PagedKVPool`` of the rank's model)."""
    n = mesh_model_size(mesh)
    r = (mesh.rank if mesh is not None else 0) if rank is None else rank

    def place(arr: torch.Tensor) -> torch.Tensor:
        if arr.dim() < 3 or n == 1:
            return arr
        h = arr.shape[0] // n
        return arr[r * h:(r + 1) * h]

    return place



def shard_model(model, mesh):
    """This rank's tensor-parallel part of ``model`` (the full
    :class:`~chainermn_tpu_torch.models.TransformerLM`, the same weights
    on every model rank): a model built with ``tp=mesh`` on ``model``'s
    device, holding :func:`shard_params` of ``model``'s weights.  With one
    model rank it is the whole model, its two all-reduces and gather of
    one rank each in the forward."""
    from chainermn_tpu_torch.models.transformer import TransformerLM

    validate_geometry(model, mesh)
    local = TransformerLM(**model.config(), device=model.device, tp=mesh)
    local.load_state_dict(shard_params(model.state_dict(), mesh))
    return local
