"""Channel-parallel convnet: the port of
``chainermn_tpu/models/parallel_convnet.py`` (the reference's
parallel-convnet example).

Each model rank owns ``Cout / M`` of every conv layer's filters; after
each layer the ranks re-assemble the channel axis with the
differentiable all-gather (:func:`chainermn_tpu_torch.functions.
allgather`), whose backward is the reduce-scatter that hands each rank
its filter shard's gradient.  The dense head is computed alike on every
rank and its gradients are averaged over the model ranks.  The batch is
the same on every rank (channel parallelism splits filters, not
samples).

Layouts: activations NCHW (the channel axis is 1; the JAX package's
NHWC axis 3), kernels OIHW ``(Cout/M, Cin, 3, 3)`` (the bridge turns the
JAX ``(3, 3, Cin, Cout/M)`` HWIO kernels around,
:func:`~chainermn_tpu_torch.utils.channel_parallel_params_from_flax`).
The parameter tree is the JAX one's: ``{"convs": [(k, b), ...], "head":
{"w": (F, n_classes), "b": (n_classes,)}}``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from chainermn_tpu_torch import functions as MF
from chainermn_tpu_torch.utils.device import resolve_device

__all__ = ["channel_parallel_apply", "channel_parallel_leaves",
           "channel_parallel_loss", "channel_parallel_specs",
           "dense_reference_apply", "init_channel_parallel",
           "make_channel_parallel_train_step", "shard_channel_parallel"]


def init_channel_parallel(widths: Sequence[int], num_classes: int,
                          in_ch: int = 3, seed: int = 0, device=None,
                          dtype=torch.float32) -> Dict[str, Any]:
    """The full (unsharded) parameter tree: conv ``i``'s ``widths[i]``
    filters normal with std ``1/sqrt(9·Cin)``, zero biases, a normal head
    with std ``1/sqrt(F)``, from ``seed``."""
    dev = resolve_device(device, "init_channel_parallel")
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    convs, c = [], in_ch
    for w in widths:
        k = torch.randn((w, c, 3, 3), generator=g, device=dev,
                        dtype=dtype) / math.sqrt(9 * c)
        convs.append((k, torch.zeros(w, device=dev, dtype=dtype)))
        c = w
    head = {"w": torch.randn((c, num_classes), generator=g, device=dev,
                             dtype=dtype) / math.sqrt(c),
            "b": torch.zeros(num_classes, device=dev, dtype=dtype)}
    return {"convs": convs, "head": head}


def channel_parallel_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The axis each leaf is sharded on over the model ranks: a conv
    kernel and bias on their output channels (axis 0), the head
    replicated (None) — the JAX ``PartitionSpec`` table on torch
    layouts."""
    return {"convs": [(0, 0) for _ in params["convs"]],
            "head": {"w": None, "b": None}}


def shard_channel_parallel(params: Dict[str, Any], rank: int, n: int,
                           requires_grad: bool = True) -> Dict[str, Any]:
    """Rank ``rank``'s shards (of ``n``) of the full tree, as leaf
    tensors; a width that does not divide ``n`` raises."""
    def take(t, axis):
        t = t.detach()
        if axis is not None:
            if t.shape[axis] % n:
                raise ValueError(
                    f"conv width {t.shape[axis]} is not divisible by the "
                    f"{n} model ranks: each rank owns Cout/M filters")
            w = t.shape[axis] // n
            t = t.narrow(axis, rank * w, w)
        return t.clone().requires_grad_(requires_grad)

    specs = channel_parallel_specs(params)
    return {"convs": [(take(k, sk), take(b, sb)) for (k, b), (sk, sb)
                      in zip(params["convs"], specs["convs"])],
            "head": {"w": take(params["head"]["w"], None),
                     "b": take(params["head"]["b"], None)}}


def channel_parallel_leaves(params: Dict[str, Any]):
    """The tree's leaves in a fixed order (convs, then the head)."""
    out = [t for k, b in params["convs"] for t in (k, b)]
    return out + [params["head"]["w"], params["head"]["b"]]


def channel_parallel_apply(params: Dict[str, Any], x: torch.Tensor,
                           comm=None) -> torch.Tensor:
    """The forward: per layer the local conv, then (with ``comm``, the
    communicator over the model ranks) the all-gather of every rank's
    filter shard on the channel axis; ReLU, a 2x2 max-pool after every
    second layer, a global average pool and the head.  ``comm=None`` on
    the full kernels is the one-process oracle: one body for both.
    ``x``: ``(B, Cin, H, W)``, the same on every rank."""
    for i, (k, b) in enumerate(params["convs"]):
        y = F.conv2d(x, k, b, padding=1)
        if comm is not None:
            g = MF.allgather(comm, y)  # (M, B, C/M, H, W)
            y = g.transpose(0, 1).reshape(y.shape[0], -1, *y.shape[2:])
        x = F.relu(y)
        if i % 2 == 1:
            x = F.max_pool2d(x, 2, 2)
    feats = x.mean(dim=(2, 3))
    return feats @ params["head"]["w"] + params["head"]["b"]


def dense_reference_apply(params: Dict[str, Any], x: torch.Tensor
                          ) -> torch.Tensor:
    """The one-process oracle: the same body on the full kernels."""
    return channel_parallel_apply(params, x, comm=None)


def channel_parallel_loss(comm=None) -> Callable:
    """``loss_fn(params, (x, y))``: the mean softmax cross-entropy of the
    fp32 logits, the same on every model rank."""

    def loss_fn(params, batch):
        x, y = batch
        logits = channel_parallel_apply(params, x, comm)
        return F.cross_entropy(logits.float(), y.long())

    return loss_fn


def make_channel_parallel_train_step(comm) -> Callable:
    """The step of channel-parallel training on this rank:
    ``step((params, optimizer), batch) -> ((params, optimizer), loss)``
    with ``params`` this rank's shards (:func:`shard_channel_parallel`)
    and ``optimizer`` a torch optimizer over
    :func:`channel_parallel_leaves` of them.

    Every rank computes the same loss on the same batch, so the
    all-gather's backward hands each conv shard the sum of ``M`` equal
    copies of its gradient: it is divided by ``M``.  The head's gradients
    never cross the gather (each rank holds one equal copy) and are
    averaged over the model ranks.  Runs eagerly (the JAX package jits
    the same body under ``shard_map``)."""
    n = comm.size
    loss_fn = channel_parallel_loss(comm)

    def step(carry, batch):
        params, opt = carry
        dev = params["head"]["w"].device
        x, y = (torch.as_tensor(t, device=dev) for t in batch)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, (x, y))
        loss.backward()
        with torch.no_grad():
            for k, b in params["convs"]:
                k.grad.div_(n)
                b.grad.div_(n)
            for t in params["head"].values():
                t.grad.copy_(comm.allreduce(t.grad, op="mean"))
        opt.step()
        return (params, opt), comm.allreduce(loss.detach(), op="mean")

    return step
