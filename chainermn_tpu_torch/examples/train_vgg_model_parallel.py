"""Model-parallel VGG: the port's twin of
``examples/vgg/train_vgg_model_parallel.py`` (BASELINE.json configuration
4, "model-parallel VGG via MultiNodeChainList").

A VGG-11 is cut into ``--stages`` contiguous stages (the last one the
classifier head), one per rank of the ``model`` axis of a ``data ×
model`` rank grid, stitched by a ``MultiNodeChainList``; the ranks of one
model line see the same batches, and the data lines split the dataset.
The chain's output is broadcast from the last stage (``F.bcast``), every
model rank computes the loss, and ``model_parallel_grad_reduce`` turns
the per-stage gradients into the update the one-process model would take
(SGD with momentum, the JAX example's ``optax.sgd(lr, momentum=0.9)``).
Data: the JAX example's synthetic CIFAR-shaped task from
``RandomState(0)`` (each class a low-frequency 8×8 template upsampled to
32×32, mixed into noise), 2048 examples.  Runs::

    python -m chainermn_tpu_torch.launch --nproc 4 -m chainermn_tpu_torch.examples.train_vgg_model_parallel --device cpu
    python -m chainermn_tpu_torch.launch --nproc 4 -m chainermn_tpu_torch.examples.train_vgg_model_parallel --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.train_vgg_model_parallel

The world size must be a multiple of ``--stages``.  On cards, each rank
takes ``cuda:LOCAL_RANK`` (NCCL needs one card per rank); with
``--communicator naive --device cuda:0`` every rank runs on ``cuda:0``
over gloo.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batchsize", type=int, default=64,
                   help="global batch size")
    p.add_argument("--epoch", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--stages", type=int, default=4)
    p.add_argument("--width-mult", type=float, default=0.25)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card), one device for every "
                   "rank (e.g. 'cuda:0'), or 'cpu'")
    p.add_argument("--iters-per-epoch", type=int, default=None,
                   help="cut each epoch to this many steps")
    return p.parse_args(argv)


def synthetic_cifar(classes: int, n: int = 2048, seed: int = 0):
    """The JAX example's data: ``(x, y)``, NHWC float32 32×32×3 and int32
    labels, from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    templates = rng.normal(size=(classes, 8, 8, 3)).astype(np.float32)
    templates = np.kron(templates, np.ones((1, 4, 4, 1), np.float32))
    y = rng.randint(0, classes, size=n).astype(np.int32)
    x = 0.6 * templates[y] + rng.normal(size=(n, 32, 32, 3)).astype(
        np.float32)
    return x, y


def build(args):
    """``(comm, dcomm, mcomm, chain, optimizer, state, loss_fn,
    iterator)``, ready to train."""
    import torch

    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.datasets import ArrayDataset, scatter_dataset
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        build_chain,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )

    dev = None if args.device == "cuda" else args.device
    S = args.stages
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % S:
        raise SystemExit(f"{world} ranks is not a multiple of --stages {S}")
    comm = create_communicator(
        args.communicator, device=dev,
        mesh=hybrid_mesh({"data": world // S, "model": S}))
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    modules = vgg_stage_modules("vgg11", num_classes=args.classes,
                                n_stages=S, width_mult=args.width_mult,
                                device=comm.device, seed=0,
                                stages=[mcomm.rank])
    chain = build_chain(modules, mcomm)

    x_all, y_all = synthetic_cifar(args.classes)

    def loss_fn(model, batch):
        x, y = batch
        x = torch.as_tensor(x, device=comm.device)
        logits = F.bcast(mcomm, model(x), root=S - 1)
        loss, acc = vgg_loss(logits, y)
        return loss, {"accuracy": acc}

    opt = create_multi_node_optimizer(
        sgd(args.lr, momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init(chain)
    # The ranks of one model line take the same shard and the same order.
    train = scatter_dataset(ArrayDataset(x_all, y_all), dcomm, shuffle=True,
                            seed=42)
    it = SerialIterator(train, max(args.batchsize // dcomm.size, 1),
                        shuffle=True, seed=0)
    return comm, dcomm, mcomm, chain, opt, state, loss_fn, it


def main(argv: Optional[Sequence[str]] = None):
    """Returns the trainer (its ``LogReport`` first among its
    extensions)."""
    from chainermn_tpu_torch.training import LogReport, Trainer

    args = parse_args(argv)
    comm, dcomm, mcomm, chain, opt, state, loss_fn, it = build(args)
    stop = (args.epoch, "epoch") if args.iters_per_epoch is None else \
        (args.epoch * args.iters_per_epoch, "iteration")
    trainer = Trainer(opt, state, loss_fn, it, stop=stop, has_aux=True)
    trainer.extend(LogReport(
        trigger=(1, "epoch") if args.iters_per_epoch is None
        else (args.iters_per_epoch, "iteration"),
        print_report=comm.rank == 0))
    if comm.rank == 0:
        print(f"grid: data={dcomm.size} × model={mcomm.size}  "
              f"(VGG-11/{args.width_mult}x, {comm.device})", flush=True)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
