"""Model-parallel MNIST: the port's twin of
``examples/mnist/train_mnist_model_parallel.py`` (the reference's
``examples/mnist/train_mnist_model_parallel.py``).

An MLP cut over two model ranks (stage 0: 784 -> 256, ReLU; stage 1:
256 -> 256, ReLU -> 10) stitched by a ``MultiNodeChainList``, on a ``data
x model`` rank grid of ``N/2 x 2``; the chain's output is broadcast from
model rank 1 (``F.bcast``), every model rank computes the loss, and
``model_parallel_grad_reduce`` gives the one-process update (SGD with
momentum 0.9).  Data: the JAX example's ``make_synthetic_classification(
8192, 784, 10, seed=1)``, scattered over the data ranks.  Runs::

    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.train_mnist_model_parallel --device cpu
    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.train_mnist_model_parallel --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.train_mnist_model_parallel

The world size must be even.  On cards each rank takes
``cuda:LOCAL_RANK``; with ``--communicator naive --device cuda:0`` every
rank runs on ``cuda:0`` over gloo.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batchsize", type=int, default=256)
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card), one device for every "
                   "rank (e.g. 'cuda:0'), or 'cpu'")
    p.add_argument("--iters-per-epoch", type=int, default=None,
                   help="cut each epoch to this many steps")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Returns the trainer (its ``LogReport`` first among its
    extensions)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as TF

    from chainermn_tpu_torch import functions as F
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.datasets import (
        make_synthetic_classification,
        scatter_dataset,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.links import MultiNodeChainList
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )
    from chainermn_tpu_torch.training import LogReport, Trainer

    args = parse_args(argv)
    dev = None if args.device == "cuda" else args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % 2:
        raise SystemExit(f"{world} ranks: the chain needs an even world")
    comm = create_communicator(args.communicator, device=dev,
                               mesh=hybrid_mesh({"data": world // 2,
                                                 "model": 2}))
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    dev = comm.device
    torch.manual_seed(0)
    chain = MultiNodeChainList(mcomm)
    chain.add_link(lambda: nn.Sequential(nn.Flatten(), nn.Linear(784, 256),
                                         nn.ReLU()).to(dev),
                   rank=0, rank_out=1)
    chain.add_link(lambda: nn.Sequential(nn.Linear(256, 256), nn.ReLU(),
                                         nn.Linear(256, 10)).to(dev),
                   rank=1, rank_in=0)

    def loss_fn(model, batch):
        x, y = batch
        x = torch.as_tensor(x, device=dev, dtype=torch.float32)
        y = torch.as_tensor(y, device=dev).long()
        # The output lives on model rank 1.
        logits = F.bcast(mcomm, model(x), root=1)
        loss = TF.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"accuracy": acc.detach()}

    # Stage gradients are each owner's alone: model_parallel_grad_reduce
    # restores the one-process update, then averages over the data ranks.
    opt = create_multi_node_optimizer(
        sgd(args.lr, momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init(chain)
    train = scatter_dataset(
        make_synthetic_classification(8192, 784, 10, seed=1), dcomm,
        shuffle=True, seed=42)
    it = SerialIterator(train, max(args.batchsize // dcomm.size, 1),
                        shuffle=True, seed=0)
    stop = (args.epoch, "epoch") if args.iters_per_epoch is None else \
        (args.epoch * args.iters_per_epoch, "iteration")
    trainer = Trainer(opt, state, loss_fn, it, stop=stop, has_aux=True)
    trainer.extend(LogReport(
        trigger=(1, "epoch") if args.iters_per_epoch is None
        else (args.iters_per_epoch, "iteration"),
        print_report=comm.rank == 0))
    if comm.rank == 0:
        print(f"mesh: data={dcomm.size} × model={mcomm.size}", flush=True)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
