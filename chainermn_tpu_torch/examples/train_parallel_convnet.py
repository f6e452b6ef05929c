"""Channel-parallel convnet: the port's twin of
``examples/parallel_convnet/train_parallel_convnet.py``.

Every rank owns ``1/M`` of each conv layer's filters; activations
re-assemble through the differentiable all-gather between layers
(:mod:`chainermn_tpu_torch.models.parallel_convnet`).  The batch is the
same on every rank.  Data: the JAX example's synthetic CIFAR-shaped task
(``RandomState(5)``: 10 class prototypes plus noise, 2048 examples), fed
NCHW.  Runs::

    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.train_parallel_convnet --device cpu
    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.train_parallel_convnet --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.train_parallel_convnet
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batchsize", type=int, default=64)
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--widths", default="32,64,128,128")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card), one device for every "
                   "rank (e.g. 'cuda:0'), or 'cpu'")
    return p.parse_args(argv)


def synthetic_task(n_train: int, n_cls: int = 10, seed: int = 5):
    """The JAX example's data: NHWC ``(n, 32, 32, 3)`` float32 and int32
    labels."""
    rng = np.random.RandomState(seed)
    protos = rng.normal(size=(n_cls, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, n_cls, size=(n_train,)).astype(np.int32)
    x = protos[y] + 0.5 * rng.normal(size=(n_train, 32, 32, 3)).astype(
        np.float32)
    return x, y


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Returns the per-epoch mean losses."""
    import torch

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import (
        channel_parallel_leaves,
        init_channel_parallel,
        make_channel_parallel_train_step,
        shard_channel_parallel,
    )
    from chainermn_tpu_torch.optimizers import sgd

    args = parse_args(argv)
    dev = None if args.device == "cuda" else args.device
    comm = create_communicator(args.communicator, device=dev)
    widths = tuple(int(w) for w in args.widths.split(","))
    if any(w % comm.size for w in widths):
        raise SystemExit(f"widths {widths} must divide by the model-axis "
                         f"size {comm.size}")
    if comm.rank == 0:
        print(f"model-axis size: {comm.size}  widths: {widths}", flush=True)
    x, y = synthetic_task(args.n_train)
    x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    full = init_channel_parallel(widths, 10, device=comm.device, seed=0)
    params = shard_channel_parallel(full, comm.rank, comm.size)
    del full
    opt = sgd(args.lr, momentum=0.9)(channel_parallel_leaves(params))
    step = make_channel_parallel_train_step(comm)
    carry = (params, opt)
    steps = args.n_train // args.batchsize
    out = []
    for epoch in range(args.epoch):
        losses = []
        for i in range(steps):
            sl = slice(i * args.batchsize, (i + 1) * args.batchsize)
            carry, loss = step(carry, (torch.from_numpy(x[sl]),
                                       torch.from_numpy(y[sl])))
            losses.append(float(loss))
        out.append(float(np.mean(losses)))
        if comm.rank == 0:
            print(f"epoch {epoch + 1}  loss {out[-1]:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
