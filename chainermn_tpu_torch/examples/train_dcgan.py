"""Data-parallel DCGAN: the port's twin of
``examples/dcgan/train_dcgan.py`` (the reference's ``examples/dcgan``:
``net.py`` + ``updater.py``).

The generator and the discriminator each have their own optimizer (Adam,
lr 2e-4, b1 0.5), both updated every iteration from one shared forward,
both gradient sets mean-reduced over the ranks
(:func:`~chainermn_tpu_torch.models.make_gan_train_step`).  Data: the JAX
example's synthetic 32x32 blobs (``RandomState(7)``), scattered over the
ranks; the noise comes from ``RandomState(13)`` in the batch.  Runs::

    python -m chainermn_tpu_torch.examples.train_dcgan --device cpu --epoch 1
    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.train_dcgan --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.train_dcgan
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batchsize", type=int, default=64,
                   help="global batch size")
    p.add_argument("--epoch", type=int, default=3)
    p.add_argument("--nz", type=int, default=64, help="latent dim")
    p.add_argument("--ch", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n-train", type=int, default=2048)
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card), one device for every "
                   "rank (e.g. 'cuda:0'), or 'cpu'")
    p.add_argument("--out", default="result/dcgan_log.json")
    return p.parse_args(argv)


def synthetic_blobs(n: int, seed: int = 7) -> np.ndarray:
    """The JAX example's images: smooth blobs in tanh range, NHWC
    ``(n, 32, 32, 1)``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    centers = rng.uniform(0.2, 0.8, size=(n, 2))
    widths = rng.uniform(0.05, 0.2, size=(n, 1, 1))
    imgs = np.exp(-((yy[None] - centers[:, :1, None]) ** 2
                    + (xx[None] - centers[:, 1:, None]) ** 2) / widths)
    return (imgs * 2.0 - 1.0).astype(np.float32)[..., None]


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Returns the history of per-step metrics."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import ArrayDataset, scatter_dataset
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        Discriminator,
        Generator,
        gan_init,
        make_gan_train_step,
    )
    from chainermn_tpu_torch.optimizers import adamw

    args = parse_args(argv)
    dev = None if args.device == "cuda" else args.device
    comm = create_communicator(args.communicator, device=dev)
    dev = comm.device
    if comm.rank == 0:
        print(f"devices: {comm.size}", flush=True)
    train = scatter_dataset(ArrayDataset(synthetic_blobs(args.n_train)),
                            comm, shuffle=True, seed=11)
    gen = Generator(ch=args.ch, out_ch=1, nz=args.nz, device=dev, seed=0)
    disc = Discriminator(ch=args.ch, device=dev, seed=1)
    tx = adamw(args.lr, b1=0.5, weight_decay=0.0)
    state = gan_init(gen, disc, tx, tx, comm)
    step = make_gan_train_step(comm)
    it = SerialIterator(train, max(args.batchsize // comm.size, 1),
                        shuffle=True, seed=0)
    zrng = np.random.RandomState(13 + comm.rank)
    history = []
    while it.epoch < args.epoch:
        (real,) = next(it)
        z = zrng.normal(size=(len(real), args.nz)).astype(np.float32)
        state, metrics = step(state, (real, z))
        history.append({k: float(v) for k, v in metrics.items()})
        if it.is_new_epoch and comm.rank == 0:
            window = history[-it.iteration // max(it.epoch, 1):] or history
            means = {k: float(np.mean([h[k] for h in window]))
                     for k in window[0]}
            print(f"epoch {it.epoch}  " + "  ".join(
                f"{k} {v:.4f}" for k, v in means.items()), flush=True)
    if comm.rank == 0:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(history[-5:], f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return history


if __name__ == "__main__":
    main()
