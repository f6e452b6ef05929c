"""Data-parallel ImageNet-shaped ResNet training: the port's twin of the
core path of ``examples/imagenet/train_imagenet.py``.

One process per card; the communicator's gradient all-reduce and, with
``--bn sync``, the cross-rank batch statistics of every BN layer.  Data is
synthetic, as in the JAX example's default: uniform images whose label is
their mean brightness binned into the classes, drawn on the device from
``--seed`` (at 224 px the mean of so many uniform draws sits near 0.5, so
nearly every label is the middle class).  Runs::

    python -m chainermn_tpu_torch.examples.train_imagenet --steps 20
    python -m chainermn_tpu_torch.examples.train_imagenet --device cpu \\
        --steps 2 --arch resnet18 --image-size 32 --num-classes 10 \\
        --batch-per-chip 4
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.train_imagenet

The JAX example drives the step through its ``Trainer`` with a prefetching
loader, a per-epoch evaluator and an optional checkpointer; none of those
is ported yet, so this twin runs ``--steps`` steps of the same train step
(``create_multi_node_optimizer(sgd(lr, 0.9, nesterov=True))`` ->
``make_train_step(resnet_loss(model), stateful=True)``) and prints the
loss from rank 0.  Flags of the JAX example whose modules are not ported
are accepted and refused when set, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

#: flags of the JAX example whose modules are not ported yet, with the
#: ROADMAP Queue 1 item that ports them.
_UNPORTED = {
    "checkpoint": ("--checkpoint", "7 (extensions/checkpoint.py)"),
    "augment": ("--augment", "7 (ops/augment.py)"),
    "train_npz": ("--train-npz", "6 (file-backed datasets and the "
                                 "prefetching iterators)"),
    "val_npz": ("--val-npz", "6 (the evaluator)"),
    "eval": ("--eval", "6 (Trainer and evaluator)"),
    "double_buffering": ("--double-buffering", "6"),
    "grad_compression": ("--grad-compression", "6"),
    "base_batch": ("--base-batch", "11 (optimizers/large_batch.py)"),
    "warmup_epochs": ("--warmup-epochs", "11 (optimizers/large_batch.py)"),
}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="resnet50",
                    choices=("resnet50", "resnet18", "vit"))
    ap.add_argument("--bn", default="sync", choices=("sync", "frozen"),
                    help="sync = training-mode cross-rank BN (the "
                         "headline); frozen = stored-statistics affine")
    ap.add_argument("--conv1", default="none",
                    choices=("none", "xla", "pallas"),
                    help="bottleneck 1x1 convs as the fused conv+affine+ReLU "
                         "kernel (pallas) or its plain twin (xla); needs "
                         "--bn frozen")
    ap.add_argument("--stem", default="conv7", choices=("conv7", "s2d"))
    ap.add_argument("--maxpool", default="xla", choices=("xla", "fused"))
    ap.add_argument("--batch-per-chip", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--communicator", default="pure_nccl")
    ap.add_argument("--wire-dtype", default=None,
                    help="gradient all-reduce dtype, e.g. bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (this rank's card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--branch-scale", type=float, default=None,
                    help="start every residual branch's last affine scale "
                         "at this value (e.g. 0.1 keeps --bn frozen finite "
                         "from random weights; default: 1, as the JAX "
                         "example)")
    ap.add_argument("--optimizer", default="momentum",
                    choices=("momentum", "lars", "lamb"))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--augment", action="store_true")
    ap.add_argument("--train-npz", default=None)
    ap.add_argument("--val-npz", default=None)
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--double-buffering", action="store_true")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--base-batch", type=int, default=None)
    ap.add_argument("--warmup-epochs", type=float, default=0.0)
    args = ap.parse_args(argv)
    for attr, (flag, item) in _UNPORTED.items():
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")
    if args.optimizer != "momentum":
        raise NotImplementedError(
            f"--optimizer {args.optimizer} is not ported yet (ROADMAP Queue "
            "1 item 11, optimizers/large_batch.py)")
    if args.arch == "vit":
        raise NotImplementedError(
            "--arch vit is not ported yet (ROADMAP Queue 1 item 9)")
    return args


def synthetic_batch(g: torch.Generator, batch: int, size: int,
                    num_classes: int, device):
    """Uniform NHWC images and their mean brightness binned into the
    classes (the JAX example's synthetic labels)."""
    x = torch.rand((batch, size, size, 3), generator=g, device=device)
    y = (x.mean(dim=(1, 2, 3)) * num_classes).long() \
        .clamp_(0, num_classes - 1)
    return x, y


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import ResNet18, ResNet50, resnet_loss
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )

    dev = None if args.device == "cuda" else args.device
    comm = create_communicator(args.communicator, device=dev,
                               allreduce_grad_dtype=args.wire_dtype)
    dev = comm.device
    arch = ResNet50 if args.arch == "resnet50" else ResNet18
    model = arch(num_classes=args.num_classes, axis_name=comm.axis_name,
                 stem=args.stem, maxpool=args.maxpool, bn=args.bn,
                 conv1=args.conv1,
                 dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16,
                 device=dev, seed=args.seed)
    if args.branch_scale is not None:
        model.scale_residual_branches(args.branch_scale)
    opt = create_multi_node_optimizer(sgd(args.lr, 0.9, nesterov=True), comm)
    state = opt.init(model)
    step = opt.make_train_step(resnet_loss(model), stateful=True)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed * 1000 + comm.rank)  # each rank its own data
    if comm.rank == 0:
        print(f"ranks: {comm.size}  arch: {args.arch}  bn: {args.bn}  "
              f"conv1: {args.conv1}  batch per chip: {args.batch_per_chip}",
              flush=True)
    metrics, t0 = {}, time.perf_counter()
    for i in range(args.steps):
        batch = synthetic_batch(g, args.batch_per_chip, args.image_size,
                                args.num_classes, dev)
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            if comm.rank == 0:
                print(f"step {i}: loss {loss:.4f} accuracy "
                      f"{float(metrics['accuracy']):.4f}", flush=True)
    if comm.rank == 0 and args.steps:
        wall = time.perf_counter() - t0
        print(f"{args.steps} steps in {wall:.2f} s: "
              f"{args.steps * args.batch_per_chip * comm.size / wall:.1f} "
              "images/s (first steps included)", flush=True)
    return float(metrics["loss"]) if metrics else float("nan")


if __name__ == "__main__":
    main()
