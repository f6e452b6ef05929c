"""Data-parallel ImageNet-shaped ResNet training: the port's twin of
``examples/imagenet/train_imagenet.py`` and its main path.

One process per card.  The synthetic image pool (``--iters-per-epoch`` x
the batch per rank, float32, labels = mean brightness binned into the
classes, from ``numpy.random.default_rng(seed)`` as in the JAX example;
each rank draws its own pool) or ``--train-npz`` data goes through the
native ``PrefetchIterator`` and a depth-2 ``DevicePrefetchIterator``
(pinned staging, side-stream copies) into the ``Trainer`` over
``create_multi_node_optimizer(sgd(lr, 0.9, nesterov=True))``
(``stateful``: the BN buffers), with ``--augment`` (random crop and flip on
the card), ``--double-buffering``, ``--grad-compression int8_ef``,
``LogReport``, ``--eval`` (top-1 accuracy on ``--val-size`` held-out
images through the multi-node evaluator, every epoch) and
``--checkpoint DIR`` (a snapshot every epoch; a run resumes from the
newest one).  ``--arch vit`` trains a ViT (``--vit s16|s14|b16``, the
JAX bench's geometries) with the stateless loss; ``--optimizer
lars|lamb``, ``--base-batch`` (linear LR scaling) and ``--warmup-epochs``
(warmup into cosine decay) are the large-batch recipe of the JAX
example.  Runs::

    python -m chainermn_tpu_torch.examples.train_imagenet --eval
    python -m chainermn_tpu_torch.examples.train_imagenet --device cpu \\
        --steps 2 --arch resnet18 --image-size 32 --num-classes 10 \\
        --batch-per-chip 4
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.train_imagenet

``--steps N`` stops after N iterations instead of ``--epoch`` epochs.
The JAX example validates every run; here ``--eval`` asks for it.
"""

from __future__ import annotations

import argparse
import functools
import math
import time
import types
from typing import Optional, Sequence

import numpy as np
import torch

#: ``--vit`` geometries: the JAX bench's ``CMN_BENCH_VIT`` variants
#: (``bench.py:1140-1151``): ViT-S/16, ViT-S/14 (T = 256 at 224 px) and
#: ViT-B/16.
VIT_GEOMETRIES = {
    "s16": dict(patch=16),
    "s14": dict(patch=14),
    "b16": dict(patch=16, d_model=768, n_heads=12, d_ff=3072),
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
    ap.add_argument("--maxpool", default="xla", choices=("xla", "fused"),
                    help="fused = ops.max_pool_fused (first-max-wins "
                         "backward)")
    ap.add_argument("--batch-per-chip", type=int, default=256)
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--iters-per-epoch", type=int, default=50,
                    help="synthetic pool size in batches")
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after this many iterations (default: after "
                         "--epoch epochs)")
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
    ap.add_argument("--checkpoint", default=None,
                    help="snapshot directory (every epoch; resumes from the "
                         "newest snapshot)")
    ap.add_argument("--augment", action="store_true",
                    help="random crop + flip on the card inside the step")
    ap.add_argument("--train-npz", default=None,
                    help="file-backed training data: a .npz archive or a "
                         "directory of .npy files (images NHWC float + "
                         "integer labels), scattered over the ranks")
    ap.add_argument("--val-npz", default=None,
                    help="file-backed validation data (same format)")
    ap.add_argument("--val-size", type=int, default=512,
                    help="synthetic validation-set size (no --val-npz)")
    ap.add_argument("--eval", action="store_true",
                    help="validate every epoch (the multi-node evaluator)")
    ap.add_argument("--eager-step", action="store_true",
                    help="run the train step eagerly on the card (by "
                         "default it is captured as a CUDA graph per "
                         "batch signature and replayed)")
    ap.add_argument("--double-buffering", action="store_true")
    ap.add_argument("--grad-compression", default=None,
                    choices=("int8_ef",))
    ap.add_argument("--base-batch", type=int, default=None,
                    help="linear LR scaling: --lr is calibrated at this "
                         "global batch and scaled by the global batch / "
                         "base batch")
    ap.add_argument("--warmup-epochs", type=float, default=0.0,
                    help="gradual-warmup epochs before cosine decay")
    ap.add_argument("--vit", default="s16", choices=tuple(VIT_GEOMETRIES),
                    help="--arch vit geometry: s16 (ViT-S/16), s14, b16")
    args = ap.parse_args(argv)
    if args.arch == "vit" and (args.stem, args.maxpool, args.bn,
                               args.conv1) != ("conv7", "xla", "sync",
                                               "none"):
        ap.error("--stem/--maxpool/--bn/--conv1 are ResNet knobs; they have "
                 "no meaning for --arch vit")
    return args


def synthetic_pool(seed: int, n: int, size: int, num_classes: int):
    """``n`` uniform float32 NHWC images and their mean brightness binned
    into the classes (the JAX example's synthetic pool, drawn directly in
    float32)."""
    rng = np.random.default_rng(seed)
    xs = rng.random((n, size, size, 3), dtype=np.float32)
    ys = (xs.mean(axis=(1, 2, 3)) * num_classes).astype(np.int32) \
        .clip(0, num_classes - 1)
    return xs, ys


def build(args, comm=None):
    """The example's pieces, ready to run: ``comm``, ``model``, ``opt``,
    ``trainer``, ``train_iter``, ``evaluator`` (None without --eval) with
    the newest validation ``results``, and ``checkpointer`` (None without
    --checkpoint)."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import (
        ArrayDataset,
        NpzDataset,
        scatter_dataset,
    )
    from chainermn_tpu_torch.extensions import (
        Evaluator,
        create_multi_node_checkpointer,
        create_multi_node_evaluator,
    )
    from chainermn_tpu_torch.iterators import (
        PrefetchIterator,
        SerialIterator,
        create_device_prefetch_iterator,
    )
    from chainermn_tpu_torch.models import (
        ResNet18,
        ResNet50,
        ViT,
        resnet_loss,
        vit_loss,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        kernel_mask,
        lamb,
        lars,
        linear_scaled_lr,
        sgd,
        warmup_cosine_schedule,
    )
    from chainermn_tpu_torch.training import Extension, LogReport, Trainer
    from chainermn_tpu_torch.utils import (
        resnet_params_to_flax,
        vit_params_to_flax,
    )

    if comm is None:
        dev = None if args.device == "cuda" else args.device
        comm = create_communicator(args.communicator, device=dev,
                                   allreduce_grad_dtype=args.wire_dtype)
    dev = comm.device
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    if args.arch == "vit":
        # Stateless (no BN).
        model = ViT(num_classes=args.num_classes,
                    image_size=args.image_size, dtype=dtype, device=dev,
                    seed=args.seed, **VIT_GEOMETRIES[args.vit])
        loss_fn, stateful = vit_loss(model), False
    else:
        arch = ResNet50 if args.arch == "resnet50" else ResNet18
        model = arch(num_classes=args.num_classes, axis_name=comm.axis_name,
                     stem=args.stem, maxpool=args.maxpool, bn=args.bn,
                     conv1=args.conv1, dtype=dtype, device=dev,
                     seed=args.seed)
        if args.branch_scale is not None:
            model.scale_residual_branches(args.branch_scale)
        loss_fn, stateful = resnet_loss(model), True

    local_bs = args.batch_per_chip
    if args.train_npz:
        ds = scatter_dataset(NpzDataset(args.train_npz), comm, shuffle=True,
                             seed=0)
    else:
        # Each rank its own pool; rank 0's is the JAX example's for the
        # same seed and batch.
        ds = ArrayDataset(*synthetic_pool(
            args.seed * 1000 + comm.rank, args.iters_per_epoch * local_bs,
            args.image_size, args.num_classes))
    per_epoch = math.ceil(len(ds) / local_bs)
    total = args.steps or args.epoch * per_epoch
    # The large-batch recipe: opt-in linear LR scaling from --base-batch,
    # gradual warmup into cosine decay (evaluated on the card inside the
    # step), LARS/LAMB trust ratios with the JAX package's kernel mask.
    peak_lr = (linear_scaled_lr(args.lr, local_bs * comm.size,
                                args.base_batch)
               if args.base_batch else args.lr)
    lr = (warmup_cosine_schedule(
        peak_lr, min(int(args.warmup_epochs * per_epoch), total), total)
        if args.warmup_epochs > 0 else peak_lr)
    to_flax = (functools.partial(vit_params_to_flax, n_heads=model.n_heads)
               if args.arch == "vit" else resnet_params_to_flax)
    tx = {"momentum": lambda: sgd(lr, 0.9, nesterov=True),
          "lars": lambda: lars(lr, weight_decay=1e-4, momentum=0.9,
                               mask=kernel_mask(model, to_flax)),
          "lamb": lambda: lamb(lr, weight_decay=1e-2,
                               mask=kernel_mask(model, to_flax))
          }[args.optimizer]()
    opt = create_multi_node_optimizer(
        tx, comm, double_buffering=args.double_buffering,
        grad_compression=args.grad_compression)
    state = opt.init(model)
    # Native workers assemble batches ahead into a ring; the device stage
    # copies each into pinned memory and to the card on a side stream.
    it = PrefetchIterator(ds, local_bs, shuffle=True, seed=0, copy=False)
    it = create_device_prefetch_iterator(it, comm, depth=2)
    step_kwargs = {"capture": False} if args.eager_step else {}
    if args.augment:
        from chainermn_tpu_torch.ops import random_crop_flip

        step_kwargs["augment"] = random_crop_flip(padding=4)
    stop = (args.steps, "iteration") if args.steps else (args.epoch, "epoch")
    trainer = Trainer(opt, state, loss_fn, it, stop=stop,
                      has_aux=not stateful, stateful=stateful,
                      step_kwargs=step_kwargs)
    trainer.extend(LogReport(trigger=(1, "epoch")))

    def print_step(tr):
        # The first and the last step only: reading the loss waits for
        # the card, which a print every few steps would do in the loop.
        i = tr.iteration - 1
        if i == 0 or tr.iteration == total:
            m = tr.last_metrics
            loss, acc = float(m["loss"]), float(m["accuracy"])
            if comm.rank == 0:
                print(f"step {i}: loss {loss:.4f} accuracy {acc:.4f}",
                      flush=True)

    trainer.extend(Extension(print_step, trigger=(1, "iteration"),
                             name="print_step"))

    def val_metric(m, batch):
        y = torch.as_tensor(batch[1], device=m.device).long()
        logits = m(batch[0], train=False)
        return {"val/accuracy": (logits.argmax(-1) == y).float()}

    evaluator = None
    results = {}
    if args.eval:
        if args.val_npz:
            val_ds = scatter_dataset(NpzDataset(args.val_npz), comm,
                                     force_equal_length=False)
        else:
            # Held-out seed, and each rank its share of the val set.
            vx, vy = synthetic_pool(1, args.val_size, args.image_size,
                                    args.num_classes)
            val_ds = scatter_dataset(ArrayDataset(vx, vy), comm,
                                     force_equal_length=False)
        # The validation batches reach the card through the same staging
        # as the training ones.
        evaluator = create_multi_node_evaluator(
            Evaluator(lambda: create_device_prefetch_iterator(
                SerialIterator(val_ds, local_bs, repeat=False,
                               shuffle=False), comm, depth=2),
                      val_metric, comm),
            comm)

        def run_eval(tr):
            results.update(evaluator.evaluate(tr.state.model))
            if comm.rank == 0:
                print("  ".join(f"{k} {v:.4f}" for k, v in results.items()),
                      flush=True)

        trainer.extend(Extension(run_eval, trigger=(1, "epoch"),
                                 name="validation"))
    ckpt, resumed = None, 0
    if args.checkpoint:
        ckpt = create_multi_node_checkpointer(
            "imagenet", comm, path=args.checkpoint, trigger=(1, "epoch"))
        trainer.extend(ckpt)
        _, resumed = ckpt.maybe_load(trainer.state, trainer)
        if resumed and comm.rank == 0:
            print(f"resumed from iteration {resumed}", flush=True)
    return types.SimpleNamespace(
        comm=comm, model=model, opt=opt, trainer=trainer, train_iter=it,
        evaluator=evaluator, results=results, checkpointer=ckpt,
        resumed_at=resumed)


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Returns the last step's loss."""
    args = parse_args(argv)
    run = build(args)
    comm = run.comm
    if comm.rank == 0:
        print(f"ranks: {comm.size}  arch: {args.arch}  bn: {args.bn}  "
              f"conv1: {args.conv1}  maxpool: {args.maxpool}  optimizer: "
              f"{args.optimizer}  batch per chip: {args.batch_per_chip}",
              flush=True)
    t0 = time.perf_counter()
    it0 = run.trainer.iteration
    run.trainer.run()
    run.train_iter.close()
    steps = run.trainer.iteration - it0
    if comm.rank == 0 and steps:
        wall = time.perf_counter() - t0
        print(f"{steps} steps in {wall:.2f} s: "
              f"{steps * args.batch_per_chip * comm.size / wall:.1f} "
              "images/s (first steps included)", flush=True)
    m = run.trainer.last_metrics
    return float(m["loss"]) if m else float("nan")


if __name__ == "__main__":
    main()
