"""Data-parallel MNIST-style training: the port's twin of
``examples/mnist/train_mnist.py``, the reference's flagship example.

Create a communicator, scatter the dataset, wrap the optimizer, train
through the ``Trainer`` with rank-0 reporting, a per-epoch evaluator and
an optional checkpointer.  Data is the JAX example's synthetic task
(``make_synthetic_classification``: 8192 training and 1024 validation
examples of 784 features, 10 classes), or ``.npz``/``.npy``-directory
files.  Runs::

    python -m chainermn_tpu_torch.examples.train_mnist
    python -m chainermn_tpu_torch.examples.train_mnist --device cpu --epoch 2
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.train_mnist

Validation runs on each rank's shard of the validation set and sums over
the ranks.  ``--ema-decay`` keeps a moving average of the parameters and
evaluates it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--batchsize", type=int, default=256,
                   help="global batch size")
    p.add_argument("--epoch", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--unit", type=int, default=256)
    p.add_argument("--wire-dtype", default=None,
                   help="e.g. bfloat16 (the fp16-allreduce analog)")
    p.add_argument("--double-buffering", action="store_true")
    p.add_argument("--grad-compression", default=None, choices=["int8_ef"])
    p.add_argument("--ema-decay", type=float, default=None,
                   help="evaluate an exponential moving average of the "
                        "parameters with this decay")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card) or 'cpu'")
    p.add_argument("--eager-step", action="store_true",
                   help="run the train step eagerly on the card (by "
                        "default it is captured as a CUDA graph per batch "
                        "signature and replayed)")
    p.add_argument("--out", default="result/mnist_log.json")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir; resumes from the latest snapshot")
    p.add_argument("--train-npz", default=None,
                   help="file-backed training data (.npz archive or .npy "
                        "dir: flattened float images + int labels)")
    p.add_argument("--val-npz", default=None,
                   help="file-backed validation data (same format)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Returns the trainer (its ``LogReport`` first among
    ``trainer.extensions``) and the validation metrics of every epoch."""
    args = parse_args(argv)

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import (
        NpzDataset,
        make_synthetic_classification,
        scatter_dataset,
    )
    from chainermn_tpu_torch.extensions import (
        Evaluator,
        create_multi_node_checkpointer,
        create_multi_node_evaluator,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import (
        MLP,
        classification_loss,
        classification_metrics,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        ema_model,
        sgd,
    )
    from chainermn_tpu_torch.training import Extension, LogReport, Trainer

    dev = None if args.device == "cuda" else args.device
    comm = create_communicator(args.communicator, device=dev,
                               allreduce_grad_dtype=args.wire_dtype)
    dev = comm.device
    if comm.rank == 0:
        print(f"ranks: {comm.size}  communicator: {args.communicator}",
              flush=True)
    train = scatter_dataset(
        NpzDataset(args.train_npz) if args.train_npz
        else make_synthetic_classification(8192, 784, 10, seed=1),
        comm, shuffle=True, seed=42)
    val = scatter_dataset(
        NpzDataset(args.val_npz) if args.val_npz
        else make_synthetic_classification(1024, 784, 10, seed=2),
        comm, force_equal_length=False)

    model = MLP(hidden=(args.unit, args.unit), n_out=10, device=dev, seed=0)
    opt = create_multi_node_optimizer(
        sgd(args.lr, momentum=0.9), comm,
        double_buffering=args.double_buffering,
        grad_compression=args.grad_compression, ema_decay=args.ema_decay)
    state = opt.init(model)
    # Each rank steps over its shard with its share of the global batch.
    local_bs = max(args.batchsize // comm.size, 1)
    train_iter = SerialIterator(train, local_bs, shuffle=True, seed=0)
    evaluator = create_multi_node_evaluator(
        Evaluator(lambda: SerialIterator(val, local_bs, repeat=False,
                                         shuffle=False),
                  classification_metrics(model), comm),
        comm)

    trainer = Trainer(opt, state, classification_loss(model), train_iter,
                      stop=(args.epoch, "epoch"), has_aux=True,
                      step_kwargs={"capture": False} if args.eager_step
                      else None)
    trainer.extend(LogReport(trigger=(1, "epoch"), out=args.out or None))
    history = []

    def run_eval(tr):
        target = ema_model(tr.state) if args.ema_decay else tr.state.model
        history.append(evaluator.evaluate(target))
        if comm.rank == 0:
            print("  ".join(f"{k} {v:.4f}" for k, v in history[-1].items()),
                  flush=True)

    trainer.extend(Extension(run_eval, trigger=(1, "epoch"),
                             name="validation"))
    # Last, so that a resume sets every extension's trigger state.
    if args.checkpoint:
        ckpt = create_multi_node_checkpointer(
            "mnist", comm, path=args.checkpoint, trigger=(1, "epoch"))
        trainer.extend(ckpt)
        _, resumed = ckpt.maybe_load(trainer.state, trainer)
        if resumed and comm.rank == 0:
            print(f"resumed from iteration {resumed}", flush=True)
    trainer.run()
    return trainer, history


if __name__ == "__main__":
    main()
