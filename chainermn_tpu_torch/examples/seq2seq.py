"""Seq2seq NMT: the port's twin of ``examples/seq2seq/seq2seq.py``.

Bucketed, padded variable-length batches (``bucket_batches``, width 4)
or packed pair rows (``--packed``: ``pack_pairs``, transformer only) train
the LSTM encoder-decoder (``--arch lstm``, the reference's model) or the
Transformer one (``--arch transformer``: ``--embed`` is d_model, 4 heads,
``--hidden`` the FFN width) under the ``Trainer`` with Adam 3e-3 and the
masked loss, data-parallel over the ranks (each rank its slice of every
global batch).  Each bucket shape is one batch signature, so on a card
the train step is captured once per bucket.  After training, corpus BLEU
through the multi-node evaluator: greedy decoding of the validation
pairs (each rank its share of the batches), the clipped n-gram
statistics summed exactly over batches and ranks, finalized once.  The
corpus is the JAX example's synthetic one (``make_synthetic_translation``,
4096 pairs of 4-16 tokens; 512 held-out pairs from seed 99) or a
``save_translation_npz`` file (``--data-npz``; its last eighth
validates).  Runs::

    python -m chainermn_tpu_torch.examples.seq2seq --epoch 3
    python -m chainermn_tpu_torch.examples.seq2seq --device cpu --epoch 1
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.seq2seq
    python -m chainermn_tpu_torch.launch --nproc 2 -m chainermn_tpu_torch.examples.seq2seq \
        --communicator naive --device cuda:0     # two ranks sharing one card
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--communicator", default="pure_nccl")
    ap.add_argument("--batchsize", type=int, default=64,
                    help="global batch (each rank its slice)")
    ap.add_argument("--epoch", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=50)
    ap.add_argument("--embed", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--bucket-width", type=int, default=4)
    ap.add_argument("--arch", default="lstm", choices=("lstm", "transformer"))
    ap.add_argument("--packed", action="store_true",
                    help="pack several pairs per row (transformer only)")
    ap.add_argument("--pack-len", type=int, default=64,
                    help="row width (both sides) for --packed")
    ap.add_argument("--data-npz", default=None,
                    help="corpus in save_translation_npz's format; the "
                         "last 1/8 of the pairs validates")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (this rank's card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="the model's initialization")
    args = ap.parse_args(argv)
    if args.packed and args.arch != "transformer":
        raise SystemExit("--packed needs --arch transformer (the LSTM tier "
                         "has no segment-isolated attention)")
    return args


class BatchList:
    """The training batches in a fixed order, epoch after epoch: the
    iterator the ``Trainer`` reads (``epoch``, ``is_new_epoch``,
    ``epoch_detail``)."""

    def __init__(self, batches: List[tuple]):
        self.batches = batches
        self.epoch = 0
        self.is_new_epoch = False
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batches[self._pos]
        self._pos += 1
        self.is_new_epoch = self._pos == len(self.batches)
        if self.is_new_epoch:
            self._pos = 0
            self.epoch += 1
        return b

    @property
    def epoch_detail(self) -> float:
        return self.epoch + self._pos / len(self.batches)


def _rank_slice(batch, rank: int, size: int):
    n = len(batch[0]) // size
    return tuple(a[rank * n:(rank + 1) * n] for a in batch)


def build(args, comm=None):
    """``(comm, model, trainer, evaluator, first_batch)``, ready to run."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import pack_pairs, packing_efficiency
    from chainermn_tpu_torch.datasets.seq import (
        bucket_batches,
        load_translation_npz,
        make_synthetic_translation,
    )
    from chainermn_tpu_torch.extensions import (
        Evaluator,
        bleu_finalize,
        bleu_stats,
        create_multi_node_evaluator,
    )
    from chainermn_tpu_torch.models import (
        Seq2Seq,
        TransformerSeq2Seq,
        greedy_decode,
        seq2seq_loss,
    )
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.training import LogReport, Trainer

    if comm is None:
        dev = None if args.device == "cuda" else args.device
        comm = create_communicator(args.communicator, device=dev)
    dev = comm.device
    if args.batchsize % comm.size:
        raise SystemExit(f"--batchsize {args.batchsize} is not a multiple "
                         f"of the {comm.size} ranks")
    if args.data_npz:
        all_pairs = load_translation_npz(args.data_npz)
        n_val = max(len(all_pairs) // 8, 1)
        pairs, val_pairs = all_pairs[:-n_val], all_pairs[-n_val:]
        hi = max(max(w for s, t in all_pairs for w in list(s) + list(t)), 0)
        if hi >= args.vocab:
            raise SystemExit(f"--data-npz contains token id {hi} >= "
                             f"--vocab {args.vocab}")
    else:
        pairs = make_synthetic_translation(4096, vocab=args.vocab, min_len=4,
                                           max_len=16)
        val_pairs = make_synthetic_translation(512, vocab=args.vocab,
                                               min_len=4, max_len=16, seed=99)
    B = args.batchsize
    if args.packed:
        src, tgt, sseg, tseg = pack_pairs(pairs, args.pack_len,
                                          args.pack_len)
        eff = packing_efficiency(tseg)
        # Whole batches of rows (zero rows are all pad, masked out of the
        # loss): every pair trains under one batch signature.
        n_rows = -(-len(src) // B) * B
        src, tgt, sseg, tseg = (
            np.concatenate([a, np.zeros((n_rows - len(a), a.shape[1]),
                                        a.dtype)])
            for a in (src, tgt, sseg, tseg))
        batches = [(src[i:i + B], tgt[i:i + B], sseg[i:i + B],
                    tseg[i:i + B]) for i in range(0, n_rows, B)]
        note = f"packed: {len(batches)} batches  packing efficiency: {eff:.2f}"
    else:
        batches = bucket_batches(pairs, B, bucket_width=args.bucket_width)
        nonpad = float(np.mean([(b[0] != 0).mean() for b in batches]))
        note = (f"buckets: {len(batches)} batches  non-pad fraction: "
                f"{nonpad:.2f}")
    if comm.rank == 0:
        print(f"ranks: {comm.size}  {note}", flush=True)
    if args.arch == "transformer":
        model = TransformerSeq2Seq(
            vocab_src=args.vocab, vocab_tgt=args.vocab, d_model=args.embed,
            n_heads=4, d_ff=max(args.hidden, args.embed), device=dev,
            seed=args.seed)
    else:
        model = Seq2Seq(vocab_src=args.vocab, vocab_tgt=args.vocab,
                        embed=args.embed, hidden=args.hidden, device=dev,
                        seed=args.seed)
    opt = create_multi_node_optimizer(adamw(3e-3, weight_decay=0.0), comm)
    state = opt.init(model)
    train_iter = BatchList([_rank_slice(b, comm.rank, comm.size)
                            for b in batches])
    trainer = Trainer(opt, state, seq2seq_loss(model), train_iter,
                      stop=(args.epoch, "epoch"), has_aux=True)
    trainer.extend(LogReport(trigger=(1, "epoch")))

    val_batches = bucket_batches(val_pairs, B, bucket_width=args.bucket_width,
                                 keep_tail=True)[comm.rank::comm.size]

    def bleu_metric(m, batch):
        src, tgt = batch
        return bleu_stats(greedy_decode(m, src, max_len=tgt.shape[1]),
                          torch.as_tensor(tgt, device=m.device))

    evaluator = create_multi_node_evaluator(
        Evaluator(lambda: iter(val_batches), bleu_metric, comm,
                  finalize=bleu_finalize), comm)
    return comm, model, trainer, evaluator, batches[0]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the corpus BLEU scores."""
    from chainermn_tpu_torch.models import greedy_decode

    args = parse_args(argv)
    comm, model, trainer, evaluator, first = build(args)
    trainer.run()
    scores = evaluator.evaluate(model)
    if comm.rank == 0:
        print(f"corpus BLEU {scores['bleu']:.2f}  "
              f"({int(scores['n_sentences'])} sentences)", flush=True)
        src0 = first[0]
        out = greedy_decode(model, src0[:4], max_len=src0.shape[1])
        print("sample src :", src0[0][src0[0] != 0])
        print("sample pred:", out[0].cpu().numpy())
    return scores


if __name__ == "__main__":
    main()
