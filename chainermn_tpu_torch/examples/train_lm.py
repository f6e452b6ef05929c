"""Language-model training: the port's twin of ``examples/lm/train_lm.py``.

Data-parallel over the ranks of the process group, one card each; flash
attention on the card.  The same synthetic corpus (an order-2 Markov
stream from a seeded ``RandomState``), the same split and the same flags
as the JAX example, and the same loss print from rank 0.  Runs::

    python -m chainermn_tpu_torch.examples.train_lm --steps 60
    python -m chainermn_tpu_torch.examples.train_lm --device cpu --steps 3
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.train_lm

Batches come from the port's ``SerialIterator`` (the native prefetching
iterators are not ported yet, ROADMAP Queue 1 item 6), so the batch order
is the serial iterator's, not the JAX example's prefetcher's.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def make_corpus(n_tokens: int = 200_000, vocab: int = 64, seed: int = 0):
    """Order-2 Markov stream: predictable structure a small LM can learn
    (the JAX example's corpus, draw for draw)."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=(vocab, vocab))
    out = np.zeros(n_tokens, np.int32)
    out[0], out[1] = rng.randint(0, vocab, 2)
    for i in range(2, n_tokens):
        out[i] = rng.choice(vocab, p=trans[out[i - 2], out[i - 1]])
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-chip", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--remat", action="store_true",
                    help="recompute decoder blocks in the backward")
    ap.add_argument("--pack", action="store_true",
                    help="train on packed variable-length documents "
                         "(segment-masked attention, per-doc positions)")
    ap.add_argument("--rope", action="store_true",
                    help="rotary position embeddings instead of the "
                         "learned table")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="grouped-query attention: kv heads (0 = classic "
                         "multi-head; must divide the 4 query heads)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention size (0 = full)")
    ap.add_argument("--param-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="parameter storage dtype")
    ap.add_argument("--generate", type=int, default=0,
                    help="after training, greedily generate N tokens from a "
                         "corpus prompt (KV-cache decode)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (this rank's card) or 'cpu'")
    # Flags of the JAX example whose modules are not ported yet: accepted
    # so that the command lines match, refused when set.
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--lora", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--eval", action="store_true")
    args = ap.parse_args(argv)
    for on, flag, item in ((args.zero, "--zero", "11"),
                           (args.lora, "--lora", "9"),
                           (args.optimizer != "adamw",
                            "--optimizer adafactor", "11"),
                           (args.warmup, "--warmup", "11"),
                           (args.eval, "--eval", "6")):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP Queue 1 item {item})")
    if args.generate and 16 + args.generate > args.seq_len and not args.rope:
        ap.error(f"--generate {args.generate} + 16-token prompt exceeds "
                 f"--seq-len {args.seq_len}")
    return args


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import (
        ArrayDataset,
        pack_sequences,
        packing_efficiency,
        scatter_dataset,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import TransformerLM, lm_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )

    dev = None if args.device == "cuda" else args.device
    comm = create_communicator("xla", device=dev)
    dev = comm.device
    vocab, T = 64, args.seq_len
    corpus = make_corpus()
    if args.pack:
        rng = np.random.RandomState(7)
        docs, at = [], 0
        while at < len(corpus) - 4:
            L = int(rng.randint(T // 4, T + 1))
            docs.append(corpus[at:at + L])
            at += L
        tokens, targets, seg = pack_sequences(docs, seq_len=T)
        if comm.rank == 0:
            print(f"packed {len(docs)} docs into {len(tokens)} rows "
                  f"(fill {packing_efficiency(seg):.2f})")
        arrays = (tokens, targets, seg)
    else:
        n_seq = (len(corpus) - 1) // T
        tokens = corpus[:n_seq * T].reshape(n_seq, T)
        targets = corpus[1:n_seq * T + 1].reshape(n_seq, T)
        arrays = (tokens, targets)
    ds = scatter_dataset(ArrayDataset(*arrays), comm, shuffle=True, seed=0)
    rows = ds[:]
    local = ArrayDataset(*[np.stack([row[i] for row in rows])
                           for i in range(len(arrays))])
    it = SerialIterator(local, args.batch_per_chip, seed=1)

    model = TransformerLM(
        vocab=vocab, n_layers=args.layers, d_model=args.d_model,
        n_heads=4, d_ff=4 * args.d_model, max_len=T,
        dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16,
        param_dtype=getattr(torch, args.param_dtype),
        remat=args.remat, pos_enc="rope" if args.rope else "learned",
        n_kv_heads=args.kv_heads, window=args.window, device=dev, seed=0,
    )
    opt = create_multi_node_optimizer(adamw(args.lr, weight_decay=0.01),
                                      comm)
    state = opt.init(model)
    step = opt.make_train_step(lm_loss(model), has_aux=True,
                               accum_steps=args.accum)
    metrics = {}
    for i in range(args.steps):
        state, metrics = step(state, next(it))
        if i % 20 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            if comm.rank == 0:
                print(f"step {i}: loss {loss:.4f}", flush=True)
    if args.generate and comm.rank == 0:
        from chainermn_tpu_torch.models import lm_generate

        prompt = torch.from_numpy(corpus[:16][None].astype(np.int64))
        out = lm_generate(model, prompt, args.generate)
        print("prompt:", corpus[:16].tolist())
        print("generated:", out.cpu()[0].tolist())
    return float(metrics["loss"]) if metrics else float("nan")


if __name__ == "__main__":
    main()
