"""Language-model training: the port's twin of ``examples/lm/train_lm.py``.

Data-parallel over the ranks of the process group, one card each; flash
attention on the card.  The same synthetic corpus (an order-2 Markov
stream from a seeded ``RandomState``), the same split and the same flags
as the JAX example, and the same loss print from rank 0.  Runs::

    python -m chainermn_tpu_torch.examples.train_lm --steps 60
    python -m chainermn_tpu_torch.examples.train_lm --device cpu --steps 3
    torchrun --nproc_per_node N -m chainermn_tpu_torch.examples.train_lm

Batches come from the native ``PrefetchIterator`` through a depth-2
``DevicePrefetchIterator``, as in the JAX example (the same batch order as
the serial iterator for the seed).  ``--eval`` holds out the last tenth
of the rows before training and, after it, reports the validation
perplexity through the multi-node evaluator (token-weighted sums over
every rank's share, finalized once: the exact corpus perplexity).
``--lora RANK`` freezes the model and trains adapters on its attention
projections (``--eval``/``--generate`` run on the merged export);
``--optimizer adafactor`` and ``--warmup N`` (linear warmup into cosine
decay) follow the JAX example's optax arithmetic, on the card inside the
captured step.  ``--zero`` trains under the ZeRO tier
(:func:`~chainermn_tpu_torch.optimizers.create_zero_optimizer`: each rank
keeps ``1/N`` of the parameters and optimizer state; the step gathers the
parameters, reduce-scatters the gradients); ``--eval``/``--generate`` then
run on the model holding the gathered parameters.
"""

from __future__ import annotations

import argparse
import functools
import math
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
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-shard params/grads/optimizer state 1/N")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="LoRA fine-tuning: freeze the base after init and "
                         "train rank-RANK adapters on the attention "
                         "projections; --eval/--generate run on the merged "
                         "export")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"),
                    help="adafactor = factored second moments "
                         "(optax.adafactor's arithmetic)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear-warmup steps into a cosine decay schedule")
    ap.add_argument("--eval", action="store_true",
                    help="after training, validation perplexity over a "
                         "held-out split via the multi-node evaluator")
    args = ap.parse_args(argv)
    if args.lora and args.zero:
        # ZeRO shards the optimizer's tree; with LoRA that tree is the
        # adapter set while the frozen base stays replicated.
        ap.error("--lora and --zero are mutually exclusive (the adapter "
                 "tree is too small to shard; the frozen base is "
                 "replicated either way)")
    if args.generate and 16 + args.generate > args.seq_len and not args.rope:
        ap.error(f"--generate {args.generate} + 16-token prompt exceeds "
                 f"--seq-len {args.seq_len}")
    return args


def lm_eval_metric(model):
    """The evaluator's metric function for the LM: per-row token-weighted
    cross-entropy sums ``ce_sum`` and target counts ``tokens`` (targets
    ``< 0`` are padding); a 3-array batch carries segment ids."""
    import torch.nn.functional as F

    def metric_fn(m, batch):
        toks, tgts, *rest = batch
        dev = next(m.parameters()).device
        toks = torch.as_tensor(toks, device=dev).long()
        tgts = torch.as_tensor(tgts, device=dev).long()
        seg = torch.as_tensor(rest[0], device=dev) if rest else None
        logits = m(toks, segment_ids=seg).float()
        mask = (tgts >= 0).float()
        # Rows of (B*T, V): the softmax runs over contiguous memory.
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             tgts.clamp_min(0).reshape(-1),
                             reduction="none").view(tgts.shape)
        return {"ce_sum": (ce * mask).sum(-1), "tokens": mask.sum(-1)}

    return metric_fn


def lm_eval_finalize(sums, count):
    """Corpus perplexity from the summed statistics (divided after the
    cross-rank sum, not a mean of batch means)."""
    return {"val_ppl": math.exp(sums["ce_sum"] / max(sums["tokens"], 1.0)),
            "val_tokens": sums["tokens"]}


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import (
        ArrayDataset,
        pack_sequences,
        packing_efficiency,
        scatter_dataset,
    )
    from chainermn_tpu_torch.extensions import (
        Evaluator,
        create_multi_node_evaluator,
    )
    from chainermn_tpu_torch.iterators import (
        PrefetchIterator,
        SerialIterator,
        create_device_prefetch_iterator,
    )
    from chainermn_tpu_torch.models import (
        TransformerLM,
        lm_loss,
        lora_init,
        lora_merge,
        lora_param_count,
        make_lora_loss,
    )
    from chainermn_tpu_torch.optimizers import (
        adafactor,
        adamw,
        create_multi_node_optimizer,
        create_zero_optimizer,
        warmup_cosine_schedule,
    )
    from chainermn_tpu_torch.utils import flax_shapes, params_to_flax

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
    # A real held-out split: the validation rows leave the arrays before
    # the training set is built.
    n_val = max(len(arrays[0]) // 10, comm.size) if args.eval else 0
    if n_val >= len(arrays[0]):
        raise SystemExit(f"--eval needs more data: {len(arrays[0])} rows "
                         f"cannot spare a {n_val}-row validation split")
    val_arrays = tuple(a[-n_val:] for a in arrays) if n_val else None
    if n_val:
        arrays = tuple(a[:-n_val] for a in arrays)
    ds = scatter_dataset(ArrayDataset(*arrays), comm, shuffle=True, seed=0)
    rows = ds[:]
    local = ArrayDataset(*[np.stack([row[i] for row in rows])
                           for i in range(len(arrays))])
    it = PrefetchIterator(local, args.batch_per_chip, seed=1, copy=False)
    it = create_device_prefetch_iterator(it, comm, depth=2)

    model = TransformerLM(
        vocab=vocab, n_layers=args.layers, d_model=args.d_model,
        n_heads=4, d_ff=4 * args.d_model, max_len=T,
        dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16,
        param_dtype=getattr(torch, args.param_dtype),
        remat=args.remat, pos_enc="rope" if args.rope else "learned",
        n_kv_heads=args.kv_heads, window=args.window, device=dev, seed=0,
    )
    # optax.warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    # warmup + 1)), evaluated on the card inside the step.
    lr = (warmup_cosine_schedule(args.lr, args.warmup,
                                 max(args.steps, args.warmup + 1))
          if args.warmup else args.lr)
    to_flax = functools.partial(params_to_flax, n_heads=model.n_heads,
                                n_kv_heads=model.n_kv_heads)
    tx = (adafactor(lr, shapes=flax_shapes(model, to_flax))
          if args.optimizer == "adafactor" else adamw(lr, weight_decay=0.01))
    opt = (create_zero_optimizer(tx, comm) if args.zero
           else create_multi_node_optimizer(tx, comm))
    loss_fn = lm_loss(model)
    trained = model
    if args.lora:
        total = lora_param_count(model)
        trained = lora_init(model, args.lora, seed=1)
        loss_fn = make_lora_loss(loss_fn)
        if comm.rank == 0:
            print(f"lora rank {args.lora}: {lora_param_count(trained)} "
                  f"trainable / {total} total params", flush=True)
    state = opt.init(trained)
    step = opt.make_train_step(loss_fn, has_aux=True, accum_steps=args.accum)
    metrics = {}
    for i in range(args.steps):
        state, metrics = step(state, next(it))
        if i % 20 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            if comm.rank == 0:
                print(f"step {i}: loss {loss:.4f}", flush=True)
    it.close()
    if args.zero and (args.eval or args.generate):
        # The model holds the last step's gather (the parameters before
        # its update): gather the current ones (a collective).
        opt.materialize_params(state)
    if args.lora and (args.eval or args.generate):
        # The merged export: eval and decoding run as on a fully
        # fine-tuned model.
        model = lora_merge(trained)
    if args.eval:
        val = scatter_dataset(ArrayDataset(*val_arrays), comm,
                              force_equal_length=False)
        eval_bs = min(64, n_val)
        ev = create_multi_node_evaluator(
            Evaluator(lambda: SerialIterator(val, eval_bs, repeat=False,
                                             shuffle=False),
                      lm_eval_metric(model), comm,
                      finalize=lm_eval_finalize), comm)
        scores = ev.evaluate(model)
        if comm.rank == 0:
            print(f"val_ppl {scores['val_ppl']:.3f}  "
                  f"({int(scores['val_tokens'])} tokens)", flush=True)
    if args.generate and comm.rank == 0:
        from chainermn_tpu_torch.models import lm_generate

        prompt = torch.from_numpy(corpus[:16][None].astype(np.int64))
        out = lm_generate(model, prompt, args.generate)
        print("prompt:", corpus[:16].tolist())
        print("generated:", out.cpu()[0].tolist())
    return float(metrics["loss"]) if metrics else float("nan")


if __name__ == "__main__":
    main()
