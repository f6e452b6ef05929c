"""One 5-way-parallel training step of ``ParallelLM``: the port's twin of
``__graft_entry__.dryrun_multichip``.

The world size is factored into a ``(data, stage, model, seq)`` rank grid
as the JAX entry factors its devices: ``model`` takes 4 from 32 ranks on
(2 below), then ``stage`` and ``seq`` take 2 where they divide, and
``data`` the rest (8 -> 1x2x2x2, 16 -> 2x2x2x2, 32 -> 2x2x4x2).  On that
grid: the tiny config of the JAX entry (vocab 32, d_model 16, 2 heads per
model rank, one expert per model rank, top-1), one SGD-momentum step
(lr 0.05, momentum 0.9) with learned positions, its global loss checked
finite; then a forward with RoPE positions, its logits checked finite.
Parameters come from ``RandomState(0)`` (learned) and ``RandomState(1)``
(RoPE) as in the JAX entry.  Runs::

    python -m chainermn_tpu_torch.launch --nproc 8 -m chainermn_tpu_torch.examples.dryrun_multichip --device cpu
    python -m chainermn_tpu_torch.launch --nproc 8 -m chainermn_tpu_torch.examples.dryrun_multichip --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.dryrun_multichip

The JAX entry's last program, the ZeRO-sharded MLP step, belongs to the
ZeRO optimizer, which the port does not have yet.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def grid_shape(n: int) -> dict:
    """The JAX entry's factoring of ``n`` ranks into the four axes."""
    model = 4 if (n >= 32 and n % 4 == 0) else (2 if n % 2 == 0 else 1)
    stage = 2 if (n // model) % 2 == 0 else 1
    seq = 2 if (n // (model * stage)) % 2 == 0 else 1
    data = n // (model * stage * seq)
    return {"data": data, "stage": stage, "model": model, "seq": seq}


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--communicator", default="hierarchical")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (this rank's card), one device for every "
                   "rank (e.g. 'cuda:0'), or 'cpu'")
    return p.parse_args(argv)


def _local(x, grid, coords):
    """This rank's ``(data, seq)`` block of a global ``(B, T)`` array."""
    B, T = x.shape
    b, t = B // grid["data"], T // grid["seq"]
    d, q = coords["data"], coords["seq"]
    return x[d * b:(d + 1) * b, q * t:(q + 1) * t]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import torch

    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.models import (
        ParallelLM,
        ParallelLMConfig,
        init_parallel_lm,
    )
    from chainermn_tpu_torch.models.transformer import _tree_items
    from chainermn_tpu_torch.utils import parallel_lm_shard

    args = parse_args(argv)
    device = None if args.device == "cuda" else args.device
    comm = create_communicator(args.communicator, device=device)
    grid = grid_shape(comm.size)
    comm = create_communicator(args.communicator, device=comm.device,
                               mesh=hybrid_mesh(grid))
    dev = comm.device
    cfg = ParallelLMConfig(
        vocab=32, n_stages=grid["stage"], d_model=16,
        n_heads=2 * grid["model"], d_ff=32, max_len=8 * grid["seq"],
        n_experts=grid["model"], moe_k=1)
    lm = ParallelLM(cfg, comm, n_microbatches=2)
    coords = lm.coords

    rng = np.random.RandomState(0)
    host = init_parallel_lm(rng, cfg)
    B, T = grid["data"] * 2, cfg.max_len
    tokens = rng.randint(0, cfg.vocab, size=(B, T)).astype(np.int32)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    params = parallel_lm_shard(host, cfg, coords, device=dev)
    leaves = [t for _, t in _tree_items(params)]
    opt = torch.optim.SGD(leaves, lr=0.05, momentum=0.9)
    batch = (torch.as_tensor(_local(tokens, grid, coords), device=dev),
             torch.as_tensor(_local(targets, grid, coords), device=dev))
    loss = lm.loss(params, batch)
    loss.backward()
    reduced = lm.grad_reduce(lm.grads_of(params))
    for (_, p), (_, g) in zip(_tree_items(params), _tree_items(reduced)):
        p.grad = g
    opt.step()
    total = float(lm.total_loss(loss))
    if not np.isfinite(total):
        raise RuntimeError(f"non-finite loss {total}")

    # The same grid under rotary positions: each seq shard rotates q/k
    # at its global positions before the ring.
    rcfg = cfg._replace(pos_enc="rope")
    rlm = ParallelLM(rcfg, comm, n_microbatches=2)
    rparams = parallel_lm_shard(init_parallel_lm(np.random.RandomState(1),
                                                 rcfg), rcfg, coords,
                                device=dev)
    with torch.no_grad():
        rlogits = rlm.apply(rparams, batch[0])
    if not bool(torch.isfinite(rlogits).all()):
        raise RuntimeError("non-finite rope logits")
    out = {"grid": grid, "loss": total,
           "rope_logits_shape": tuple(rlogits.shape)}
    if comm.rank == 0:
        print(f"grid {grid}: 5-way-parallel step, global loss {total:.6f};"
              f" rope logits {tuple(rlogits.shape)} per rank, finite",
              flush=True)
    comm.barrier()
    return out


if __name__ == "__main__":
    main()
