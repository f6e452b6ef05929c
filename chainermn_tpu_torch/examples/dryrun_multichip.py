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
(RoPE) as in the JAX entry.  Then the entry's last program, the ZeRO tier
over every rank: an MLP (8 -> 16 -> 4) step under Adam with the int8
error-feedback wire and 2 accumulation microbatches, a checkpoint round
trip into a fresh state checked bit-exact, and one more step from the
restored state.  Runs::

    python -m chainermn_tpu_torch.launch --nproc 8 -m chainermn_tpu_torch.examples.dryrun_multichip --device cpu
    python -m chainermn_tpu_torch.launch --nproc 8 -m chainermn_tpu_torch.examples.dryrun_multichip --communicator naive --device cuda:0
    torchrun --nproc_per_node 8 -m chainermn_tpu_torch.examples.dryrun_multichip
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
           "rope_logits_shape": tuple(rlogits.shape),
           **zero_program(args.communicator, dev, rng)}
    if comm.rank == 0:
        print(f"grid {grid}: 5-way-parallel step, global loss {total:.6f};"
              f" rope logits {tuple(rlogits.shape)} per rank, finite; "
              f"ZeRO int8 step loss {out['zero_loss']:.6f}, checkpoint "
              f"round trip exact, next step {out['zero_loss_restored']:.6f}",
              flush=True)
    comm.barrier()
    return out


def _state_tensors(state) -> list:
    """A ZeRO state's own tensors: shards, residuals, optimizer state."""
    out = [p.detach() for p in state.flat_params] + list(state.ef_residual)
    for entry in state.optimizer.state_dict()["state"].values():
        out += [v for v in entry.values() if hasattr(v, "shape")]
    return out


def zero_program(communicator: str, dev, rng) -> dict:
    """The JAX entry's ZeRO program on every rank (see the module
    docstring); the batch continues ``rng``'s draws as the entry's does."""
    import shutil
    import tempfile

    import torch

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import adamw, create_zero_optimizer

    zcomm = create_communicator(communicator, device=dev)
    n, r = zcomm.size, zcomm.rank
    x = rng.normal(size=(2 * n, 8)).astype(np.float32)
    y = rng.randint(0, 4, size=(2 * n,)).astype(np.int64)
    batch = (x[2 * r:2 * r + 2], y[2 * r:2 * r + 2])

    def build(seed):
        model = MLP(hidden=(16,), n_out=4, in_features=8, device=dev,
                    seed=seed)
        opt = create_zero_optimizer(adamw(1e-2, weight_decay=0.0), zcomm,
                                    grad_compression="int8_ef")
        state = opt.init(model)
        return state, opt.make_train_step(classification_loss(model),
                                          has_aux=True, accum_steps=2)

    state, step = build(0)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite ZeRO loss {loss}")
    ckdir = zcomm.bcast_obj(tempfile.mkdtemp(prefix="cmn_dryrun_ckpt_")
                            if r == 0 else None)
    try:
        ckpt = create_multi_node_checkpointer("dryrun", zcomm, path=ckdir,
                                              async_save=False)
        ckpt.save(state)
        ckpt.finalize()
        fresh, step2 = build(1)
        restored, _ = ckpt.maybe_load(fresh)
        for a, b in zip(_state_tensors(state), _state_tensors(restored)):
            if not torch.equal(a.cpu(), b.cpu()):
                raise RuntimeError(
                    "checkpoint round trip not bit-exact in dryrun")
        restored, metrics2 = step2(restored, batch)
        loss2 = float(metrics2["loss"])
        if not np.isfinite(loss2):
            raise RuntimeError(f"non-finite ZeRO loss {loss2} after the "
                               "restore")
    finally:
        zcomm.barrier()
        if r == 0:
            shutil.rmtree(ckdir, ignore_errors=True)
    return {"zero_loss": loss, "zero_loss_restored": loss2,
            "zero_roundtrip_exact": True}


if __name__ == "__main__":
    main()
