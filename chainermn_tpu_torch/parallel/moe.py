"""Expert parallelism: capacity-based top-k MoE dispatch over an expert
process group (``chainermn_tpu/parallel/moe.py``).

Routing is static-shaped, as in the JAX package: token -> (expert, slot)
assignments are one-hot ``(N, E, C)`` masks contracted with einsums,
never a gather or scatter (:func:`_topk_dispatch`, which the single-card
MoE FFN of ``models.TransformerLM`` runs too).  Across ranks, tokens are
sharded over the expert communicator: each rank routes its ``N`` tokens
into an ``(E, C, D)`` buffer (row ``e`` for the rank that holds expert
``e``), an all-to-all (the reference's
``chainermn.functions.alltoall``) hands each rank the tokens for its
expert, the expert runs, and the reverse all-to-all and the combine
weights put the results back on their tokens.  The wire carries the
activation dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from chainermn_tpu_torch.functions.collective import alltoall


def _topk_dispatch(probs: torch.Tensor, capacity: int, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy top-k routing with per-expert capacity.

    ``probs``: ``(..., N, E)`` router probabilities (leading axes are
    independent groups, as the JAX package ``vmap``s it).  Returns
    ``(dispatch, combine, first_choice)``: ``dispatch`` ``(..., N, E, C)``
    one-hot token -> (expert, slot) assignments; ``combine`` the same
    weighted by the gates renormalized over each token's kept choices;
    ``first_choice`` ``(..., N, E)`` one-hot of each token's top-1 expert
    (for the load-balance loss).  Round ``i`` routes every token's
    ``i``-th choice; within a round earlier tokens take the earlier
    slots, after the slots earlier rounds filled, and a token past its
    expert's capacity is dropped for that choice.  ``torch.argmax``
    returns the first maximum, as ``jnp.argmax`` does, so a tie routes
    to the same expert as in the JAX package.
    """
    E = probs.shape[-1]
    C = capacity
    dt = probs.dtype
    dispatch = torch.zeros((*probs.shape, C), dtype=dt, device=probs.device)
    gates = torch.zeros_like(dispatch)
    gate_sum = torch.zeros(probs.shape[:-1], dtype=dt, device=probs.device)
    fill = torch.zeros((*probs.shape[:-2], 1, E), dtype=dt,
                       device=probs.device)
    remaining = probs
    first_choice = None
    for _ in range(k):
        onehot = F.one_hot(remaining.argmax(dim=-1), E).to(dt)  # (..., N, E)
        if first_choice is None:
            first_choice = onehot
        pos = torch.cumsum(onehot, dim=-2) - onehot + fill
        pos_tok = (pos * onehot).sum(dim=-1).to(torch.long)  # (..., N)
        keep = (pos_tok < C).to(dt)
        # one_hot of a slot >= C (a dropped token) is all zero, as
        # jax.nn.one_hot's is: pad one class and drop it.
        slot = F.one_hot(pos_tok.clamp(max=C), C + 1)[..., :C].to(dt)
        d_i = onehot[..., :, None] * slot[..., None, :] \
            * keep[..., None, None]
        gate = (probs * onehot).sum(dim=-1)
        dispatch = dispatch + d_i
        gates = gates + gate[..., None, None] * d_i
        gate_sum = gate_sum + gate * keep
        fill = fill + (onehot * keep[..., None]).sum(dim=-2, keepdim=True)
        remaining = remaining * (1.0 - onehot)
    denom = torch.clamp_min(gate_sum, torch.finfo(dt).tiny)
    combine = gates / denom[..., None, None]
    return dispatch, combine, first_choice


def moe_dispatch(x: torch.Tensor, gate_logits: torch.Tensor, comm,
                 capacity: int, k: int = 2):
    """Route this rank's tokens ``x`` ``(N, D)`` (router logits ``(N,
    E)``) to their experts across ``comm``; every rank calls it.  Returns
    ``(expert_batch, combine, aux)``: the ``(E*C, D)`` tokens for this
    rank's expert (row block ``s`` from rank ``s``), the ``(N, E, C)``
    weights for :func:`moe_combine`, and this rank's Switch load-balance
    loss."""
    E = comm.size
    if gate_logits.shape[-1] != E:
        raise ValueError(
            f"router width {gate_logits.shape[-1]} != expert axis size {E}")
    probs = torch.softmax(gate_logits.float(), dim=-1)
    dispatch, combine, first = _topk_dispatch(probs, capacity, k)
    # Switch load-balance loss: E * sum_e fraction_dispatched_e * mean_p_e.
    aux = E * (first.mean(dim=0) * probs.mean(dim=0)).sum()
    # Slot selection in fp32, the wire in the activation dtype.
    send = torch.einsum("nec,nd->ecd", dispatch, x.float()).to(x.dtype)
    recv = alltoall(comm, send)
    return recv.reshape(E * capacity, x.shape[-1]), combine, aux


def moe_combine(expert_out: torch.Tensor, combine: torch.Tensor, comm
                ) -> torch.Tensor:
    """Inverse of :func:`moe_dispatch`: ``(E*C, F)`` expert outputs ->
    ``(N, F)`` on the tokens' own ranks."""
    N, E, C = combine.shape
    back = alltoall(comm, expert_out.reshape(E, C, -1))
    out = torch.einsum("nec,ecf->nf", combine, back.float())
    return out.to(expert_out.dtype)


class MoELayer:
    """Mixture-of-experts layer over an expert communicator (one expert
    per rank).  ``expert_apply(expert_params, tokens) -> tokens`` is the
    local expert; ``layer(router_w, expert_params, x)`` on every rank,
    with this rank's tokens ``(N, D)`` and the replicated router ``(D,
    E)``, returns ``(out, aux_loss)``."""

    def __init__(self, expert_apply: Callable, comm, k: int = 2,
                 capacity_factor: float = 1.25):
        self.expert_apply = expert_apply
        self.comm = comm
        self.k = k
        self.capacity_factor = capacity_factor

    def capacity(self, n_tokens: int, n_experts: int) -> int:
        return max(1, math.ceil(self.k * self.capacity_factor * n_tokens
                                / n_experts))

    def __call__(self, router_w, expert_params, x):
        E = self.comm.size
        C = self.capacity(x.shape[0], E)
        logits = x @ router_w
        expert_batch, combine, aux = moe_dispatch(x, logits, self.comm, C,
                                                  self.k)
        h = self.expert_apply(expert_params, expert_batch)
        return moe_combine(h, combine, self.comm), aux
