"""Capacity-based top-k MoE routing, the counterpart of
``chainermn_tpu/parallel/moe.py``'s ``_topk_dispatch``.

Routing is static-shaped, as in the JAX package: token -> (expert, slot)
assignments are one-hot ``(N, E, C)`` masks that the callers contract
with einsums, never a gather or scatter.  Only the routing is ported; the
expert-parallel layer over an ``expert`` process group is not.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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
