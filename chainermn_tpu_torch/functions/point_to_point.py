"""Differentiable point-to-point communication of the port
(``chainermn_tpu/functions/point_to_point.py``).

Reference anchor: ``chainermn/functions/point_to_point_communication.py``
(``Send``/``Recv``/``pseudo_connect``).  The port is MPMD, as the
reference was, so the reference's shape comes back: ``send`` on the
sending rank returns a *delegate*, a zero-size tensor whose backward
receives the gradient from the receiving rank, and ``recv`` on the
receiving rank returns the tensor, whose backward sends the gradient
back::

    # rank 0                             # rank 1
    d = F.send(y, comm, rank=1)          h = F.recv(comm, rank=0)
    d.data.sum().backward()              ...; loss.backward()

Both directions are posted without waiting (``post_send``): a rank never
blocks on a send before its receives are posted, so a backward whose
ranks send and receive in different orders cannot deadlock.  The header
of each message carries the shape, the dtype and whether the sender wants
a gradient back.

The JAX package's SPMD form stays: :func:`send_recv` and :func:`shift`
are collectives every rank calls (backward: the inverse permutation), and
``send(x, comm, rank, rank_src)`` with an explicit source is the JAX call,
made by every rank, whose delegate carries the payload that :func:`recv`
unwraps on the destination (zeros elsewhere).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch


class DelegateVariable(NamedTuple):
    """The result of :func:`send`.  ``data`` is the received payload in
    the SPMD form (``spmd=True``; zeros off the destination), and in the
    MPMD form the sender's zero-size tensor that carries the backward
    edge (pass it to :func:`recv` or :func:`pseudo_connect` to keep the
    graph connected)."""

    data: Any
    src: int
    dst: int
    spmd: bool = True


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, perm, x):
        ctx.comm, ctx.perm = comm, perm
        return comm.permute(x, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return None, None, ctx.comm.permute(g.contiguous(), inverse)


class _Send(torch.autograd.Function):
    """Forward posts ``x`` to ``peer``; backward receives its gradient."""

    @staticmethod
    def forward(ctx, comm, peer, x):
        ctx.comm, ctx.peer = comm, peer
        comm.post_send(x.detach(), peer, wants_grad=x.requires_grad)
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.comm.recv_tensor(ctx.peer)[0]


class _Recv(torch.autograd.Function):
    """Forward hands out a received tensor; backward posts its gradient
    to ``peer`` and passes a zero-size gradient on to ``anchor`` (an
    earlier send's delegate, whose own backward then runs)."""

    @staticmethod
    def forward(ctx, comm, peer, anchor, t):
        ctx.comm, ctx.peer, ctx.anchor = comm, peer, anchor
        return t

    @staticmethod
    def backward(ctx, g):
        ctx.comm.post_send(g.contiguous(), ctx.peer)
        return None, None, torch.zeros_like(ctx.anchor), None


def send_recv(x: torch.Tensor, communicator,
              pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Move ``x`` along ``[(src, dst), ...]`` (every rank calls it); ranks
    with no incoming edge get zeros.  Backward is the inverse
    permutation."""
    perm = [(int(s), int(d)) for s, d in pairs]
    return _Permute.apply(communicator, perm, x)


def send(x: torch.Tensor, communicator, rank: int,
         rank_src: Optional[int] = None) -> DelegateVariable:
    """Send ``x`` to rank ``rank``.

    Without ``rank_src`` (the reference's ``send(x, communicator, rank)``)
    only the sending rank calls it; the delegate's ``data`` carries the
    backward edge that receives the gradient.  With ``rank_src`` (the JAX
    package's call) every rank calls it: one edge of :func:`send_recv`."""
    if rank_src is not None:
        moved = send_recv(x, communicator, [(rank_src, rank)])
        return DelegateVariable(moved, int(rank_src), int(rank))
    if x.requires_grad:
        d = _Send.apply(communicator, int(rank), x)
    else:
        communicator.post_send(x, int(rank), wants_grad=False)
        d = x.new_zeros(0)
    return DelegateVariable(d, communicator.rank, int(rank), spmd=False)


def recv(communicator, rank: int,
         delegate_variable: Optional[DelegateVariable] = None):
    """Receive from rank ``rank``.

    With an SPMD delegate (from ``send(..., rank_src=...)``) the payload
    already moved: this unwraps it after checking its source.  Otherwise
    (the reference's ``recv(communicator, rank, delegate_variable)``) it
    receives the next tensor ``rank`` sent; ``delegate_variable``, an
    earlier MPMD send's delegate on this rank, is joined into the graph so
    that its backward runs after this tensor's gradient has been sent."""
    if delegate_variable is not None and delegate_variable.spmd:
        if delegate_variable.src != rank:
            raise ValueError(f"recv from rank {rank} but delegate came from "
                             f"rank {delegate_variable.src}")
        return delegate_variable.data
    t, wants_grad = communicator.recv_tensor(int(rank))
    anchor = delegate_variable.data if delegate_variable is not None \
        else None
    if not wants_grad:
        return t if anchor is None else pseudo_connect(delegate_variable, t)
    if anchor is None:
        anchor = torch.zeros(0, device=t.device, requires_grad=True)
    return _Recv.apply(communicator, int(rank), anchor, t)


def pseudo_connect(delegate_variable: Optional[DelegateVariable],
                   *actual_variables):
    """Reference anchor ``pseudo_connect(delegate_variable,
    *actual_variables)``: the variables unchanged, with the delegate tied
    into their graph (a zero-valued term), so a backward through them also
    runs the delegate's (its send's gradient receive)."""
    if not actual_variables:
        raise ValueError("pseudo_connect needs at least one actual variable")
    if delegate_variable is None:
        return actual_variables if len(actual_variables) > 1 \
            else actual_variables[0]
    tie = delegate_variable.data.sum() * 0.0
    out = tuple(v + tie.to(v.dtype) for v in actual_variables)
    return out if len(out) > 1 else out[0]


def shift(x: torch.Tensor, communicator, offset: int = 1,
          wrap: bool = True) -> torch.Tensor:
    """Neighbour exchange along the ranks: rank ``r``'s value goes to rank
    ``r + offset``; ``wrap=False`` leaves the edge ranks receiving
    zeros."""
    n = communicator.size
    if wrap:
        pairs = [(s, (s + offset) % n) for s in range(n)]
    else:
        pairs = [(s, s + offset) for s in range(n) if 0 <= s + offset < n]
    return send_recv(x, communicator, pairs)
