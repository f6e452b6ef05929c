"""Differentiable collectives of the port
(``chainermn_tpu/functions/collective.py``).

Reference anchor: ``chainermn/functions/collective_communication.py``.
Each function is a ``torch.autograd.Function`` whose backward runs the
transposed collective: all-to-all ↔ all-to-all, all-gather ↔
reduce-scatter, broadcast ↔ sum onto the root, gather ↔ scatter.  The
loss these gradients belong to is the sum of every rank's own loss, as in
the JAX package, where a ``psum`` of the ranks' contributions is
differentiated.

MPMD contract: every rank of the communicator calls the function, and
every rank's backward runs through its output (the backward is a
collective too).  A rank with nothing to contribute (a non-root rank of
:func:`bcast` or :func:`scatter`) may pass None; its output still carries
the backward edge that rank's part of the collective needs.
"""

from __future__ import annotations

from typing import Optional

import torch


def _anchor(device) -> torch.Tensor:
    """The tensor a rank with no input hands autograd: a zero-size leaf
    that requires grad, so the rank's backward runs its part of the
    transposed collective."""
    return torch.zeros(0, device=device, requires_grad=True)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, xs):
        ctx.comm = comm
        return comm.alltoall(xs)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.alltoall(g.contiguous())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.allgather(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.reduce_scatter(g.contiguous())


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, op):
        ctx.comm, ctx.op = comm, op
        return comm.allreduce(x, op=op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op not in ("sum", "mean"):
            raise RuntimeError(f"allreduce(op={ctx.op!r}) has no gradient "
                               "(nor has lax.pmax/pmin in the JAX package)")
        return None, ctx.comm.allreduce(g.contiguous(), op=ctx.op), None


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x, shape, dtype):
        ctx.comm, ctx.root, ctx.like = comm, root, x
        buf = x if comm.rank == root else \
            torch.empty(shape, dtype=dtype, device=x.device)
        return comm.broadcast(buf.detach(), root)

    @staticmethod
    def backward(ctx, g):
        comm, root, like = ctx.comm, ctx.root, ctx.like
        total = comm.reduce(g.contiguous(), root)
        if comm.rank == root:
            return None, None, total, None, None
        return None, None, torch.zeros_like(like), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root, ctx.like = comm, root, x
        out = comm.gather(x, root)
        if comm.rank != root:
            # The delegate of a non-root rank: it carries the backward
            # edge through which this rank receives its row.
            return x.new_zeros(0)
        return out

    @staticmethod
    def backward(ctx, g):
        comm, root, like = ctx.comm, ctx.root, ctx.like
        rows = g.contiguous() if comm.rank == root else \
            like.new_empty((comm.size,) + tuple(like.shape))
        return None, None, comm.scatter(rows, root)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, xs, shape, dtype):
        ctx.comm, ctx.root, ctx.like = comm, root, xs
        buf = xs if comm.rank == root else \
            torch.empty(shape, dtype=dtype, device=xs.device)
        return comm.scatter(buf.detach(), root)

    @staticmethod
    def backward(ctx, g):
        comm, root, like = ctx.comm, ctx.root, ctx.like
        rows = comm.gather(g.contiguous(), root)
        if comm.rank == root:
            return None, None, rows, None, None
        return None, None, torch.zeros_like(like), None, None


def alltoall(communicator, xs: torch.Tensor) -> torch.Tensor:
    """Local ``(size, ...)`` rows out, received rows back (row ``j`` came
    from rank ``j``).  Backward is the transposed all-to-all."""
    return _AllToAll.apply(communicator, xs)


def allgather(communicator, x: torch.Tensor) -> torch.Tensor:
    """This rank's value in, the ``(size, ...)`` stack of every rank's
    out.  Backward reduce-scatters the gradient rows to their owners."""
    return _AllGather.apply(communicator, x)


def allreduce(communicator, x: torch.Tensor, op: str = "sum"
              ) -> torch.Tensor:
    """``x`` reduced over the ranks (``sum``/``mean``/``max``/``min``);
    the backward of ``sum``/``mean`` is the same reduction of the
    gradient."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown op {op!r}")
    return _AllReduce.apply(communicator, x, op)


def _root_meta(communicator, x, root):
    """Root's shape and dtype on every rank (one object broadcast), and
    this rank's autograd input: ``x`` on root and where it requires grad,
    else an anchor (a non-root rank takes part in the backward even when
    what it passed needs no gradient)."""
    is_root = communicator.rank == root
    meta = (tuple(x.shape), x.dtype) if is_root else None
    shape, dtype = communicator.bcast_obj(meta, root=root)
    if not is_root and (x is None or not x.requires_grad):
        x = _anchor(communicator.device)
    return shape, dtype, x


def bcast(communicator, x: Optional[torch.Tensor], root: int = 0
          ) -> torch.Tensor:
    """Root's ``x`` on every rank (the other ranks pass anything: None, a
    placeholder, a chain's delegate).  Backward sums every rank's
    gradient onto root; the other ranks' inputs get zeros."""
    shape, dtype, x = _root_meta(communicator, x, root)
    return _Bcast.apply(communicator, root, x, shape, dtype)


def gather(communicator, x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every rank's ``x`` stacked on ``root``; the other ranks get a
    zero-size delegate that carries their backward edge.  Backward
    scatters root's gradient rows back (the JAX package's ``gather`` is an
    all-gather, which only SPMD needs)."""
    return _Gather.apply(communicator, root, x)


def scatter(communicator, xs: Optional[torch.Tensor], root: int = 0
            ) -> torch.Tensor:
    """Row ``rank`` of root's ``(size, ...)`` ``xs`` on every rank (the
    other ranks pass None or any tensor of that shape).  Backward gathers
    the gradient rows onto root."""
    shape, dtype, xs = _root_meta(communicator, xs, root)
    return _Scatter.apply(communicator, root, xs, shape, dtype)
