"""Model-parallel chains of the port (``chainermn_tpu/links/chain_list.py``
``MultiNodeChainList``).

Reference anchor: ``chainermn/links/multi_node_chain_list.py``
``MultiNodeChainList.add_link(link, rank_in, rank_out)``: a declarative
model-parallel graph whose components each run on their own rank,
stitched with point-to-point sends and receives (SURVEY.md §3.4).  The
port is MPMD like the reference: each rank builds, holds and runs only
its own links, and activations and their gradients travel through
:func:`~chainermn_tpu_torch.functions.send` and
:func:`~chainermn_tpu_torch.functions.recv`.

Deadlock freedom: every send is posted without waiting (the receiver
learns shape and dtype from the message's header), so a rank never blocks
on a send before it posts what it must receive; each edge's messages
carry matched tags (both ends count them), and every rank walks the links
in the same order.  In the backward the gradient sends are posted the
same way, so the transposed chain cannot deadlock either, whatever order
autograd visits a rank's nodes in.

:class:`PipelineChain` (homogeneous stages) and
:class:`HeteroPipelineChain` (stages of different shapes) are GPipe
pipelines over one rank per stage.  The JAX package runs them as one SPMD
program (a ``lax.scan`` of ticks, a flat activation buffer and a
``lax.switch`` for the hetero tier); here rank ``s`` runs only its own
stage, microbatch by microbatch: it receives microbatch ``m`` from rank
``s - 1`` (the header carries its true shape), runs its stage and posts
the result to rank ``s + 1`` without waiting, so rank ``s`` works on
microbatch ``m + 1`` while rank ``s + 1`` works on ``m``.  The backward
walks the microbatches in the same fixed order on every stage, so the
gradient a rank receives from ``s + 1`` is always the one for the
microbatch it expects (the per-edge tags match the ``m``-th message of
each direction).  The last stage's output reaches every stage rank
through :func:`~chainermn_tpu_torch.functions.bcast`, as the JAX
package's ``psum`` of the masked output does; its backward adds the
ranks' gradients onto the last stage, which the gradient reduction
accounts for (``model_parallel_grad_reduce``, ``ParallelLM.grad_reduce``).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from chainermn_tpu_torch.functions.collective import bcast
from chainermn_tpu_torch.functions.point_to_point import recv, send


class _ChainLink(NamedTuple):
    index: Optional[int]  # position in ``stages`` on its owner, else None
    rank: int
    rank_in: Optional[int]
    rank_out: Optional[int]
    src: Optional[int]  # the rank the link's input comes from


class MultiNodeChainList(nn.Module):
    """Heterogeneous model-parallel chain.  ``add_link(module, rank=owner,
    rank_in=..., rank_out=...)`` follows the reference's ``add_link(link,
    rank_in, rank_out)`` with the owner named (the JAX package's form);
    ``module`` is an ``nn.Module`` or a function that builds one, called
    only on the owner (other ranks may pass None).  ``forward(x)`` runs
    on every rank of the communicator: it returns the chain's output on
    the rank that ends it, the last send's delegate (a zero-size tensor
    that carries the backward edge) on a rank whose part ended with a
    send, and None on a rank the chain never touches."""

    def __init__(self, comm):
        super().__init__()
        self.comm = comm
        self.stages = nn.ModuleList()
        self._links: List[_ChainLink] = []

    def add_link(self, module: Union[nn.Module, Callable[[], nn.Module],
                                     None],
                 rank: int, rank_in: Optional[int] = None,
                 rank_out: Optional[int] = None) -> "MultiNodeChainList":
        """Append a link owned by ``rank``; its input comes from
        ``rank_in`` (or the previous link's owner) and, for the last
        link, its output goes to ``rank_out``.  The edge is checked
        against the previous link here, with the JAX package's messages."""
        i = len(self._links)
        src = rank_in
        if i > 0:
            prev = self._links[-1]
            # The only valid edge source is the previous link's owner.
            if src is not None and src != prev.rank:
                raise ValueError(
                    f"link {i} declares rank_in={src} but link "
                    f"{i - 1} is owned by rank {prev.rank}")
            if prev.rank_out is not None:
                if prev.rank_out != rank:
                    raise ValueError(
                        f"link {i - 1} declares rank_out={prev.rank_out} "
                        f"but link {i} is owned by rank {rank}")
                src = prev.rank
            if src is None and prev.rank != rank:
                raise ValueError(
                    f"broken chain: link {i - 1} (rank {prev.rank}) → "
                    f"link {i} (rank {rank}) has no declared edge; "
                    f"set rank_out/rank_in")
        index = None
        if rank == self.comm.rank:
            if module is None:
                raise ValueError(f"link {i} is owned by this rank ({rank}) "
                                 "but no module was given")
            if not isinstance(module, nn.Module):
                module = module()
            self.stages.append(module)
            index = len(self.stages) - 1
        self._links.append(_ChainLink(index, int(rank), rank_in, rank_out,
                                      src))
        return self

    def forward(self, x):
        if not self._links:
            raise ValueError("the chain has no links")
        first = self._links[0]
        # Only the rank that feeds the first link holds the input.
        h = x if self.comm.rank in (first.rank, first.src) else None
        delegate = None
        for link in self._links:
            if link.src is not None and link.src != link.rank:
                h, delegate = self._edge(h, delegate, link.src, link.rank)
            if link.index is not None:
                h = self.stages[link.index](h)
        tail = self._links[-1]
        if tail.rank_out is not None and tail.rank_out != tail.rank:
            h, delegate = self._edge(h, delegate, tail.rank, tail.rank_out)
        self.comm.wait_pending()
        if h is not None:
            return h
        return delegate.data if delegate is not None else None

    def _edge(self, h, delegate, src: int, dst: int):
        """One cross-rank edge: the sender posts ``h`` and keeps the
        delegate, the receiver takes the tensor (joined to its own
        earlier delegate), every other rank passes through."""
        me = self.comm.rank
        if me == src:
            return None, send(h, self.comm, dst)
        if me == dst:
            return recv(self.comm, src, delegate_variable=delegate), None
        return h, delegate

    def to_pipeline(self, io_shapes, n_microbatches: int
                    ) -> "HeteroPipelineChain":
        """Lower a LINEAR chain onto :class:`HeteroPipelineChain` (rank
        ``s`` computes stage ``s``, GPipe microbatches) for the
        reference-shaped ``add_link`` API.  Linear means link ``i`` is
        owned by rank ``i`` and every edge goes ``i - 1 -> i`` with no
        terminal send; anything else stays on this chain's walk.  The
        checks and messages are the JAX package's; ``io_shapes`` and
        ``n_microbatches`` are :class:`HeteroPipelineChain`'s."""
        S = len(self._links)
        if self.comm.size != S:
            raise ValueError(
                f"{S} links on a size-{self.comm.size} axis: the pipeline "
                "lowering needs exactly one stage per device")
        for i, ln in enumerate(self._links):
            if ln.rank != i:
                raise ValueError(
                    f"link {i} owned by rank {ln.rank}: pipeline lowering "
                    "needs the identity placement (link i on rank i)")
            if ln.rank_in not in (None, i - 1) or (
                    i == 0 and ln.rank_in is not None):
                raise ValueError(
                    f"link {i} has rank_in={ln.rank_in}: not a linear chain")
            if ln.rank_out not in (None, i + 1) or (
                    i == S - 1 and ln.rank_out is not None):
                raise ValueError(
                    f"link {i} has rank_out={ln.rank_out}: not a linear "
                    "chain (terminal sends have no pipeline equivalent)")
        stages = [self.stages[ln.index] if ln.index is not None else None
                  for ln in self._links]
        return HeteroPipelineChain(self.comm, stages, io_shapes,
                                   n_microbatches)


# ------------------------------------------------------------- pipelines
def _flatten(tree) -> Tuple[List[Any], Callable]:
    """The leaves of a tree of dicts, lists and tuples (dict keys sorted,
    as JAX's ``tree_flatten`` orders them) and the function that rebuilds
    the tree from a list of leaves."""
    if tree is None:
        return [], lambda flat: None
    if isinstance(tree, (dict, list, tuple)):
        keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
        subs = [_flatten(tree[k]) for k in keys]
        leaves = [leaf for ls, _ in subs for leaf in ls]
        kind = type(tree)

        def rebuild(flat):
            parts, at = [], 0
            for ls, rb in subs:
                parts.append(rb(flat[at:at + len(ls)]))
                at += len(ls)
            if kind is dict:
                return dict(zip(keys, parts))
            return kind(parts)
        return leaves, rebuild
    return [tree], lambda flat: flat[0]


class _Plan(NamedTuple):
    comm: Any
    stage_fn: Callable  # stage_fn(leaves, h) -> y
    n_micro: int
    check_out: Optional[Callable]  # check_out(y) raises on a bad shape


def _run_stage(plan: _Plan, x, leaves, keep: bool):
    """This rank's part of the pipeline's forward: each microbatch in
    turn received (or cut from ``x`` on stage 0), run through the stage
    and posted on.  ``keep`` builds and returns each microbatch's graph
    ``(h, y)`` for the backward."""
    comm, M = plan.comm, plan.n_micro
    s, S = comm.rank, comm.size
    micro = x.reshape(M, x.shape[0] // M, *x.shape[1:]) if s == 0 else None
    saved = []
    with torch.set_grad_enabled(keep):
        for m in range(M):
            h = micro[m] if s == 0 else comm.recv_tensor(s - 1)[0]
            if keep:
                h = h.detach().requires_grad_(s > 0 or x.requires_grad)
            y = plan.stage_fn(leaves, h)
            if plan.check_out is not None:
                plan.check_out(y)
            if s < S - 1:
                comm.post_send(y.detach(), s + 1, wants_grad=keep)
            saved.append((h, y))
    comm.wait_pending()
    return saved


class _GPipe(torch.autograd.Function):
    """One pipeline call on this rank: the stage's output (all
    microbatches, in order) on the last stage, a zero-size delegate that
    carries the backward edge elsewhere."""

    @staticmethod
    def forward(ctx, plan, x, *params):
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        x = x.detach().requires_grad_(ctx.needs_input_grad[1])
        saved = _run_stage(plan, x, leaves, keep=True)
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        if plan.comm.rank == plan.comm.size - 1:
            return torch.cat([y.detach() for _, y in saved])
        return x.new_zeros(0)

    @staticmethod
    def backward(ctx, g):
        plan, leaves = ctx.plan, ctx.leaves
        comm = plan.comm
        s, S = comm.rank, comm.size
        want = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
        dx, at = [], 0
        # The same microbatch order on every stage: the m-th gradient on
        # each edge is microbatch m's.
        for h, y in ctx.saved:
            if s == S - 1:
                gm = g[at:at + y.shape[0]]
                at += y.shape[0]
            else:
                gm = comm.recv_tensor(s + 1)[0]
            inputs = ([h] if h.requires_grad else []) + \
                [leaves[i] for i in want]
            gs = list(torch.autograd.grad(y, inputs, gm, allow_unused=True))
            if h.requires_grad:
                gh = gs.pop(0)
                gh = torch.zeros_like(h) if gh is None else gh
                if s > 0:
                    comm.post_send(gh.contiguous(), s - 1)
                else:
                    dx.append(gh)
            for i, gi in zip(want, gs):
                if gi is not None:
                    acc[i] = gi if acc[i] is None else acc[i] + gi
        ctx.saved = None
        comm.wait_pending()
        return (None, torch.cat(dx) if dx else None, *acc)


def _pipeline(comm, stage_fn, leaves: Sequence[torch.Tensor], x,
              n_micro: int, check_out=None) -> torch.Tensor:
    """GPipe over ``comm`` (rank ``s`` runs stage ``s``); the last
    stage's output on every rank."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by microbatches "
                         f"{n_micro}")
    plan = _Plan(comm, stage_fn, int(n_micro), check_out)
    leaves = list(leaves)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in leaves)):
        y = _GPipe.apply(plan, x, *leaves)
    else:
        saved = _run_stage(plan, x, leaves, keep=False)
        y = torch.cat([y for _, y in saved]) \
            if comm.rank == comm.size - 1 else x.new_zeros(0)
    return bcast(comm, y, root=comm.size - 1)


class PipelineChain:
    """GPipe over homogeneous stages, one per rank of ``comm`` (the JAX
    package's ``PipelineChain``).

    ``stage_apply(stage_params, h) -> y`` runs one stage; ``pipe(
    stage_params, x)``, called on every rank of ``comm``, takes this
    rank's own stage parameters (a tree of tensors) and the batch ``x``
    (read on rank 0 only) and returns the last stage's output on every
    rank.  As with every differentiable collective of the port, the loss
    the gradients belong to is the sum of the ranks' losses: a loss
    computed alike on every stage rank gives each stage ``comm.size``
    times its gradient, which the gradient reduction divides out."""

    def __init__(self, stage_apply: Callable, comm, n_microbatches: int):
        self.stage_apply = stage_apply
        self.comm = comm
        self.n_micro = n_microbatches

    def __call__(self, stage_params, x):
        leaves, rebuild = _flatten(stage_params)
        return _pipeline(self.comm,
                         lambda ls, h: self.stage_apply(rebuild(ls), h),
                         leaves, x, self.n_micro)


class HeteroPipelineChain(nn.Module):
    """GPipe over HETEROGENEOUS stages, one per rank of ``comm`` (the JAX
    package's ``HeteroPipelineChain``); rank ``s`` runs only stage ``s``.

    ``stages[s]`` is either an ``nn.Module`` (built on its owner only;
    the other ranks pass None) or a function ``apply(params, x)``.
    ``io_shapes[s]`` is stage ``s``'s ``(in_shape, out_shape)`` without
    the batch axis; consecutive stages must chain, and each stage's output
    is checked against its shape.

    Calls, each made on every rank of ``comm``:

    * ``chain(x)`` -- module stages: this rank's module and its own
      parameters, the only stage parameters it holds;
    * ``chain(params_list, x)`` -- functional stages, replicated: every
      rank passes every stage's tree and uses its own;
    * :meth:`shard_params` then :meth:`apply_sharded` -- functional stages
      with each rank holding only its own stage's flat row;
      :meth:`unshard_params` gathers the rows back.

    Each returns the last stage's output ``(B, *io_shapes[-1][1])`` on
    every rank (see :class:`PipelineChain` for the gradient scale)."""

    def __init__(self, comm, stages: Sequence[Any],
                 io_shapes: Sequence[Tuple[tuple, tuple]],
                 n_microbatches: int):
        super().__init__()
        if len(stages) != len(io_shapes):
            raise ValueError(
                f"{len(stages)} stages but {len(io_shapes)} io_shapes")
        for i in range(len(stages) - 1):
            if tuple(io_shapes[i][1]) != tuple(io_shapes[i + 1][0]):
                raise ValueError(
                    f"stage {i} outputs {io_shapes[i][1]} but stage "
                    f"{i + 1} expects {io_shapes[i + 1][0]}")
        self.comm = comm
        self.io_shapes = [(tuple(a), tuple(b)) for a, b in io_shapes]
        self.n_micro = n_microbatches
        r = comm.rank
        own = stages[r] if 0 <= r < len(stages) else None
        self.stage = own if isinstance(own, nn.Module) else None
        self._apply = None if isinstance(own, nn.Module) else own
        self._shard_meta = None

    def _check_size(self) -> None:
        S = self.comm.size
        if S != len(self.io_shapes):
            raise ValueError(f"{len(self.io_shapes)} stages on a size-{S} "
                             "axis (must match)")

    def _check_out(self, y) -> None:
        s = self.comm.rank
        want = self.io_shapes[s][1]
        if tuple(y.shape[1:]) != want:
            raise ValueError(f"stage {s} returned {tuple(y.shape[1:])} per "
                             f"example but io_shapes says {want}")

    def _run(self, stage_fn, leaves, x):
        self._check_size()
        if self.comm.rank == 0 and tuple(x.shape[1:]) != \
                self.io_shapes[0][0]:
            raise ValueError(f"input {tuple(x.shape[1:])} per example but "
                             f"io_shapes says {self.io_shapes[0][0]}")
        return _pipeline(self.comm, stage_fn, leaves, x, self.n_micro,
                         self._check_out)

    def forward(self, *args):
        if len(args) == 1:
            (x,) = args
            if self.stage is None:
                raise ValueError("chain(x) runs module stages; this rank's "
                                 "stage is a function: call chain("
                                 "params_list, x)")
            names = [n for n, _ in self.stage.named_parameters()]
            module = self.stage
            return self._run(
                lambda ls, h: torch.func.functional_call(
                    module, dict(zip(names, ls)), (h,)),
                [p for _, p in self.stage.named_parameters()], x)
        params_list, x = args
        self._check_size()  # before params_list is indexed by rank
        leaves, rebuild = _flatten(params_list[self.comm.rank])
        fn = self._own_fn()
        return self._run(lambda ls, h: fn(rebuild(ls), h), leaves, x)

    def _own_fn(self) -> Callable:
        if self._apply is None:
            raise ValueError("this rank's stage is a module: call chain(x)")
        return self._apply

    # ------------------------------------------------ stage-sharded params
    def shard_params(self, params_list: Sequence[Any]) -> torch.Tensor:
        """This rank's stage parameters as one flat row ``(1, L_s)`` on
        the communicator's device, the other stages' dropped: each rank
        holds only its own stage, as the JAX package's stage-sharded stack
        puts row ``s`` on stage ``s``'s device only.  Every rank passes
        every stage's tree (host arrays or tensors) and the per-stage
        ravel structure is kept for :meth:`apply_sharded` and
        :meth:`unshard_params`.  One dtype per stage and across stages,
        as in the JAX package."""
        S = len(self.io_shapes)
        if S != self.comm.size:
            raise ValueError(
                f"{S} stages on a size-{self.comm.size} axis (must match; "
                "the sharded path places exactly one stage row per device)")
        if len(params_list) != S:
            raise ValueError(f"{len(params_list)} param trees for {S} "
                             "stages")
        shapes, dtypes, rebuilds, rows = [], [], [], []
        for i, p in enumerate(params_list):
            leaves, rb = _flatten(p)
            rebuilds.append(rb)
            arrs = [np.asarray(leaf.detach().cpu() if isinstance(
                leaf, torch.Tensor) else leaf) for leaf in leaves]
            rows.append(arrs)
            dts = sorted({str(a.dtype) for a in arrs})
            if len(dts) > 1:
                raise ValueError(
                    f"stage {i} tree mixes dtypes {dts}: stage-sharded "
                    "rows need one dtype (cast inside the stage fn)")
            shapes.append([a.shape for a in arrs])
            dtypes.append(dts[0] if dts else "float32")
        for i, dt in enumerate(dtypes):
            if dt != dtypes[0]:
                raise ValueError(
                    f"stage {i} ravels to {dt}, stage 0 to {dtypes[0]}: "
                    "stage-sharded rows need one dtype")
        mine = rows[self.comm.rank]
        row = np.concatenate([a.ravel() for a in mine]) if mine \
            else np.zeros((0,), dtypes[0])
        lens = [int(sum(int(np.prod(s)) for s in sh)) for sh in shapes]
        self._shard_meta = (lens, shapes, rebuilds)
        return torch.from_numpy(row.copy()).to(self.comm.device)[None]

    def _require_shard_meta(self):
        if self._shard_meta is None:
            raise ValueError(
                "no stage-shard metadata: call shard_params(params_list) "
                "first (it caches the per-stage ravel structure this chain "
                "needs to unravel rows inside the step)")
        return self._shard_meta

    def apply_sharded(self, row_local: torch.Tensor, x):
        """The forward from this rank's own row ``(1, L_s)`` (from
        :meth:`shard_params`): no other stage's parameters exist on this
        rank, and none move."""
        lens, shapes, rebuilds = self._require_shard_meta()
        own, rebuild = shapes[self.comm.rank], rebuilds[self.comm.rank]
        fn = self._own_fn()

        def stage_fn(ls, h):
            flat, parts, at = ls[0][0], [], 0
            for shp in own:
                n = int(np.prod(shp))
                parts.append(flat[at:at + n].reshape(shp))
                at += n
            return fn(rebuild(parts), h)
        return self._run(stage_fn, [row_local], x)

    def unshard_params(self, row_local: torch.Tensor) -> List[Any]:
        """Every stage's tree from the ranks' rows (an all-gather; call on
        every rank), as host numpy arrays: for export and inspection."""
        lens, shapes, rebuilds = self._require_shard_meta()
        Lmax = max(max(lens), 1)
        flat = row_local.detach().reshape(-1)
        padded = torch.cat([flat, flat.new_zeros(Lmax - flat.numel())])
        rows = self.comm.allgather(padded).cpu().numpy()
        out = []
        for s, shp in enumerate(shapes):
            parts, at = [], 0
            for sh in shp:
                n = int(np.prod(sh))
                parts.append(rows[s, at:at + n].reshape(sh))
                at += n
            out.append(rebuilds[s](parts))
        return out
