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
autograd visits a rank's nodes in.  The JAX package's ``PipelineChain``
and ``HeteroPipelineChain`` are not ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Union

import torch.nn as nn

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
