"""Communicators over a ``torch.distributed`` process group: the port's
counterpart of ``XlaCommunicator`` and ``DummyCommunicator``
(``chainermn_tpu/comm/xla.py``).

One process drives one card, so a rank is a process, and every array
collective takes this rank's own tensor where the JAX package takes a
rankwise array (leading axis = rank): ``allgather(x)`` returns the
``(size, ...)`` stack, ``alltoall(xs)`` sends row ``j`` of ``xs`` to rank
``j``, ``permute(x, perm)`` moves ``x`` along ``[(src, dst), ...]`` edges
(a rank with no incoming edge gets zeros), ``scatter(xs, root)`` hands
rank ``r`` row ``r`` of root's ``xs``, and ``gather(x, root)`` returns
the stack on ``root`` (None elsewhere; the JAX package hands every slot
the stack, which only SPMD needs).  ``permute`` and ``send`` post their
pairs together through ``batch_isend_irecv``: no rank blocks on a send
before its receive is posted, so cycles cannot deadlock.

The gradient all-reduce follows the reference's ``pure_nccl`` path
(SURVEY.md §2.2): every gradient goes into one flat bucket in the wire
dtype, the bucket is summed over the ranks, and each gradient gets its
slice back, cast to its own dtype and scaled by ``1 / size``.  Under
``hierarchical`` the sum runs within each host and then across hosts, and
under ``two_dimensional`` as a reduce-scatter within each host, an
all-reduce of the shard across hosts and an all-gather within each host,
whenever the job spans more than one host with more than one rank on
each; otherwise as one all-reduce.  The collective runs even on one rank,
so it is on the path the training step takes.

Groups: ``sub(axes)`` gives the communicator over the lines of the rank
grid along ``axes`` (the family of groups, this rank's one live), and
``split(color, key)`` takes per-rank sequences and returns ``{color:
communicator}``, as in the JAX package.  Both create every group of the
family on every rank, in the same order, as ``torch.distributed.new_group``
demands, so they are called on a communicator over every rank of the job.

Wire: a gloo group cannot read device memory for point-to-point and does
not promise it for the collectives, so with a gloo group (``naive``) each
CUDA tensor is staged through a pinned host buffer on the way out and
copied back to the card on the way in; NCCL takes device tensors as they
are.  The object plane (``send_obj``/``recv_obj``) rides
:class:`~chainermn_tpu_torch.hostcomm.HostComm` across processes.

Capture: :meth:`ProcessGroupCommunicator.allreduce_grad` and
:meth:`~ProcessGroupCommunicator.allreduce` read nothing back to the host
and allocate only on the card, so over NCCL they can be recorded into the
captured train step's CUDA graph; a group's NCCL communicator must exist
before the capture (the step's eager first run makes it).  Gloo runs
eagerly and cannot be captured (:attr:`capturable`).
"""

from __future__ import annotations

import contextlib
import pickle
import queue as _queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from chainermn_tpu_torch.comm import mesh as mesh_lib
from chainermn_tpu_torch.comm.base import CommunicatorBase

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "mean": dist.ReduceOp.SUM}

#: Header of a tensor sent point to point with its shape unknown to the
#: receiver: ``[ndim, dtype code, wants a gradient back, dim_0, ...]``.
_HEADER_LEN = 16

#: posted sends of communicators that were dropped before waiting for
#: them: a gloo send whose work object is freed before its receiver posts
#: the matching receive is cancelled, and the receiver then waits
#: forever.  Kept here until they complete (pruned at every post).
_ORPHANED_SENDS: List[tuple] = []
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


def _params(model):
    return list(model.parameters()) if isinstance(model, nn.Module) \
        else list(model)


class _ObjectPlane:
    """Picklable objects between communicator ranks: a local queue per
    ``(group, source, dest)`` within this process, and frames over one
    :class:`~chainermn_tpu_torch.hostcomm.HostComm` (world ranks) across
    processes, shared by a communicator and its subgroups.  Frames carry
    ``(group key, source, dest)`` and are parked per that triple, so two
    communicators of one process never take each other's frames."""

    def __init__(self):
        self._queues: Dict[tuple, _queue.SimpleQueue] = {}
        self._mu = threading.Lock()
        self._drain = threading.Lock()
        self._hostcomm = None

    def queue(self, key: tuple) -> _queue.SimpleQueue:
        with self._mu:
            return self._queues.setdefault(key, _queue.SimpleQueue())

    def hostcomm(self):
        with self._mu:
            if self._hostcomm is None:
                from chainermn_tpu_torch.hostcomm import HostComm

                self._hostcomm = HostComm.from_env_or_store()
            return self._hostcomm

    def send(self, key: tuple, obj: Any, dest_world: int) -> None:
        self.hostcomm().send_obj((key, obj), dest_world)

    def recv(self, key: tuple, source_world: int, timeout: float) -> Any:
        q = self.queue(key)
        deadline = time.monotonic() + timeout
        looked = False
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 and looked:
                raise TimeoutError(f"recv_obj{key[1:]} timed out after "
                                   f"{timeout}s")
            # A zero deadline still looks once (a poll).
            remaining, looked = max(remaining, 0.0), True
            if not self._drain.acquire(timeout=min(remaining, 0.05)):
                try:
                    return q.get(timeout=min(remaining, 0.05))
                except _queue.Empty:
                    continue
            try:
                try:
                    return q.get_nowait()
                except _queue.Empty:
                    pass
                try:
                    fkey, payload = self.hostcomm().recv_obj(
                        source_world,
                        timeout_ms=max(int(min(remaining, 0.25) * 1000), 1))
                except TimeoutError as e:
                    if getattr(e, "kind", "timeout") != "timeout":
                        raise
                    continue
                if fkey == key:
                    return payload
                self.queue(fkey).put(payload)
            finally:
                self._drain.release()


class ProcessGroupCommunicator(CommunicatorBase):
    """Collectives over ``group`` (None: the default, world group) on
    ``device``; ``allreduce_grad_dtype`` is the gradient wire dtype (cast,
    reduce, cast back), None for the gradients' own.

    ``members`` are the world ranks of the communicator in its rank order
    (default: the group's ranks), ``mesh`` its rank grid over its own
    ranks (default flat) and ``axes`` the grid axes it spans (default
    all), ``hosts`` the host of each of its ranks."""

    def __init__(self, device: torch.device, group=None,
                 allreduce_grad_dtype: Optional[torch.dtype] = None,
                 name: str = "xla", *, members: Optional[Sequence] = None,
                 mesh: Optional[mesh_lib.RankMesh] = None,
                 axes: Optional[Sequence[str]] = None,
                 hosts: Optional[Sequence] = None,
                 objects: Optional[_ObjectPlane] = None):
        self.device = torch.device(device)
        self.group = group
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.name = name
        if members is None:
            members = (range(dist.get_world_size()) if group is None
                       else dist.get_process_group_ranks(group))
        self.members: Tuple[int, ...] = tuple(int(r) for r in members)
        me = dist.get_rank()
        self._rank = (self.members.index(me) if me in self.members
                      else -1)
        self.mesh = mesh or mesh_lib.flat_mesh(len(self.members))
        if self.mesh.size != len(self.members):
            raise ValueError(f"a mesh of {self.mesh.size} ranks for a "
                             f"communicator of {len(self.members)}")
        self.axes = tuple(axes) if axes else self.mesh.axis_names
        hosts = list(hosts) if hosts is not None else \
            [0] * len(self.members)
        self.hosts = tuple(hosts)
        self._topo = mesh_lib.topology(max(self._rank, 0), hosts)
        self._objects = objects or _ObjectPlane()
        # Object-plane collectives record spans (with their per-op
        # ``seq``: the fleet trace pairs them across ranks), latched on
        # ``CMN_OBS`` here as every publisher is.
        from chainermn_tpu_torch import observability as _obs
        from chainermn_tpu_torch.observability import tracing as _tracing

        self._tracer = _tracing.tracer() if _obs.enabled() else None
        self._subs: Dict[tuple, "ProcessGroupCommunicator"] = {}
        self._pending: List[tuple] = []
        self._tags: Dict[Tuple[int, int], int] = {}
        # Group rank of each communicator rank (new_group sorts ranks).
        order = sorted(self.members)
        self._group_rank = tuple(order.index(m) for m in self.members)
        self._level_comms: Optional[tuple] = None

    # ------------------------------------------------------------- ranks
    @property
    def rank(self) -> int:
        """This process's rank in the communicator (-1 when it is not a
        member: a color of :meth:`split` this rank is not in)."""
        return self._rank

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def intra_rank(self) -> int:
        return self._topo.intra_rank

    @property
    def intra_size(self) -> int:
        return self._topo.intra_size

    @property
    def inter_rank(self) -> int:
        return self._topo.inter_rank

    @property
    def inter_size(self) -> int:
        return self._topo.inter_size

    @property
    def axis_name(self):
        """The process group of this communicator's ranks: what a model
        takes as ``axis_name`` for collectives inside its forward
        (sync-BN), as the JAX package passes its mesh axis name."""
        return dist.group.WORLD if self.group is None else self.group

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def capturable(self) -> bool:
        """Whether the communicator's collectives can be recorded into a
        CUDA graph: NCCL on a card; gloo never."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def _member(self, what: str) -> None:
        if self._rank < 0:
            raise ValueError(f"{what}: this process (world rank "
                             f"{dist.get_rank()}) is not a member of the "
                             f"communicator over {self.members}")

    def _check_rank(self, r: int, what: str) -> None:
        if not 0 <= int(r) < self.size:
            raise ValueError(f"{what} {r} out of range for communicator "
                             f"size {self.size}")

    def _world(self, r: int) -> int:
        return self.members[r]

    def _src(self, root: int) -> int:
        self._check_rank(root, "root")
        return self._world(root)

    # -------------------------------------------------------------- wire
    @property
    def _staged(self) -> bool:
        return self.backend == "gloo"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the wire takes for ``t`` (a pinned host copy of a
        card tensor under gloo, else ``t``)."""
        t = t.contiguous()
        if self._staged and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t

    def _in(self, shape, dtype, device) -> torch.Tensor:
        """A receive buffer for the wire (host under gloo)."""
        dev = torch.device(device)
        if self._staged and dev.type == "cuda":
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=dev)

    def _like(self, t: torch.Tensor, device) -> torch.Tensor:
        return t.to(device) if t.device != torch.device(device) else t

    # ------------------------------------------------------- collectives
    def allreduce_grad(self, model) -> None:
        self._member("allreduce_grad")
        params = _params(model)
        for p in params:
            if p.grad is None:  # every rank reduces the same layout
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if not grads:
            return
        wire = self.allreduce_grad_dtype or (
            grads[0].dtype if len({g.dtype for g in grads}) == 1
            else torch.float32)
        bucket = torch.cat([g.reshape(-1).to(wire) for g in grads])
        bucket = self._sum_bucket(bucket)
        size = self.size
        at = 0
        for g in grads:
            n = g.numel()
            g.copy_(bucket[at:at + n].view(g.shape).to(g.dtype) / size)
            at += n

    def _sum_bucket(self, bucket: torch.Tensor) -> torch.Tensor:
        """``bucket`` summed over the ranks: one all-reduce, or the
        host-then-job levels of ``hierarchical``/``two_dimensional``."""
        levels = self._levels()
        if levels is None:
            return self._all_reduce(bucket, dist.ReduceOp.SUM, self.group)
        intra, inter = levels
        if self.name != "two_dimensional":
            part = intra._all_reduce(bucket, dist.ReduceOp.SUM, intra.group)
            return inter._all_reduce(part, dist.ReduceOp.SUM, inter.group)
        n = intra.size
        pad = (-bucket.numel()) % n
        flat = torch.cat([bucket, bucket.new_zeros(pad)]) if pad else bucket
        shard = intra.reduce_scatter(flat.view(n, -1))
        shard = inter._all_reduce(shard, dist.ReduceOp.SUM, inter.group)
        out = intra.allgather(shard).reshape(-1)
        return out[:bucket.numel()]

    def _levels(self):
        """(intra-host, cross-host) communicators when the hierarchical
        names have both levels to run, else None (one all-reduce)."""
        if self.name not in ("hierarchical", "two_dimensional") or \
                self.axes != (mesh_lib.INTER_AXIS, mesh_lib.INTRA_AXIS):
            return None
        if self._level_comms is None:
            self._level_comms = (self.sub(mesh_lib.INTRA_AXIS),
                                 self.sub(mesh_lib.INTER_AXIS))
        intra, inter = self._level_comms
        return (intra, inter) if intra.size > 1 and inter.size > 1 else None

    def _all_reduce(self, t: torch.Tensor, op, group) -> torch.Tensor:
        w = self._out(t)
        dist.all_reduce(w, op=op, group=group)
        return self._like(w, t.device)

    def allreduce(self, x: Any, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks (``sum``/``mean``/``max``/``min``/
        ``prod``), as a new tensor on the communicator's device."""
        if op not in _OPS:
            raise ValueError(f"op={op!r}: expected one of {sorted(_OPS)}")
        self._member("allreduce")
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing() and not (
                    isinstance(x, torch.Tensor) and x.is_cuda):
            raise ValueError(
                "allreduce under a CUDA-graph capture needs a tensor on "
                f"{self.device}: a host value would be copied at capture "
                "time only")
        t = torch.as_tensor(x, device=self.device).clone()
        t = self._all_reduce(t, _OPS[op], self.group)
        return t / self.size if op == "mean" else t

    def bcast_data(self, data: Any, root: int = 0) -> Any:
        """Broadcast a module's parameters and buffers, or a tensor, from
        ``root`` in place; returns ``data``."""
        self._member("bcast_data")
        src = self._src(root)
        tensors = ([*data.parameters(), *data.buffers()]
                   if isinstance(data, nn.Module) else [data])
        with torch.no_grad():
            for t in tensors:
                w = self._out(t.data)
                dist.broadcast(w, src=src, group=self.group)
                if w is not t.data:
                    t.data.copy_(w)
        return data

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Root's ``x`` on every rank, as a new tensor (the other ranks'
        ``x`` gives the shape and dtype)."""
        self._member("broadcast")
        w = self._out(x.clone())
        dist.broadcast(w, src=self._src(root), group=self.group)
        return self._like(w, x.device)

    def reduce(self, x: torch.Tensor, root: int = 0):
        """The sum of every rank's ``x`` on ``root``; None elsewhere."""
        self._member("reduce")
        w = self._out(x.clone())
        dist.reduce(w, dst=self._src(root), op=dist.ReduceOp.SUM,
                    group=self.group)
        return self._like(w, x.device) if self.rank == root else None

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(size, ...)``."""
        self._member("allgather")
        w = self._out(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        out = torch.stack([parts[g] for g in self._group_rank])
        return self._like(out, x.device)

    @property
    def _in_group_order(self) -> bool:
        """Whether communicator rank r is group rank r (members sorted):
        the rank-ordered collectives need no permutation, and so no
        host-built index tensor (which a CUDA-graph capture refuses)."""
        return self._group_rank == tuple(range(self.size))

    def alltoall(self, xs: torch.Tensor) -> torch.Tensor:
        """Row ``j`` of ``xs`` (``(size, ...)``) goes to rank ``j``; row
        ``j`` of the result came from rank ``j``."""
        self._member("alltoall")
        if xs.shape[0] != self.size:
            raise ValueError(f"alltoall needs a leading axis of {self.size}"
                             f" rows, got {tuple(xs.shape)}")
        if self._in_group_order:
            w = self._out(xs)
            out = torch.empty_like(w)
            dist.all_to_all_single(out, w, group=self.group)
            return self._like(out, xs.device)
        order = torch.tensor(np.argsort(self._group_rank), device=xs.device)
        w = self._out(xs.index_select(0, order))
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        back = torch.tensor(self._group_rank, device=out.device)
        return self._like(out.index_select(0, back), xs.device)

    def reduce_scatter(self, xs: torch.Tensor) -> torch.Tensor:
        """Row ``r`` of the sum over the ranks of ``xs`` (``(size,
        ...)``), on rank ``r``: NCCL's reduce-scatter, or an all-to-all
        and a sum (gloo has no reduce-scatter)."""
        self._member("reduce_scatter")
        if self.backend == "nccl" and self._in_group_order:
            if xs.shape[0] != self.size:
                raise ValueError(f"reduce_scatter needs a leading axis of "
                                 f"{self.size} rows, got {tuple(xs.shape)}")
            xs = xs.contiguous()
            out = torch.empty_like(xs[0])
            dist.reduce_scatter_tensor(out, xs, group=self.group)
            return out
        return self.alltoall(xs).sum(0)

    def allgather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        """Fill ``out`` (contiguous, ``size * x.numel()`` elements) with
        every rank's ``x`` in rank order, in place: NCCL (and gloo on
        host tensors) gathers straight into it; a card tensor over gloo
        goes through :meth:`allgather` and one copy."""
        self._member("allgather_into")
        if out.numel() != self.size * x.numel() or not out.is_contiguous():
            raise ValueError(f"allgather_into needs a contiguous output of "
                             f"{self.size} x {x.numel()} elements, got "
                             f"{tuple(out.shape)}")
        if self._in_group_order and not (self._staged and x.is_cuda):
            with warnings.catch_warnings():
                # Renamed all_gather_single in newer releases.
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(out.view(-1),
                                            x.contiguous().view(-1),
                                            group=self.group)
            return
        out.view(self.size, -1).copy_(
            self.allgather(x).reshape(self.size, -1))

    def gather(self, x: torch.Tensor, root: int = 0):
        """Every rank's ``x`` stacked in rank order on ``root``; None on
        the other ranks."""
        self._member("gather")
        src = self._src(root)
        w = self._out(x)
        parts = ([torch.empty_like(w) for _ in range(self.size)]
                 if self.rank == root else None)
        dist.gather(w, parts, dst=src, group=self.group)
        if self.rank != root:
            return None
        return self._like(torch.stack([parts[g] for g in self._group_rank]),
                          x.device)

    def scatter(self, xs: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Row ``r`` of root's ``xs`` (``(size, ...)``) on rank ``r``;
        every rank passes ``xs`` of that shape (only root's is read)."""
        self._member("scatter")
        src = self._src(root)
        w = self._out(xs)
        out = torch.empty_like(w[0])
        parts = ([w[self.members.index(sorted(self.members)[g])]
                  for g in range(self.size)] if self.rank == root else None)
        dist.scatter(out, parts, src=src, group=self.group)
        return self._like(out, xs.device)

    # ------------------------------------------------------ point to point
    def _tag(self, src: int, dst: int) -> int:
        """The next tag of the (src, dst) edge: both ends count the
        edge's messages, so a message matches its partner by tag whatever
        order the ends post them in."""
        n = self._tags.get((src, dst), 0)
        self._tags[(src, dst)] = n + 1
        return n % (1 << 30)

    def _op(self, kind, t: torch.Tensor, peer: int, tag: int):
        return dist.P2POp(dist.isend if kind == "send" else dist.irecv, t,
                          self._world(peer), self.group, tag)

    def permute(self, x: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``x`` moved along ``perm`` (``[(src, dst), ...]``, each dst at
        most once); a rank with no incoming edge gets zeros.  Every rank's
        sends and receives are posted together and then waited on."""
        self._member("permute")
        perm = [(int(s), int(d)) for s, d in perm]
        for s, d in perm:
            self._check_rank(s, "source")
            self._check_rank(d, "dest")
        dsts = [d for _, d in perm]
        if len(set(dsts)) != len(dsts):
            raise ValueError(f"permute: a destination appears twice in "
                             f"{perm}")
        self.wait_pending()
        me = self.rank
        out = torch.zeros_like(x)
        ops, recv = [], None
        for s, d in perm:
            if s == me and d == me:
                out = x.clone()
            elif s == me:
                ops.append(self._op("send", self._out(x), d,
                                    self._tag(s, d)))
            elif d == me:
                recv = self._in(x.shape, x.dtype, x.device)
                ops.append(self._op("recv", recv, s, self._tag(s, d)))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        if recv is not None:
            out = self._like(recv, x.device)
        return out

    def send(self, x: torch.Tensor, dest: int, source: int) -> torch.Tensor:
        """One edge ``source -> dest`` as a permute (every rank calls
        it): ``x`` of ``source`` on ``dest``, zeros elsewhere."""
        return self.permute(x, [(source, dest)])

    def post_send(self, x: torch.Tensor, dest: int,
                  wants_grad: bool = False) -> None:
        """Post ``x`` (a header with its shape, its dtype and
        ``wants_grad`` first) to rank ``dest`` without waiting; the
        receiver reads it with :meth:`recv_tensor`.  The send completes in
        the background (also after this communicator is dropped);
        :meth:`wait_pending` waits for every send posted so far."""
        self._member("post_send")
        self._check_rank(dest, "dest")
        me = self.rank
        if dest == me:
            raise ValueError("post_send to this rank itself")
        if x.dtype not in _DTYPES or x.dim() > _HEADER_LEN - 3:
            raise ValueError(f"cannot send a {x.dim()}-D {x.dtype} tensor")
        head = torch.zeros(_HEADER_LEN, dtype=torch.int64)
        head[0], head[1] = x.dim(), _DTYPES.index(x.dtype)
        head[2] = int(wants_grad)
        head[3:3 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        if not self._staged and x.is_cuda:
            head = head.to(x.device)
        data = self._out(x)
        ops = [self._op("send", head, dest, self._tag(me, dest)),
               self._op("send", data, dest, self._tag(me, dest))]
        works = dist.batch_isend_irecv(ops)
        self._pending.append((works, head, data))
        _ORPHANED_SENDS[:] = [p for p in _ORPHANED_SENDS
                              if not all(w.is_completed() for w in p[0])]

    def recv_tensor(self, source: int, device=None
                    ) -> Tuple[torch.Tensor, bool]:
        """The next tensor :meth:`post_send` sent from rank ``source``, on
        ``device`` (default: the communicator's), and whether its sender
        wants a gradient back."""
        self._member("recv_tensor")
        self._check_rank(source, "source")
        me = self.rank
        dev = torch.device(device) if device is not None else self.device
        head = self._in((_HEADER_LEN,), torch.int64, dev)
        w = dist.batch_isend_irecv(
            [self._op("recv", head, source, self._tag(source, me))])
        for x in w:
            x.wait()
        head = head.cpu()
        nd, code, wants = int(head[0]), int(head[1]), bool(head[2])
        shape = tuple(int(v) for v in head[3:3 + nd])
        buf = self._in(shape, _DTYPES[code], dev)
        w = dist.batch_isend_irecv(
            [self._op("recv", buf, source, self._tag(source, me))])
        for x in w:
            x.wait()
        return self._like(buf, dev), wants

    def wait_pending(self) -> None:
        """Wait for every send :meth:`post_send` posted."""
        pending, self._pending = self._pending, []
        for works, _, _ in pending:
            for w in works:
                w.wait()

    def __del__(self):
        # A dropped communicator's sends stay in flight (its receivers may
        # post their receives later).
        pending = getattr(self, "_pending", None)
        if pending:
            _ORPHANED_SENDS.extend(pending)

    # ---------------------------------------------------------- objects
    def _span(self, op: str):
        tr = getattr(self, "_tracer", None)
        return tr.span(op) if tr is not None else contextlib.nullcontext()

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        self._member("bcast_obj")
        box = [obj]
        with self._span("bcast_obj"):
            dist.broadcast_object_list(box, src=self._src(root),
                                       group=self.group,
                                       device=self.device
                                       if self.backend == "nccl" else None)
        return box[0]

    def allgather_obj(self, obj: Any) -> List[Any]:
        self._member("allgather_obj")
        out: List[Any] = [None] * self.size
        with self._span("allgather_obj"):
            dist.all_gather_object(out, obj, group=self.group)
        return [out[g] for g in self._group_rank]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        # Over all_gather_object, as the JAX package's XlaCommunicator
        # does: NCCL has no object gather to a root.
        with self._span("gather_obj"):
            objs = self.allgather_obj(obj)
        return objs if self.rank == root else None

    def allreduce_obj(self, obj, op: str = "sum"):
        with self._span("allreduce_obj"):
            return super().allreduce_obj(obj, op)

    def connect_object_plane(self) -> None:
        """Join the cross-process object plane now.  Its transport builds
        one mesh of every world rank at first use, so a rank that sends or
        receives objects waits for every other rank to join: a collective
        phase in which only some ranks exchange objects calls this on
        every rank first."""
        if len(self.members) > 1:
            self._objects.hostcomm()

    def _key(self, source: int, dest: int) -> tuple:
        return (self.members, int(source), int(dest))

    def send_obj(self, obj: Any, dest: int,
                 source: Optional[int] = None, op: str = "send_obj") -> None:
        """Send a picklable object to rank ``dest`` (reference anchor
        ``MpiCommunicatorBase.send_obj``); delivery matches on the exact
        ``(source, dest)`` pair and is FIFO per pair.  ``source`` is this
        rank (an explicit other rank raises: one process speaks for its
        own rank only).  ``op`` (the caller's operation, a label on
        ``HostComm``'s spans) is not recorded here."""
        src = self.rank if source is None else int(source)
        self._check_rank(src, "source")
        self._check_rank(dest, "dest")
        if src != self.rank:
            raise ValueError(f"send_obj(source={src}) from rank "
                             f"{self.rank}: a process sends as itself")
        key = self._key(src, dest)
        if dest == self.rank:
            self._objects.queue(key).put(pickle.loads(pickle.dumps(obj)))
            return
        self._objects.send(key, obj, self._world(dest))

    def recv_obj(self, source: int, dest: Optional[int] = None,
                 timeout: float = 60.0, timeout_ms: Optional[int] = None,
                 op: str = "recv_obj") -> Any:
        """The next object rank ``source`` sent to this rank; raises
        :class:`TimeoutError` after ``timeout`` seconds (``timeout_ms``
        milliseconds where given, as ``HostComm`` takes it) instead of
        deadlocking a wedged job.  ``op`` is as in :meth:`send_obj`."""
        if timeout_ms is not None:
            timeout = timeout_ms / 1e3
        dst = self.rank if dest is None else int(dest)
        self._check_rank(source, "source")
        self._check_rank(dst, "dest")
        if dst != self.rank:
            raise ValueError(f"recv_obj(dest={dst}) on rank {self.rank}: a "
                             "process receives as itself")
        key = self._key(source, dst)
        if source == self.rank:
            try:
                return self._objects.queue(key).get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(f"recv_obj(source={source}, dest={dst}) "
                                   f"timed out after {timeout}s") from None
        return self._objects.recv(key, self._world(source), timeout)

    def barrier(self) -> None:
        self._member("barrier")
        with self._span("barrier"):
            dist.barrier(group=self.group)

    # -------------------------------------------------------- structuring
    def _family(self, lines: Sequence[Sequence[int]], axes, mesh,
                name: str) -> "ProcessGroupCommunicator":
        """This rank's communicator of a family of disjoint groups, each
        given by its communicator ranks: every group is created on every
        rank, in order."""
        if len(self.members) != dist.get_world_size():
            raise ValueError(
                "sub/split create a group for every line on every rank of "
                "the job (torch.distributed.new_group), so call them on a "
                "communicator over every rank, not on a subgroup")
        mine = None
        for line in lines:
            world = [self.members[r] for r in line]
            if sorted(world) == sorted(self.members):
                group = self.group
            else:
                backend = self.backend
                group = dist.new_group(world, backend=backend)
            if self.rank in line:
                mine = (line, group)
        line, group = mine if mine is not None else (lines[0], None)
        return type(self)(self.device, group,
                          allreduce_grad_dtype=self.allreduce_grad_dtype,
                          name=name,
                          members=[self.members[r] for r in line],
                          mesh=mesh, axes=axes,
                          hosts=[self.hosts[r] for r in line],
                          objects=self._objects)

    def sub(self, axes) -> "ProcessGroupCommunicator":
        """The communicator over this rank's line of the grid along
        ``axes`` (the idiomatic form of the reference's ``split`` for
        hybrid grids): ``comm.sub("data")`` on ``hybrid_mesh({"data": D,
        "model": S})`` spans the D ranks that share this rank's model
        position."""
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        self._member("sub")
        if axes not in self._subs:
            lines = self.mesh.lines(axes)
            shape = [self.mesh.shape[a] for a in axes]
            # The sub's grid keeps its axes, over its own ranks.
            sub_mesh = mesh_lib.RankMesh(
                np.arange(lines.shape[1]).reshape(shape), axes)
            self._subs[axes] = self._family(
                [list(map(int, ln)) for ln in lines], axes, sub_mesh,
                self.name)
        return self._subs[axes]

    def split(self, color, key=None) -> Dict[Any, "ProcessGroupCommunicator"]:
        """MPI_Comm_split with the JAX package's shape: ``color`` and
        ``key`` are per-rank sequences (length ``size``, every rank passes
        the same), and the result is ``{color: communicator}`` over each
        color's ranks ordered by ``(key, rank)``.  The communicators of
        colors this rank is not in have ``rank == -1`` and raise on use."""
        self._member("split")
        colors = list(color)
        if len(colors) != self.size:
            raise ValueError("color must have one entry per rank")
        keys = list(key) if key is not None else list(range(self.size))
        groups: Dict[Any, List[Tuple[Any, int]]] = {}
        for r, (c, k) in enumerate(zip(colors, keys)):
            groups.setdefault(c, []).append((k, r))
        out = {}
        for c, members in groups.items():
            line = [r for _, r in sorted(members)]
            out[c] = self._family(
                [line], (mesh_lib.DATA_AXIS,),
                mesh_lib.flat_mesh(len(line)), self.name)
        return out


class DummyCommunicator(ProcessGroupCommunicator):
    """Identity gradient reduction (each rank keeps its own gradients):
    the communication-cost ablation of the JAX package.  Benchmarking
    only."""

    def allreduce_grad(self, model) -> None:
        for p in _params(model):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
