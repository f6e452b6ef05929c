"""Rank-side bodies of the port's multi-rank CPU tests.

Each function runs on every rank of a gloo job started by
``torch_ranks.run_ranks`` and returns a dict of plain numbers and numpy
arrays, which :func:`run` saves for the test process; the tests hold the
results against the JAX package on the same seeded inputs.  This module
imports torch, numpy and the port only.
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch import functions as F


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _grad_of(fn, x):
    """``fn(x_leaf)`` on a leaf copy of ``x``, its backward, and the
    leaf's gradient (every rank backprops its own output)."""
    leaf = torch.as_tensor(x, dtype=torch.float32).clone().requires_grad_()
    out = fn(leaf)
    out.backward()
    return _np(leaf.grad)


# ------------------------------------------------------------ collectives
def collectives():
    from chainermn_tpu_torch.comm import (
        create_communicator,
        hybrid_mesh,
        ragged_allreduce,
        ragged_permute,
        ragged_send,
    )

    # NCCL's one-rank-per-card check, with every rank naming one card,
    # runs before any group exists: the refused ranks have none, and the
    # gloo group made next is their default group.
    import chainermn_tpu_torch.comm as cm

    device_key = cm._device_key
    cm._device_key = lambda dev: "GPU-same-card"
    res = {}
    try:
        cm._check_one_rank_per_card(torch.device("cuda", 0), 10_000)
        res["same_card"] = "no error"
    except ValueError as e:
        res["same_card"] = str(e)
    finally:
        cm._device_key = device_key
    res["group_after_refusal"] = dist.is_initialized()

    comm = create_communicator("naive", device="cpu")
    res["default_backend"] = dist.get_backend()
    dist.barrier()
    r, n = comm.rank, comm.size
    res.update(rank=r, size=n)

    def mean_grads(c):
        w = torch.nn.Parameter(torch.zeros(4, 3))
        b = torch.nn.Parameter(torch.zeros(5))
        w.grad = torch.full((4, 3), float(r + 1))
        b.grad = torch.arange(5, dtype=torch.float32) * (r + 1)
        c.allreduce_grad([w, b])
        return _np(w.grad), _np(b.grad)

    hosts = ["h0", "h0", "h1", "h1"]
    for name in ("xla", "naive", "hierarchical", "two_dimensional",
                 "dummy"):
        two_level = name in ("hierarchical", "two_dimensional")
        c = create_communicator(name, device="cpu",
                                hosts=hosts if two_level else None)
        res[f"grad_{name}"] = mean_grads(c)
        res[f"topo_{name}"] = (c.intra_rank, c.intra_size, c.inter_rank,
                               c.inter_size)
        if two_level:
            res[f"levels_{name}"] = (c.sub("intra").members,
                                     c.sub("inter").members)
    wire = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype="bfloat16")
    p = torch.nn.Parameter(torch.zeros(8, 8))
    p.grad = torch.full((8, 8), float(r))
    wire.allreduce_grad([p])
    res["grad_bf16"] = _np(p.grad)

    x = torch.tensor([float(r)])
    res["allreduce"] = {op: _np(comm.allreduce(x, op=op))
                        for op in ("sum", "mean", "max", "min")}
    for root in (0, 3):
        t = torch.full((2, 2), float(r + 10))
        res[f"bcast_data_{root}"] = _np(comm.bcast_data(t, root=root))
    res["alltoall"] = _np(comm.alltoall(
        torch.tensor([[r * 10.0 + j] for j in range(n)])))
    res["allgather"] = _np(comm.allgather(torch.tensor([r, -r],
                                                       dtype=torch.float32)))
    res["gather"] = _np(comm.gather(torch.tensor([r, 2.0 * r]), root=2))
    rows = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    res["scatter"] = _np(comm.scatter(rows if r == 2 else
                                      torch.zeros_like(rows), root=2))
    res["permute"] = _np(comm.permute(torch.tensor([r + 1.0]),
                                      [(0, 3), (3, 0)]))
    res["send"] = _np(comm.send(torch.tensor([r + 1.0]), dest=2, source=1))
    res["reduce"] = _np(comm.reduce(torch.tensor([r + 1.0]), root=1))

    subs = comm.split([q % 2 for q in range(n)], key=[-q for q in range(n)])
    res["split"] = {c: (s.members, s.rank) for c, s in subs.items()}
    mine = subs[r % 2]
    res["split_sum"] = _np(mine.allreduce(torch.tensor([mine.rank * 1.0])))
    try:
        subs[1 - r % 2].allreduce(torch.zeros(1))
        res["split_other"] = "no error"
    except ValueError as e:
        res["split_other"] = str(e)

    grid = create_communicator("xla", device="cpu",
                               mesh=hybrid_mesh({"data": 2, "model": 2}))
    d, m = grid.sub("data"), grid.sub("model")
    res["grid"] = (d.members, d.rank, m.members, m.rank)
    res["grid_sum"] = (_np(d.allreduce(torch.tensor([r * 1.0]))),
                       _np(m.allreduce(torch.tensor([r * 1.0]))))

    # Object plane across processes (HostComm from the launcher's env).
    comm.send_obj({"from": r, "data": np.arange(3) + r}, dest=(r + 1) % n)
    got = comm.recv_obj(source=(r - 1) % n)
    res["ring_obj"] = (got["from"], int(got["data"].sum()))
    if r == 1:
        for msg in ("a", "b"):
            comm.send_obj(f"from-1-{msg}", dest=3)
    if r == 2:
        comm.send_obj("from-2", dest=3)
    if r == 3:
        res["fifo"] = [comm.recv_obj(source=2), comm.recv_obj(source=1),
                       comm.recv_obj(source=1)]
    comm.send_obj(("self", r), dest=r)
    res["self_obj"] = comm.recv_obj(source=r)
    t0 = time.monotonic()
    try:
        comm.recv_obj(source=(r + 1) % n, timeout=0.2)
        res["timeout"] = "no error"
    except TimeoutError:
        res["timeout"] = time.monotonic() - t0
    for call in (lambda: comm.send_obj(1, dest=n),
                 lambda: comm.recv_obj(source=-1)):
        try:
            call()
        except ValueError as e:
            res.setdefault("range", []).append(str(e))

    # Differentiable collectives: forward and each rank's input gradient.
    xs = torch.tensor([[100.0 * r + j] for j in range(n)])
    y = F.alltoall(comm, xs)
    res["f_alltoall"] = _np(y)
    res["g_alltoall"] = _grad_of(
        lambda v: F.alltoall(comm, v).sum() * float(r == 3), xs)
    v = torch.tensor([float(r), 1.0 + r])
    res["f_allgather"] = _np(F.allgather(comm, v))
    res["g_allgather"] = _grad_of(
        lambda t: (F.allgather(comm, t) * torch.arange(
            2.0 * n).reshape(n, 2) * (r + 1)).sum(), v)
    for op in ("sum", "mean"):
        res[f"f_allreduce_{op}"] = _np(F.allreduce(comm, v, op=op))
        res[f"g_allreduce_{op}"] = _grad_of(
            lambda t: (F.allreduce(comm, t, op=op) * (r + 1.0)).sum(), v)
    b = torch.tensor([r + 1.0])
    res["f_bcast"] = _np(F.bcast(comm, b if r == 2 else None, root=2))
    res["g_bcast"] = _grad_of(lambda t: F.bcast(comm, t, root=2).sum(), b)
    out = F.gather(comm, v, root=0)
    res["f_gather"] = _np(out)
    res["g_gather"] = _grad_of(
        lambda t: (F.gather(comm, t, root=0) *
                   (torch.arange(2.0 * n).reshape(n, 2) if r == 0 else 1.0)
                   ).sum(), v)
    rows = torch.arange(2.0 * n).reshape(n, 2)
    res["f_scatter"] = _np(F.scatter(comm, rows if r == 0 else None,
                                     root=0))
    res["g_scatter"] = _grad_of(
        lambda t: (F.scatter(comm, t, root=0) * (r + 1.0)).sum(), rows)

    # Ragged rows (the JAX tests' seeded shapes).
    rng = np.random.RandomState(0)
    ragged = [rng.normal(size=(7 + 13 * q, 3)).astype(np.float32)
              for q in range(n)]
    res["ragged_ring"] = _np(ragged_permute(
        comm, ragged[r], [(q, (q + 1) % n) for q in range(n)],
        bucket_width=32))
    res["ragged_edge"] = _np(ragged_permute(
        comm, np.full((5,), float(r), np.float32), [(0, 1)],
        bucket_width=16))
    payload = np.arange(37, dtype=np.int32)
    res["ragged_send"] = _np(ragged_send(
        comm, payload if r == 1 else payload[:0], dest=3, source=1,
        bucket_width=16))
    hist = np.bincount(rng.randint(0, 4 + 3 * r, size=50 + r))
    res["ragged_hist"] = hist
    res["ragged_allreduce"] = _np(ragged_allreduce(comm, hist,
                                                   bucket_width=8))
    bad = np.zeros((4, 3 if r != 1 else 2), np.float32)
    try:
        ragged_permute(comm, bad, [(0, 1)])
        res["ragged_bad"] = "no error"
    except ValueError as e:
        res["ragged_bad"] = str(e)

    comm.barrier()
    return res


# --------------------------------------------------------- point to point
def p2p():
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("naive", device="cpu")
    r, n = comm.rank, comm.size
    res = {}
    x = torch.tensor([[r + 1.0]])
    d = F.send(x, comm, rank=3, rank_src=1)
    res["spmd_fwd"] = _np(F.recv(comm, rank=1, delegate_variable=d))

    def spmd_loss(t):
        d = F.send(t * 2.0, comm, rank=3, rank_src=0)
        h = F.recv(comm, rank=0, delegate_variable=d)
        return h.sum() * float(r == 3)

    res["spmd_grad"] = _grad_of(spmd_loss, torch.ones(1, 3))
    try:
        F.recv(comm, rank=2, delegate_variable=d)
    except ValueError as e:
        res["spmd_wrong_src"] = str(e)
    d = F.send(torch.ones(1, 2), comm, rank=1, rank_src=0)
    res["pseudo"] = _np(F.pseudo_connect(d, torch.ones(1, 2) * 3.0))
    res["shift_nowrap"] = _np(F.shift(torch.tensor([float(r)]), comm,
                                      offset=1, wrap=False))
    res["shift_grad"] = _grad_of(
        lambda t: (F.shift(t, comm, offset=1) * (r + 1.0)).sum(),
        torch.tensor([float(r)]))

    # MPMD: rank 0 sends 2x to rank 3, rank 3's loss is sum(h**2); rank 0
    # receives the gradient through its delegate.
    v = torch.tensor([[r + 0.5, -1.0]], requires_grad=True)
    if r == 0:
        dd = F.send(v * 2.0, comm, rank=3)
        res["mpmd_delegate"] = tuple(dd.data.shape)
        dd.data.sum().backward()
    elif r == 3:
        h = F.recv(comm, rank=0)
        res["mpmd_recv"] = _np(h)
        (h ** 2).sum().backward()
    res["mpmd_grad"] = _np(v.grad)

    # A 3-stage backward that would deadlock with blocking pairs: the
    # wrapped shift on ranks 0-2 (every rank sends its gradient to its
    # left neighbour and receives from its right one), done by the port
    # and by a blocking send-then-receive on a gloo group with a 3 s
    # timeout.
    ring = comm.split([0, 0, 0, 1])[0]
    if r < 3:
        res["ring_grad"] = _grad_of(
            lambda t: (F.shift(t, ring, offset=1) * (r + 1.0)).sum(),
            torch.tensor([float(r)]))
    import datetime

    slow = dist.new_group([0, 1, 2], backend="gloo",
                          timeout=datetime.timedelta(seconds=3))
    if r < 3:
        t0 = time.monotonic()
        g = torch.full((1 << 16,), float(r))
        try:
            dist.send(g, (r - 1) % 3, group=slow)
            dist.recv(g, (r + 1) % 3, group=slow)
            res["blocking"] = "completed"
        except RuntimeError as e:
            res["blocking"] = ("deadlock", time.monotonic() - t0,
                               str(e)[:200])
    return res


# ------------------------------------------------------------ chain list
def chain():
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.links import MultiNodeChainList

    comm = create_communicator("naive", device="cpu")
    r = comm.rank
    res = {}
    rng = np.random.RandomState(0)
    w0 = rng.normal(size=(4, 8)).astype(np.float32) * 0.5
    w1 = rng.normal(size=(8, 8)).astype(np.float32) * 0.5
    w2 = rng.normal(size=(8, 2)).astype(np.float32) * 0.5
    x = rng.normal(size=(16, 4)).astype(np.float32)

    class Tanh(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(w))

        def forward(self, h):
            return torch.tanh(h @ self.w)

    built = []

    def factory(w):
        def make():
            built.append(w.shape)
            return Tanh(w)
        return make

    c3 = MultiNodeChainList(comm)
    c3.add_link(factory(w0), rank=0, rank_in=None, rank_out=1)
    c3.add_link(factory(w1), rank=1, rank_in=0, rank_out=2)
    c3.add_link(factory(w2), rank=2, rank_in=1, rank_out=None)
    res["built"] = built[:]
    res["n_params"] = sum(p.numel() for p in c3.parameters())
    y = c3(torch.tensor(x))
    # Every rank hands the broadcast its chain output: on ranks 0 and 1
    # the delegate, whose backward receives their stages' gradients.
    out = F.bcast(comm, y, root=2)
    res["chain3"] = _np(out)
    res["chain3_local"] = None if y is None else tuple(y.shape)
    (out ** 2).sum().backward()
    res["chain3_grads"] = {n: _np(p.grad) for n, p in c3.named_parameters()}

    # 0 -> 3, gradients through the bcast of the last link's output.
    rng = np.random.RandomState(1)
    v0 = rng.normal(size=(4, 6)).astype(np.float32) * 0.5
    v1 = rng.normal(size=(6, 3)).astype(np.float32) * 0.5
    xx = rng.normal(size=(8, 4)).astype(np.float32)
    c2 = MultiNodeChainList(comm)
    c2.add_link(Tanh(v0) if r == 0 else None, rank=0, rank_in=None,
                rank_out=3)
    c2.add_link(Tanh(v1) if r == 3 else None, rank=3, rank_in=0,
                rank_out=None)
    y = F.bcast(comm, c2(torch.tensor(xx)), root=3)
    (y ** 2).sum().backward()
    res["chain2_grads"] = {n: _np(p.grad) for n, p in c2.named_parameters()}

    # Four stages that revisit ranks (0 -> 1 -> 0 -> 2, output back on
    # rank 1): rank 0 sends, then receives, then sends again.
    ws = [np.random.RandomState(10 + i).normal(size=(4, 4)).astype(
        np.float32) * 0.6 for i in range(4)]
    owners = [0, 1, 0, 2]
    c4 = MultiNodeChainList(comm)
    for i, (w, o) in enumerate(zip(ws, owners)):
        c4.add_link(Tanh(w) if o == r else None, rank=o,
                    rank_in=owners[i - 1] if i else None,
                    rank_out=owners[i + 1] if i < 3 else 1)
    y = c4(torch.tensor(x))
    loss = (y ** 2).sum() if r == 1 else y.sum() if y is not None else None
    if loss is not None:
        loss.backward()
    res["chain4_out"] = _np(y) if r == 1 else None
    res["chain4_grads"] = {n: _np(p.grad) for n, p in c4.named_parameters()}
    comm.barrier()
    return res


# ------------------------------------------------------------------- VGG
VGG = dict(cfg="vgg11", num_classes=5, n_stages=4, width_mult=1 / 16)


def vgg():
    """The JAX test's narrow VGG-11 over a 1 × 4 grid: logits and loss of
    the chain, then two SGD-momentum steps of the twin's training step
    from the bridged parameters; returns this rank's stage."""
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.models import (
        build_chain,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )
    from chainermn_tpu_torch.utils import (
        vgg_stage_params_from_flax,
        vgg_stage_params_to_flax,
    )

    with open(_VGG_IN, "rb") as f:
        inputs = pickle.load(f)
    comm = create_communicator("naive", device="cpu",
                               mesh=hybrid_mesh({"data": 1, "model": 4}))
    dcomm, mcomm = comm.sub("data"), comm.sub("model")
    r, S = mcomm.rank, mcomm.size
    modules = vgg_stage_modules(**VGG, device="cpu", stages=[r])
    modules[r].load_state_dict(vgg_stage_params_from_flax(
        inputs["params"][r], device="cpu"))
    chain = build_chain(modules, mcomm)
    x, y = inputs["x"], inputs["y"]
    logits = F.bcast(mcomm, chain(torch.tensor(x)), root=S - 1)
    loss, _ = vgg_loss(logits, y)
    res = {"logits": _np(logits), "loss": float(loss)}

    def loss_fn(model, batch):
        logits = F.bcast(mcomm, model(torch.tensor(batch[0])), root=S - 1)
        return vgg_loss(logits, batch[1])[0]

    opt = create_multi_node_optimizer(
        sgd(inputs["lr"], momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init(chain)
    step = opt.make_train_step(loss_fn)
    res["losses"] = [float(step(state, (x, y))[1]["loss"]) for _ in range(2)]
    res["params"] = vgg_stage_params_to_flax(
        dict(chain.stages[0].named_parameters()))
    comm.barrier()
    return res


_VGG_IN = None


# ------------------------------------------------------------- host comm
class _NoPeers:
    """A one-rank transport: a detector over it never sees a death."""

    rank, size = 0, 1


def hostcomm():
    from chainermn_tpu_torch.hostcomm import HostComm
    from chainermn_tpu_torch.resilience import FailureDetector

    hc = HostComm(timeout_ms=20000)
    r, n = hc.rank, hc.size
    res = {}
    hc.send_obj({"from": r, "data": np.arange(3) + r}, (r + 1) % n)
    got = hc.recv_obj((r - 1) % n)
    res["ring"] = (got["from"], int(got["data"].sum()))
    hc.barrier()
    root = 2 % n
    res["bcast"] = hc.bcast_obj({"payload": "hello", "rank": r}
                                if r == root else None, root=root)
    res["gather"] = hc.gather_obj(r * 10, root=0)
    res["allgather"] = hc.allgather_obj((r, r ** 2))
    res["allreduce"] = hc.allreduce_obj(r + 1, lambda a, b: a + b)
    if r < 2:  # multi-megabyte frames, ranks 0 and 1
        blob = np.random.RandomState(7).bytes(8 << 20)
        if r == 0:
            hc.send_obj(blob, 1)
            res["big_echo"] = hc.recv_obj(1) == blob
        else:
            hc.send_obj(hc.recv_obj(0), 0)
    if r == 0:
        t0 = time.monotonic()
        try:
            hc.recv_obj(1, timeout_ms=200)
            res["timeout"] = "no error"
        except TimeoutError as e:
            res["timeout"] = (type(e).__name__, e.peer, e.op, e.kind,
                              time.monotonic() - t0)
        hc.send_obj("done", 1)
    elif r == 1:
        res["late"] = hc.recv_obj(0)
    # A detector that watches no peer: the waits are now sliced by its
    # interval and keep their deadline.
    FailureDetector(_NoPeers(), interval_s=0.05).attach(hc)
    if r == 0:
        t0 = time.monotonic()
        try:
            hc.recv_obj(1, timeout_ms=200)
            res["detector"] = "no error"
        except TimeoutError as e:
            res["detector"] = (type(e).__name__, e.peer, e.op, e.kind,
                               time.monotonic() - t0)
        hc.send_obj("done", 1)
    elif r == 1:
        res["detector"] = hc.recv_obj(0)
    res["migration"] = _migrate(hc)
    hc.barrier()
    hc.close()
    return res


def _migrate(hc):
    """One decode-ready slot moved from rank 0's engine to rank 1's
    through a ``MigrationTransport`` over this ``HostComm``; each side
    returns the bytes of the slot's blocks (sent, installed)."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import (
        DecodeEngine,
        MigrationTransport,
        Request,
        Scheduler,
        disagg,
    )

    if hc.rank > 1:
        return None
    model = TransformerLM(vocab=64, n_layers=1, d_model=32, n_heads=2,
                          d_ff=64, max_len=64, dtype=torch.float32,
                          device="cpu", seed=0)
    sched = Scheduler(DecodeEngine(model, capacity=2, num_blocks=12,
                                   block_len=8, prefill_chunk=8,
                                   device="cpu"))
    tr = MigrationTransport(hc)
    if hc.rank == 0:
        sched.submit(Request(id=7, prompt=list(range(1, 20)),
                             max_new_tokens=4))
        for _ in range(64):
            while sched._try_admit():
                pass
            sched._prefill_round()
            live = [s for s in sched._slots if s is not None]
            if live and all(not s.prefilling for s in live):
                break
        sent = [_block_bytes(sched.engine, b) for b in live[0].blocks]
        disagg.migrate_slots(sched, tr, 1, live)
        tr.send_eof(1)
        return {"blocks": sent, "pos": int(live[0].pos)}
    body = tr.recv(0, timeout_ms=60000)["body"]
    installed = disagg.install_payload(sched, body)[0]
    slot = next(s for s in sched._slots if s is not None)
    return {"blocks": [_block_bytes(sched.engine, b) for b in slot.blocks],
            "pos": int(slot.pos), "installed": installed,
            "eof": tr.recv(0, timeout_ms=60000)["kind"]}


def _block_bytes(engine, block):
    data = engine.read_block(block)
    return b"".join(layer[k].tobytes() for layer in data["target"]
                    for k in sorted(layer))


# ------------------------------------------------------------ on a card
def card_pair():
    """Two ranks on ``cuda:0``: the NCCL names refuse them before any
    group exists, so the default group of the ``naive`` communicator that
    follows is gloo and works; it stages card tensors through host
    memory."""
    from chainermn_tpu_torch.comm import create_communicator

    dev = torch.device("cuda", 0)
    res = {}
    try:
        create_communicator("xla", device=dev)
        res["nccl"] = "no error"
    except ValueError as e:
        res["nccl"] = str(e)
    comm = create_communicator("naive", device=dev)
    res["default_backend"] = dist.get_backend()
    dist.barrier()  # the refusal left no broken NCCL group behind
    r = comm.rank
    x = torch.tensor([r + 1.0, -r], device=dev)
    outs = {"allgather": comm.allgather(x),
            "permute": comm.permute(x, [(0, 1), (1, 0)]),
            "alltoall": comm.alltoall(torch.stack([x, 10 * x])),
            "broadcast": comm.broadcast(x, 1),
            "allreduce": comm.allreduce(x)}
    res["devices"] = sorted({t.device.type for t in outs.values()})
    res.update({k: _np(t) for k, t in outs.items()})
    v = torch.tensor([[0.5 + r, -1.0]], device=dev, requires_grad=True)
    if r == 0:
        F.send(v * 2.0, comm, rank=1).data.sum().backward()
    else:
        (F.recv(comm, rank=0) ** 2).sum().backward()
    res["p2p_grad"] = _np(v.grad)
    comm.barrier()
    return res


# ----------------------------------------------------------- dispatcher
# ------------------------------------------------------------ pipelines
_INPUTS = None


def _inputs():
    with open(_INPUTS, "rb") as f:
        return pickle.load(f)


def _tanh_stage(p, h):
    return torch.tanh(h @ p)


class _Tanh(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))

    def forward(self, h):
        return torch.tanh(h @ self.w)


def _jittered(r, seed):
    """``tanh(h @ p)`` that sleeps a random 0-20 ms per microbatch in its
    forward and in its backward (a hook on its input), so the ranks reach
    each microbatch in scrambled wall-clock order: a backward that paired
    gradients by arrival instead of by microbatch would mix them up."""
    jitter = np.random.RandomState(seed + r)

    def stage(p, h):
        time.sleep(jitter.uniform(0, 0.02))
        if h.requires_grad:
            h.register_hook(lambda g: (time.sleep(jitter.uniform(0, 0.02)),
                                       g)[1])
        return torch.tanh(h @ p)
    return stage


def pipeline():
    """``PipelineChain``, ``HeteroPipelineChain`` (module, replicated and
    sharded tiers), ``to_pipeline`` and the VGG pipeline on 4 ranks, on
    the JAX tests' seeded inputs."""
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.links import (
        HeteroPipelineChain,
        MultiNodeChainList,
        PipelineChain,
    )
    from chainermn_tpu_torch.models import (
        build_hetero_pipeline,
        vgg_loss,
        vgg_stage_modules,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        model_parallel_grad_reduce,
        sgd,
    )
    from chainermn_tpu_torch.utils import (
        vgg_stage_params_from_flax,
        vgg_stage_params_to_flax,
    )

    comm = create_communicator("naive", device="cpu")
    r, S = comm.rank, comm.size
    res = {}
    # Homogeneous stages (test_chain_list.py's pipeline tests).
    rng = np.random.RandomState(2)
    d = 16
    st = (rng.normal(size=(S, d, d)).astype(np.float32)
          * (0.5 / np.sqrt(d))).astype(np.float32)
    x = rng.normal(size=(32, d)).astype(np.float32)
    with torch.no_grad():
        res["pipe_fwd"] = _np(PipelineChain(_tanh_stage, comm, 4)(
            torch.tensor(st[r]), torch.tensor(x)))
    rng = np.random.RandomState(3)
    d = 8
    st = (rng.normal(size=(S, d, d)).astype(np.float32)
          * (0.5 / np.sqrt(d))).astype(np.float32)
    x = rng.normal(size=(16, d)).astype(np.float32)
    for M in (2, 4):
        w = torch.tensor(st[r], requires_grad=True)
        xx = torch.tensor(x, requires_grad=True)
        out = PipelineChain(_jittered(r, 100 * M), comm, M)(w, xx)
        (out ** 2).sum().backward()
        res[f"pipe_grad_m{M}"] = _np(w.grad)
        res[f"pipe_dx_m{M}"] = _np(xx.grad)
    # Three stages, three microbatches, on a sub-communicator.
    three = comm.split([0, 0, 0, 1])[0]
    if three.rank >= 0:
        w = torch.tensor(st[r], requires_grad=True)
        out = PipelineChain(_jittered(r, 7), three, 3)(w, torch.tensor(
            x[:12]))
        (out ** 2).sum().backward()
        res["pipe3_out"] = _np(out)
        res["pipe3_grad"] = _np(w.grad)

    # Heterogeneous stages (test_hetero_pipeline.py, test_hetero_sharded).
    dims = [16, 16, 32, 8, 24][:S + 1]
    rng = np.random.RandomState(0)
    params = [(rng.normal(size=(dims[s], dims[s + 1]))
               * (0.7 / np.sqrt(dims[s]))).astype(np.float32)
              for s in range(S)]
    io = [((dims[s],), (dims[s + 1],)) for s in range(S)]
    hp = HeteroPipelineChain(comm, [_tanh_stage] * S, io, 4)
    x1 = np.random.RandomState(1).normal(size=(32, dims[0])).astype(
        np.float32)
    x2 = np.random.RandomState(2).normal(size=(32, dims[0])).astype(
        np.float32)
    with torch.no_grad():
        res["hetero_fwd"] = _np(hp([torch.tensor(p) for p in params],
                                   torch.tensor(x1)))
    plist = [torch.tensor(p, requires_grad=True) for p in params]
    (hp(plist, torch.tensor(x2)) ** 2).sum().backward()
    res["hetero_grads"] = [_np(p.grad) for p in plist]
    row = hp.shard_params(params)
    res["row_shape"] = tuple(row.shape)
    with torch.no_grad():
        res["sharded_fwd"] = _np(hp.apply_sharded(row, torch.tensor(x1)))
    row.requires_grad_()
    (hp.apply_sharded(row, torch.tensor(x2)) ** 2).sum().backward()
    res["row_grad"] = _np(row.grad)
    res["unshard"] = hp.unshard_params(row.detach())
    # A linear MultiNodeChainList lowered onto the pipeline.
    chain = MultiNodeChainList(comm)
    for s in range(S):
        chain.add_link(_Tanh(params[s]) if s == r else None, rank=s,
                       rank_out=s + 1 if s + 1 < S else None)
    lowered = chain.to_pipeline(io, n_microbatches=4)
    res["lowered_params"] = sum(p.numel() for p in lowered.parameters())
    with torch.no_grad():
        res["lowered_fwd"] = _np(lowered(torch.tensor(x2)))
    # VGG-11 (test_hetero_pipeline.py's VGG test, then two SGD steps).
    inp = _inputs()
    modules = vgg_stage_modules(**inp["vgg"], device="cpu", stages=[r])
    modules[r].load_state_dict(vgg_stage_params_from_flax(
        inp["vgg_params"][r], device="cpu"))
    xv, yv = inp["vgg_x"], inp["vgg_y"]
    vp = build_hetero_pipeline(modules, comm, xv[:1], n_microbatches=4)
    res["vgg_io"] = vp.io_shapes
    res["vgg_params_held"] = sum(p.numel() for p in vp.parameters())
    logits = vp(torch.tensor(xv))
    loss, _ = vgg_loss(logits, yv)
    loss.backward()
    res["vgg_logits"] = _np(logits)
    res["vgg_grads"] = vgg_stage_params_to_flax(
        {n: p.grad for n, p in modules[r].named_parameters()})
    for p in vp.parameters():
        p.grad = None
    grid = create_communicator("naive", device="cpu",
                               mesh=hybrid_mesh({"data": 1, "model": S}))
    dcomm, mcomm = grid.sub("data"), grid.sub("model")
    opt = create_multi_node_optimizer(
        sgd(inp["lr"], momentum=0.9), dcomm,
        grad_reduce=model_parallel_grad_reduce(dcomm, mcomm))
    state = opt.init(vp)

    def loss_fn(model, batch):
        return vgg_loss(model(torch.tensor(batch[0])), batch[1])[0]

    step = opt.make_train_step(loss_fn)
    res["vgg_losses"] = [float(step(state, (xv, yv))[1]["loss"])
                         for _ in range(2)]
    res["vgg_after"] = vgg_stage_params_to_flax(
        dict(modules[r].named_parameters()))
    comm.barrier()
    return res


# -------------------------------------- sequence and expert parallelism
def seq_qkv(rng, B=2, T=32, H=8, D=4):
    """The JAX sequence tests' ``_qkv``."""
    return tuple((rng.normal(size=(B, T, H, D)) * 0.5).astype(np.float32)
                 for _ in range(3))


def packed_segments(B, T, cuts, shift=None):
    """Segment ids ``0 | 1 | 2`` at ``cuts``, row 1 shifted from
    ``shift`` on (the JAX tests' packed rows)."""
    seg = np.zeros((B, T), np.int32)
    seg[:, cuts[0]:cuts[1]] = 1
    if len(cuts) > 2:
        seg[:, cuts[2]:] = 2
    if shift is not None:
        seg[1, shift:] += 1
    return seg


def seqpar():
    """Ring (plain and flash), zigzag, Ulysses and the expert-parallel
    MoE on 4 ranks, on the JAX tests' seeded inputs: each rank's output
    block and its gradients (every rank backprops its share of the
    global loss)."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.parallel import (
        MoELayer,
        ring_flash_self_attention,
        ring_self_attention,
        ulysses_attention,
        zigzag_ring_self_attention,
        zigzag_shard,
    )

    comm = create_communicator("naive", device="cpu")
    r, S = comm.rank, comm.size
    res = {}

    def mine(x, zig=False):
        x = zigzag_shard(torch.tensor(x), S) if zig else torch.tensor(x)
        t = x.shape[1] // S
        return x[:, r * t:(r + 1) * t].contiguous()

    def run(name, fn, arrays, seg=None, zig=False, probe=None, **kw):
        """``fn`` on this rank's blocks; with ``probe`` (``"cos"``, a
        global array, or ``"square"``) also the gradients of the rank's
        share of the probe loss."""
        leaves = [mine(a, zig).requires_grad_(probe is not None)
                  for a in arrays]
        if seg is not None:
            kw["segment_ids"] = mine(seg, zig)
        out = fn(*leaves, comm, **kw)
        res[name] = _np(out)
        if probe is None:
            return
        if isinstance(probe, str) and probe == "square":
            loss = (out ** 2).sum()
        else:
            if isinstance(probe, str):
                B, T, H, D = arrays[0].shape
                probe = np.cos(np.arange(B * T * H * D, dtype=np.float32)
                               ).reshape(B, T, H, D)
            loss = (out * mine(probe.astype(np.float32), zig)).sum()
        loss.backward()
        res[name + "_grads"] = [_np(t.grad) for t in leaves]

    for causal in (False, True):
        c = int(causal)
        run(f"ring_c{c}", ring_self_attention,
            seq_qkv(np.random.RandomState(0)), causal=causal)
        run(f"ring_grad_c{c}", ring_self_attention,
            seq_qkv(np.random.RandomState(1), B=1, T=16, H=2, D=4),
            causal=causal, probe="cos")
        run(f"ulysses_c{c}", ulysses_attention,
            seq_qkv(np.random.RandomState(2)), causal=causal)
        run(f"ulysses_flash_c{c}", ulysses_attention,
            seq_qkv(np.random.RandomState(2)), causal=causal, impl="flash")
        rng = np.random.RandomState(7)
        gqa = ((rng.normal(size=(2, 32, 8, 8)) * 0.5).astype(np.float32),
               (rng.normal(size=(2, 32, 2, 8)) * 0.5).astype(np.float32),
               (rng.normal(size=(2, 32, 2, 8)) * 0.5).astype(np.float32))
        run(f"gqa_xla_c{c}", ring_self_attention, gqa, causal=causal)
        run(f"gqa_flash_c{c}", ring_flash_self_attention, gqa,
            causal=causal)
        run(f"ring_flash_c{c}", ring_flash_self_attention,
            seq_qkv(np.random.RandomState(3), B=2, T=64, H=2, D=8),
            causal=causal)
        qkv = seq_qkv(np.random.RandomState(4), B=1, T=32, H=2, D=4)
        run(f"ring_flash_grad_c{c}", ring_flash_self_attention, qkv,
            causal=causal, probe=np.random.RandomState(5).normal(
                size=qkv[0].shape))
        seg = packed_segments(2, 64, (20, 45, 45), shift=10)
        packed = seq_qkv(np.random.RandomState(11), B=2, T=64, H=4, D=8)
        run(f"ring_packed_c{c}", ring_self_attention, packed, seg=seg,
            causal=causal)
        run(f"ring_flash_packed_c{c}", ring_flash_self_attention, packed,
            seg=seg, causal=causal)
        run(f"ulysses_packed_c{c}", ulysses_attention,
            seq_qkv(np.random.RandomState(14), B=2, T=64, H=8, D=4),
            seg=packed_segments(2, 64, (18, 41, 41), shift=9),
            causal=causal)
    rng = np.random.RandomState(13)
    qkv = seq_qkv(rng, B=1, T=32, H=2, D=4)
    probe = rng.normal(size=qkv[0].shape)
    seg = packed_segments(1, 32, (12, 32))
    run("ring_packed_grad", ring_self_attention, qkv, seg=seg, causal=True,
        probe=probe)
    run("ring_flash_packed_grad", ring_flash_self_attention, qkv, seg=seg,
        causal=True, probe=probe)
    try:
        ulysses_attention(*(mine(a) for a in seq_qkv(
            np.random.RandomState(3), H=6)), comm)
        res["ulysses_bad"] = "no error"
    except ValueError as e:
        res["ulysses_bad"] = str(e)

    for impl in ("einsum", "flash"):
        rng = np.random.RandomState(0)
        qkv = tuple(rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
                    for _ in range(3))
        run(f"zigzag_{impl}", zigzag_ring_self_attention, qkv, zig=True,
            impl=impl)
        rng = np.random.RandomState(4)
        gqa = (rng.normal(size=(2, 64, 8, 16)).astype(np.float32),
               rng.normal(size=(2, 64, 2, 16)).astype(np.float32),
               rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
        run(f"zigzag_gqa_{impl}", zigzag_ring_self_attention, gqa,
            zig=True, impl=impl)
        rng = np.random.RandomState(1)
        qkv = tuple(rng.normal(size=(1, 32, 2, 8)).astype(np.float32)
                    for _ in range(3))
        run(f"zigzag_grad_{impl}", zigzag_ring_self_attention, qkv,
            zig=True, impl=impl, probe="square")
        rng = np.random.RandomState(5)
        qkv = tuple(rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
                    for _ in range(3))
        run(f"zigzag_packed_{impl}", zigzag_ring_self_attention, qkv,
            seg=packed_segments(2, 64, (22, 47, 47), shift=11), zig=True,
            impl=impl)

    # Expert parallelism (test_moe.py with E = 4 experts, one per rank).
    E = S

    def expert_apply(params, tokens):
        w1, w2 = params
        return torch.relu(tokens @ w1[0]) @ w2[0]

    def moe_setup(rng, n=4, D=6, F_=12):
        x = (rng.normal(size=(E * n, D)) * 0.7).astype(np.float32)
        router = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
        w1 = (rng.normal(size=(E, D, F_)) * 0.4).astype(np.float32)
        w2 = (rng.normal(size=(E, F_, D)) * 0.4).astype(np.float32)
        return x, router, w1, w2

    def moe_run(layer, router, w1, w2, x, grad=False):
        n = x.shape[0] // E
        ws = [torch.tensor(w[r:r + 1], requires_grad=grad) for w in (w1, w2)]
        rt = torch.tensor(router, requires_grad=grad)
        out, aux = layer(rt, tuple(ws), torch.tensor(x[r * n:(r + 1) * n]))
        if grad:
            (out ** 2).sum().backward()
            grads = [_np(t.grad) for t in (rt, *ws)]
            return _np(out), float(aux.detach()), grads
        return _np(out), float(aux.detach())

    for k in (1, 2):
        x, router, w1, w2 = moe_setup(np.random.RandomState(0))
        layer = MoELayer(expert_apply, comm, k=k, capacity_factor=float(E))
        res[f"moe_k{k}"] = moe_run(layer, router, w1, w2, x, grad=True)
    rng = np.random.RandomState(1)
    x = np.abs((rng.normal(size=(E * 4, 6)) * 0.5).astype(np.float32))
    router = np.zeros((6, E), np.float32)
    router[:, 0] = 1.0
    eye = np.tile(np.eye(6, dtype=np.float32)[None], (E, 1, 1))
    layer = MoELayer(expert_apply, comm, k=1, capacity_factor=0.25)
    res["moe_capacity"] = layer.capacity(4, E)
    res["moe_drop"] = moe_run(layer, router, eye, eye, x)
    x, _, w1, w2 = moe_setup(np.random.RandomState(2))
    layer = MoELayer(expert_apply, comm, k=1, capacity_factor=float(E))
    res["moe_aux_uniform"] = moe_run(layer, np.zeros((6, E), np.float32),
                                     w1, w2, x)[1]
    comm.barrier()
    return res


# ------------------------------------------------------------ ParallelLM
PLM = dict(vocab=64, n_stages=2, d_model=16, n_heads=4, d_ff=32,
           max_len=32, n_experts=2, moe_k=2)
PLM_GRID = {"data": 1, "stage": 2, "model": 2, "seq": 2}
PLM_CASES = {"learned": {}, "rope": {"pos_enc": "rope"},
             "learned-gqa": {"n_kv_heads": 2},
             "rope-gqa": {"pos_enc": "rope", "n_kv_heads": 2},
             "flash": {"attention": "flash"}}
PLM_LR = 0.5


def plm_batch(cfg):
    """The JAX test's parameters and batch (``RandomState(0)``)."""
    from chainermn_tpu_torch.models import init_parallel_lm

    rng = np.random.RandomState(0)
    params = init_parallel_lm(rng, cfg)
    B, T = 4, 16
    tokens = rng.randint(0, cfg.vocab, size=(B, T)).astype(np.int32)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return params, tokens, targets


def plm():
    """``ParallelLM`` on 8 ranks (data 1 x stage 2 x model 2 x seq 2):
    per configuration this rank's logits, the global loss and this rank's
    reduced gradients, then three SGD steps; then the dryrun twin."""
    from chainermn_tpu_torch.comm import create_communicator, hybrid_mesh
    from chainermn_tpu_torch.examples import dryrun_multichip
    from chainermn_tpu_torch.models import ParallelLM, ParallelLMConfig
    from chainermn_tpu_torch.models.transformer import _tree_items
    from chainermn_tpu_torch.utils import parallel_lm_shard

    comm = create_communicator("naive", device="cpu",
                               mesh=hybrid_mesh(PLM_GRID))
    res = {}
    for name, kw in PLM_CASES.items():
        cfg = ParallelLMConfig(**PLM)._replace(**kw)
        lm = ParallelLM(cfg, comm, n_microbatches=2)
        host, tokens, targets = plm_batch(cfg)
        c = lm.coords
        t = tokens.shape[1] // PLM_GRID["seq"]
        batch = tuple(torch.tensor(a[:, c["seq"] * t:(c["seq"] + 1) * t])
                      for a in (tokens, targets))
        params = parallel_lm_shard(host, cfg, c, device="cpu")
        out = {"coords": c}
        with torch.no_grad():
            out["logits"] = _np(lm.apply(params, batch[0]))
        res[name] = out
        if name == "flash":
            continue
        leaves = [p for _, p in _tree_items(params)]
        losses = []
        for step in range(3):
            loss = lm.loss(params, batch)
            loss.backward()
            grads = lm.grad_reduce(lm.grads_of(params))
            losses.append(float(lm.total_loss(loss)))
            if step == 0:
                out["grads"] = {"/".join(k): _np(g)
                                for k, g in _tree_items(grads)}
            with torch.no_grad():
                for p, (_, g) in zip(leaves, _tree_items(grads)):
                    p -= PLM_LR * g
                    p.grad = None
        out["losses"] = losses
        out["after"] = {"/".join(k): _np(p) for k, p in _tree_items(params)}
    res["dryrun"] = dryrun_multichip.main(["--device", "cpu",
                                           "--communicator", "naive"])
    comm.barrier()
    return res


# ------------------------------------------- the rings' kernels on a card
#: ``chip_smoke.py``'s ``sequence_parallel`` shapes: the LM bench's
#: attention widths over 8192 positions on 4 ranks, bf16.
SEQ_CUDA = dict(B=1, T=8192, H=12, KH=4, D=64)
SEQ_CUDA_SEGMENTS = [(0, 3000), (1, 2600), (2, 2592)]


def _excess(got, want, rtol):
    """max over elements of (|got - want| - rtol |want|) over the RMS of
    the reference's row (``chip_smoke.excess``)."""
    got, want = got.float(), want.float()
    slack = (got - want).abs() - rtol * want.abs()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    slack = torch.where(slack > 0, slack / rms, torch.zeros_like(slack))
    return max(float(slack.max()), 0.0)


def seqpar_cuda():
    """Ring flash, zigzag flash and Ulysses flash on 4 ranks sharing card
    0, each forward and backward twice: on card tensors (the kernels K1-K3)
    and on CPU copies of the same bf16 values (their plain versions), over
    the same gloo communicator; packed rows whose keys leave rows dead in
    whole visiting blocks included."""
    import importlib

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.parallel import (
        ring_flash_self_attention,
        ulysses_attention,
        zigzag_ring_self_attention,
        zigzag_shard,
    )

    fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda", 0)
    comm = create_communicator("naive", device=dev)
    r, S = comm.rank, comm.size
    B, T, H, KH, D = (SEQ_CUDA[k] for k in ("B", "T", "H", "KH", "D"))
    g = torch.Generator().manual_seed(0)
    q, k, v = ((torch.randn((B, T, H, D), generator=g) * 0.5).bfloat16()
               for _ in range(3))
    kc, vc = ((torch.randn((B, T, KH, D), generator=g) * 0.5).bfloat16()
              for _ in range(2))
    probe = torch.randn((B, T, H, D), generator=g)
    seg = torch.zeros((B, T), dtype=torch.int32)
    at = 0
    for sid, n in SEQ_CUDA_SEGMENTS:
        seg[:, at:at + n] = sid
        at += n
    causal = {"causal": True}
    cases = {
        "ring_flash": (ring_flash_self_attention, causal, False, False,
                       False),
        "ring_flash_packed": (ring_flash_self_attention, causal, False,
                              False, True),
        "ring_flash_gqa": (ring_flash_self_attention, causal, False, True,
                           False),
        "zigzag_flash": (zigzag_ring_self_attention, {"impl": "flash"},
                         True, False, False),
        "zigzag_flash_packed": (zigzag_ring_self_attention,
                                {"impl": "flash"}, True, False, True),
        "ulysses_flash": (ulysses_attention, dict(causal, impl="flash"),
                          False, False, False),
    }
    res = {}
    for name, (fn, kw, zig, gqa, packed) in cases.items():
        kk, vv = (kc, vc) if gqa else (k, v)

        def block(x, where):
            x = zigzag_shard(x, S) if zig else x
            t = x.shape[1] // S
            return x[:, r * t:(r + 1) * t].to(where).clone(
                memory_format=torch.contiguous_format)

        outs = {}
        for where in (dev, torch.device("cpu")):
            leaves = [block(x, where).requires_grad_() for x in (q, kk, vv)]
            args = dict(kw)
            if packed:
                args["segment_ids"] = block(seg, where)
            for kname in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                          "flash_attention_bwd_dq"):
                getattr(fa, kname).launches = 0
            o = fn(*leaves, comm, **args)
            (o.float() * block(probe, where)).sum().backward()
            outs[where.type] = [t.detach().cpu() for t in
                                (o, *[x.grad for x in leaves])]
            if where.type == "cuda":
                torch.cuda.synchronize(dev)
                launches = {kname: getattr(fa, kname).launches for kname in
                            ("flash_attention_fwd",
                             "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq")}
        res[name] = {
            "launches": launches,
            "finite": all(bool(torch.isfinite(t.float()).all())
                          for t in outs["cuda"]),
            "excess": {key: _excess(a, b, 2 ** -7)
                       for key, a, b in zip(("o", "dq", "dk", "dv"),
                                            outs["cuda"], outs["cpu"])},
            "fro": {key: float((a.float() - b.float()).norm()
                               / b.float().norm())
                    for key, a, b in zip(("o", "dq", "dk", "dv"),
                                         outs["cuda"], outs["cpu"])}}
    comm.barrier()
    return res


def save(name: str, res) -> None:
    """Save this rank's result of body ``name`` (a body that goes on to
    exit another way saves its result itself and returns None)."""
    rank = int(os.environ["RANK"])
    with open(f"{_OUT}/{name}.rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


_OUT = None


def run(name: str, out: str) -> None:
    """Run body ``name`` on this rank and save its result; a body reads
    the test's inputs, when the test wrote any, from ``_INPUTS``."""
    global _VGG_IN, _INPUTS, _OUT
    if name == "vgg":
        _VGG_IN = f"{out}/vgg_inputs.pkl"
    _INPUTS = f"{out}/{name}_inputs.pkl"
    _OUT = out
    res = globals()[name]()
    if res is not None:
        save(name, res)


# ------------------------------------------ tensor-parallel serving (2b)
#: ``tests/serving_tests/conftest.py``'s serving geometry (float32).
TP_MODEL = dict(vocab=128, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                max_len=96, n_kv_heads=2, pos_enc="rope")
TP_ENGINE = dict(capacity=2, num_blocks=20, block_len=8, prefill_chunk=8)


def tp_requests():
    """``test_sharding.py``'s traffic: shared-prefix prompts through a
    tight pool (``RandomState(3)``), the 4-way case's (``RandomState(5)``)
    and the sampling prompts (``RandomState(0)``)."""
    rng = np.random.RandomState(3)
    tpl = rng.randint(1, 128, size=11).tolist()
    pset = [tpl + rng.randint(1, 128, size=4).tolist() for _ in range(4)]
    pset += [[5, 9, 77], rng.randint(1, 128, size=15).tolist()]
    rng = np.random.RandomState(5)
    tpl = rng.randint(1, 128, size=9).tolist()
    pset4 = [tpl + rng.randint(1, 128, size=3).tolist() for _ in range(2)]
    pset4.append(rng.randint(1, 128, size=6).tolist())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, size=n).tolist() for n in (5, 12, 9)]
    return pset, pset4, prompts


def tp():
    """The tensor-parallel engine on 4 ranks: two 2-rank engines (ranks
    {0, 1} and {2, 3}) on the JAX test's geometry and traffic, einsum and
    fused, speculative and prefix-shared, greedy and sampled, beside the
    one-rank engine; one 4-rank engine with 4 kv heads; the layout; a MoE
    model, an odd vocab and ``lm_generate`` on the tensor-parallel model;
    the refusals."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.models import TransformerLM, lm_generate
    from chainermn_tpu_torch.observability import MetricsRegistry
    from chainermn_tpu_torch.serving import (
        DecodeEngine,
        PolicyPlane,
        Request,
        Scheduler,
    )
    from chainermn_tpu_torch.serving.sharding import serving_mesh, shard_model
    from chainermn_tpu_torch.utils import params_from_flax

    inputs = _inputs()
    comm = create_communicator("naive", device="cpu")
    mesh2, mesh4 = serving_mesh(2, comm), serving_mesh(4, comm)

    def lm(params, **over):
        m = TransformerLM(**{**TP_MODEL, **over}, dtype=torch.float32,
                          device="cpu")
        m.load_state_dict(params_from_flax(params, device="cpu"))
        return m

    def serve(eng, reqs):
        sched = Scheduler(eng)
        comps = sched.run(reqs)
        return {c.id: c.tokens for c in comps}, sched

    pset, pset4, prompts = tp_requests()

    def greedy():
        return [Request(id=i, prompt=p, max_new_tokens=8, seed=100 + i)
                for i, p in enumerate(pset)]

    def sampled():
        return [Request(id=10 + i, prompt=prompts[i], max_new_tokens=6,
                        temperature=0.8, seed=42 + i) for i in range(3)]

    res = {"rank": comm.rank, "m2_rank": mesh2.rank}
    for attn in ("einsum", "fused"):
        target = lm(inputs["params"], decode_attention=attn)
        draft = lm(inputs["draft_params"], n_layers=1, decode_attention=attn)
        kw = dict(TP_ENGINE, draft_model=draft, spec_k=2)
        eng = DecodeEngine(target, **kw, mesh=mesh2)
        toks, sched = serve(eng, greedy())
        res[f"m2_{attn}"] = toks
        res[f"m2_{attn}_books"] = {
            "hits": sched.prefix_hit_tokens,
            "decode_compiles": eng.decode_compiles,
            "cow_compiles": eng.cow_compiles,
            "prefill_compiles": eng.prefill_compiles,
            "ladder": len(eng.prefill_ladder),
            "over_budget": "compile_over_budget" in eng.stats(),
            "free_blocks": eng.free_blocks()}
        res[f"m2_{attn}_sampled"] = serve(eng, sampled())[0]
        one = DecodeEngine(target, **kw, device="cpu")
        res[f"one_{attn}"] = serve(one, greedy())[0]
        res[f"one_{attn}_sampled"] = serve(one, sampled())[0]
        if attn == "fused":
            res["layout"] = {n: _np(t) for n, t in
                             eng.model.state_dict().items()}
            res["pool_shape"] = tuple(eng.pools[0]["k"].shape)
            res["draft_pool_shape"] = tuple(eng.draft_pools[0]["k"].shape)
            try:
                Scheduler(eng, policy=PolicyPlane(registry=MetricsRegistry()))
                res["policy_error"] = "no error"
            except ValueError as e:
                res["policy_error"] = str(e)
            tpm = shard_model(target, mesh2)
            prompt = torch.tensor([prompts[1]])
            res["generate"] = (_np(lm_generate(tpm, prompt, 8)),
                               _np(lm_generate(target, prompt, 8)))
            try:
                DecodeEngine(target, **TP_ENGINE, mesh=mesh4)
                res["geometry_error"] = "no error"
            except ValueError as e:
                res["geometry_error"] = str(e)
    four = [Request(id=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(pset4)]
    for attn in ("einsum", "fused"):
        m4 = lm(inputs["params4"], n_kv_heads=4, decode_attention=attn)
        eng = DecodeEngine(m4, **TP_ENGINE, mesh=mesh4)
        res[f"m4_{attn}"] = serve(eng, four)[0]
        res[f"m4_{attn}_compiles"] = eng.decode_compiles
        res["m4_pool_shape"] = tuple(eng.pools[0]["k"].shape)
        res[f"one4_{attn}"] = serve(DecodeEngine(m4, **TP_ENGINE,
                                                 device="cpu"), four)[0]
    for name, over in (("moe", dict(n_experts=4, d_ff=64)),
                       ("odd_vocab", dict(vocab=127))):
        m = TransformerLM(**{**TP_MODEL, **over}, dtype=torch.float32,
                          decode_attention="fused", device="cpu", seed=3)
        eng = DecodeEngine(m, **TP_ENGINE, mesh=mesh2)
        res[f"m2_{name}"] = serve(eng, greedy())[0]
        res[f"one_{name}"] = serve(DecodeEngine(m, **TP_ENGINE,
                                                device="cpu"), greedy())[0]
        res[f"{name}_head"] = tuple(eng.model.lm_head.weight.shape)
    res["all_tokens"] = comm.allgather_obj(
        {k: v for k, v in res.items() if k.startswith(("m2_", "m4_"))
         and isinstance(v, dict) and not k.endswith("books")})
    comm.barrier()
    return res


# --------------------------------------------------------- ZeRO (item 11)
def _local(batch, c):
    """Communicator ``c``'s rank's rows of a global batch."""
    b = len(batch[0]) // c.size
    return tuple(a[c.rank * b:(c.rank + 1) * b] for a in batch)


def zero():
    """The ZeRO tier on 4 ranks against the JAX tests' oracles: the
    transform families, the layout, the bf16 wire, the clip, a schedule,
    a mixed-dtype LM, the checkpoint round trip, elastic restores 4 -> 2
    and 2 -> 4, the int8 residual reset, a fresh start, and a state
    carried over from the JAX ZeRO tier and back."""
    import warnings

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import (
        MLP,
        TransformerLM,
        classification_loss,
        lm_loss,
    )
    from chainermn_tpu_torch.optimizers import (
        adafactor,
        adamw,
        create_multi_node_optimizer,
        create_zero_optimizer,
        rmsprop,
        sgd,
        zero_clip_by_global_norm,
    )
    from chainermn_tpu_torch.utils import (
        mlp_params_from_flax,
        mlp_params_to_flax,
        params_from_flax,
        params_to_flax,
        zero_logical_from_jax,
        zero_logical_to_jax,
    )

    inputs = _inputs()
    comm = create_communicator("naive", device="cpu")
    comm16 = create_communicator("naive", device="cpu",
                                 allreduce_grad_dtype=torch.bfloat16)
    pair = comm.split([0, 0, 1, 1])[comm.rank // 2]
    r = comm.rank
    ckdir = inputs["dir"]

    def mlp(key):
        p, (hidden, n_out, n_in) = inputs[key]
        m = MLP(hidden=hidden, n_out=n_out, in_features=n_in, device="cpu")
        m.load_state_dict(mlp_params_from_flax(p, device="cpu"))
        return m

    def fit(opt, state, c, batches):
        loss_fn = classification_loss(state.model)
        metrics = {}
        for b in batches:
            state, metrics = opt.update(state, _local(b, c), loss_fn,
                                        has_aux=True)
        return state, float(metrics["loss"]) if metrics else None

    def flax_of(opt, state):
        return mlp_params_to_flax(opt.materialize_params(state))

    res = {}
    txs = {"sgd": lambda: sgd(0.1),
           "sgd_momentum": lambda: sgd(0.1, momentum=0.9),
           "momentum_nesterov": lambda: sgd(0.1, momentum=0.9,
                                            nesterov=True),
           "adam": lambda: adamw(1e-2, weight_decay=0.0),
           "adamw": lambda: adamw(1e-2, weight_decay=1e-3),
           "rmsprop": lambda: rmsprop(1e-2)}
    # The oracle cases (test_zero_optimizer.py).
    for name in ("sgd_momentum", "adam"):
        opt = create_zero_optimizer(txs[name](), comm)
        state, loss = fit(opt, opt.init(mlp("mlp32")), comm,
                          inputs["batches5"])
        res[f"oracle_{name}"] = (flax_of(opt, state), loss)
    # The layout and the bytes a rank stores, against one replicated
    # process's.
    opt = create_zero_optimizer(adamw(1e-3, weight_decay=0.0), comm)
    state, _ = fit(opt, opt.init(mlp("mlp32")), comm, inputs["batches5"][:1])
    rep = create_multi_node_optimizer(adamw(1e-3, weight_decay=0.0),
                                      comm.split([0, 1, 2, 3])[r])
    rstate, _ = fit(rep, rep.init(mlp("mlp32")), comm,
                    [_local(inputs["batches5"][0], comm)])
    osd = state.optimizer.state_dict()["state"]
    res["layout"] = {
        "shards": [tuple(p.shape) for p in state.flat_params],
        "sizes": [s.size for s in opt.specs],
        "padded": [s.padded for s in opt.specs],
        "opt_shapes": [{k: tuple(v.shape) for k, v in osd[i].items()}
                       for i in range(len(opt.specs))],
        "bytes": sum(t.numel() * t.element_size() for t in
                     opt._state_tensors(state)),
        "replicated_bytes": sum(
            t.numel() * t.element_size() for t in
            [p.detach() for p in rstate.model.parameters()]
            + [v for st in rstate.optimizer.state.values()
               for v in st.values()])}
    # The bf16 wire against fp32.
    for name, c in (("wire32", comm), ("wire16", comm16)):
        opt = create_zero_optimizer(sgd(0.1), c)
        state, _ = fit(opt, opt.init(mlp("mlp32")), c,
                       inputs["batches5"][:3])
        res[name] = flax_of(opt, state)
    # The global-norm clip and a schedule.
    opt = create_zero_optimizer(zero_clip_by_global_norm(0.05, comm)(
        sgd(0.1)), comm)
    state, _ = fit(opt, opt.init(mlp("mlp32")), comm, inputs["batches5"])
    res["clip"] = flax_of(opt, state)
    opt = create_zero_optimizer(adamw(lambda c: 0.05 / (1.0 + 0.1 * c),
                                      weight_decay=0.0), comm)
    state, _ = fit(opt, opt.init(mlp("mlp32")), comm,
                   inputs["batches5"][:3])
    res["schedule"] = flax_of(opt, state)
    # Mixed dtypes: bf16 storage beside the fp32 router, Adafactor.
    lm_params, lm_kw = inputs["lm"]
    m = TransformerLM(**lm_kw, param_dtype=torch.bfloat16, device="cpu")
    m.load_state_dict(params_from_flax(lm_params, device="cpu"))
    opt = create_zero_optimizer(adafactor(1e-2), comm)
    state = opt.init(m)
    losses = []
    for _ in range(3):
        state, met = opt.update(state, _local(inputs["lm_batch"], comm),
                                lm_loss(m), has_aux=True)
        losses.append(float(met["loss"]))
    got = opt.materialize_params(state)
    res["mixed"] = {"losses": losses,
                    "dtypes": {n: str(t.dtype) for n, t in got.items()},
                    "params": params_to_flax(got, n_heads=lm_kw["n_heads"])}
    # The checkpoint round trip (test_checkpoint_zero.py).
    b6 = inputs["batches6"]
    opt = create_zero_optimizer(txs["adam"](), comm)
    state, _ = fit(opt, opt.init(mlp("mlp16")), comm, b6[:3])
    ckpt = create_multi_node_checkpointer("zero", comm, path=ckdir,
                                          async_save=False)
    ckpt.save(state)
    opt2 = create_zero_optimizer(txs["adam"](), comm)
    template = opt2.init(mlp("mlp16"))
    restored, _ = create_multi_node_checkpointer(
        "zero", comm, path=ckdir).maybe_load(template)
    saved = flax_of(opt, state)
    back = flax_of(opt2, restored)
    state, _ = fit(opt, state, comm, b6[3:])
    cont, _ = fit(opt2, restored, comm, b6[3:])
    res["roundtrip"] = (saved, back, flax_of(opt, state), flax_of(opt2,
                                                                cont))

    # Elastic restores: save at n, resume at m (test_checkpoint_elastic).
    def elastic(name, tx, key, batches, n_save, cut, compression=None):
        small = pair if r < 2 else None
        save_comm = comm if n_save == 4 else small
        out = {}
        if save_comm is not None:
            opt = create_zero_optimizer(tx(), save_comm,
                                        grad_compression=compression)
            state, _ = fit(opt, opt.init(mlp(key)), save_comm,
                           batches[:cut])
            ck = create_multi_node_checkpointer(name, save_comm, path=ckdir,
                                                async_save=False)
            ck.save(state)
            out["saved"] = flax_of(opt, state)
            if compression is not None:
                out["saved_resid_max"] = max(
                    float(t.abs().max()) for t in state.ef_residual)
        comm.barrier()
        load_comm = comm if n_save == 2 else small
        if load_comm is not None:
            opt = create_zero_optimizer(tx(), load_comm,
                                        grad_compression=compression)
            ck = create_multi_node_checkpointer(name, load_comm, path=ckdir,
                                                async_save=False)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                state, it = ck.maybe_load_elastic(opt, mlp(key))
            out.update(step=state.step, iteration=it,
                       warnings=[str(x.message) for x in w],
                       restored=flax_of(opt, state))
            if compression is not None:
                out["resid_max"] = max(float(t.abs().max())
                                       for t in state.ef_residual)
            state, _ = fit(opt, state, load_comm, batches[cut:])
            out["final"] = flax_of(opt, state)
        comm.barrier()
        return out

    for n_save in (4, 2):
        res[f"elastic_adam_{n_save}"] = elastic(
            f"zel{n_save}", txs["adam"], "mlp16", b6, n_save, 3)
        for fam in ("sgd", "momentum_nesterov", "adam", "adamw", "rmsprop"):
            res[f"family_{fam}_{n_save}"] = elastic(
                f"fam_{fam}_{n_save}", txs[fam], "mlp18",
                inputs["batches_fam"], n_save, 2)
    res["int8_reset"] = elastic("ef", txs["adam"], "mlp16", b6[:2], 4, 2,
                                compression="int8_ef")
    opt = create_zero_optimizer(txs["adam"](), comm)
    state, it = create_multi_node_checkpointer(
        "none", comm, path=ckdir).maybe_load_elastic(opt, mlp("mlp16"))
    res["fresh"] = (it, state.step)
    # A state carried over from the JAX ZeRO tier: one more step here,
    # then back into its layout.
    jz = inputs["jax_zero"]
    opt = create_zero_optimizer(txs["adam"](), comm)
    state = opt.init(mlp("mlp16"))
    opt.load_logical(state, zero_logical_from_jax(
        jz["params"], inputs["mlp16"][0],
        lambda t: mlp_params_from_flax(t, device="cpu"),
        {"exp_avg": jz["mu"], "exp_avg_sq": jz["nu"],
         "step": jz["count"]}, step=jz["step"]))
    state, _ = fit(opt, state, comm, [jz["batch"]])
    res["from_jax"] = zero_logical_to_jax(opt.logical_state(state),
                                          mlp_params_to_flax, 4)
    comm.barrier()
    return res


# ------------------------------------- the convnets and DCGAN (item 8c)
def cnngan():
    """The channel-parallel convnet and the DCGAN on 2 ranks from the JAX
    tests' parameters and batches, then the three example twins."""
    import tempfile

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.examples import (
        train_dcgan,
        train_mnist_model_parallel,
        train_parallel_convnet,
    )
    from chainermn_tpu_torch.models import (
        Discriminator,
        Generator,
        channel_parallel_apply,
        channel_parallel_leaves,
        gan_init,
        make_channel_parallel_train_step,
        make_gan_train_step,
        shard_channel_parallel,
    )
    from chainermn_tpu_torch.optimizers import adamw, sgd
    from chainermn_tpu_torch.utils import (
        channel_parallel_params_from_flax,
        channel_parallel_params_to_flax,
        dcgan_params_from_flax,
    )

    inputs = _inputs()
    comm = create_communicator("naive", device="cpu")
    r, n = comm.rank, comm.size
    res = {}
    full = channel_parallel_params_from_flax(inputs["cnn"], device="cpu")
    params = shard_channel_parallel(full, r, n)
    x0 = torch.tensor(inputs["cnn_batches"][0][0].transpose(0, 3, 1, 2))
    with torch.no_grad():
        res["cnn_logits0"] = _np(channel_parallel_apply(params, x0, comm))
    opt = sgd(0.05, momentum=0.9)(channel_parallel_leaves(params))
    step = make_channel_parallel_train_step(comm)
    carry = (params, opt)
    for x, y in inputs["cnn_batches"]:
        carry, loss = step(carry, (torch.tensor(x.transpose(0, 3, 1, 2)),
                                   torch.tensor(y)))
    res["cnn_loss"] = float(loss)
    res["cnn_shards"] = channel_parallel_params_to_flax(carry[0])

    def players():
        g = Generator(ch=8, out_ch=1, nz=16, device="cpu")
        g.load_state_dict(dcgan_params_from_flax(inputs["gan_g"], "cpu"))
        d = Discriminator(ch=8, device="cpu")
        d.load_state_dict(dcgan_params_from_flax(inputs["gan_d"], "cpu"))
        return g, d

    for name, tx, batches in (
            ("gan_sgd", sgd(1e-3, momentum=0.9), inputs["gan_batches"]),
            ("gan_adam", adamw(1e-3, b1=0.5, weight_decay=0.0),
             inputs["gan_move_batches"])):
        g, d = players()
        state = gan_init(g, d, tx, tx, comm)
        gstep = make_gan_train_step(comm)
        hist = []
        for b in batches:
            state, met = gstep(state, _local(b, comm))
            hist.append({k: float(v) for k, v in met.items()})
        res[name] = {"g": {k: _np(v) for k, v in g.state_dict().items()},
                     "d": {k: _np(v) for k, v in d.state_dict().items()},
                     "history": hist}
    tmp = comm.bcast_obj(tempfile.mkdtemp() if r == 0 else None)
    res["ex_convnet"] = train_parallel_convnet.main([
        "--device", "cpu", "--communicator", "naive", "--epoch", "2",
        "--n-train", "128", "--batchsize", "32", "--widths", "8,16"])
    res["ex_dcgan"] = len(train_dcgan.main([
        "--device", "cpu", "--communicator", "naive", "--epoch", "1",
        "--n-train", "64", "--ch", "8", "--batchsize", "16",
        "--out", f"{tmp}/dcgan_log.json"]))
    trainer = train_mnist_model_parallel.main([
        "--device", "cpu", "--communicator", "naive", "--epoch", "2",
        "--iters-per-epoch", "4"])
    res["ex_mnist_mp"] = [e["loss"] for e in trainer.extensions[0].log]
    comm.barrier()
    return res


# ------------------------------------------- failure detection (12a)
#: the detector test's heartbeat: 0.1 s beats, dead after 10 silent ones.
HB = dict(interval_s=0.1, suspect_after=2.0, dead_after=10.0)


class _Unfreeze(Exception):
    """Ends an injected hang after a bounded time (the injector's
    ``sleep`` raises it), so that the frozen rank can report."""


def detector():
    """3 ranks, each a data-plane ``HostComm`` with a heartbeat detector
    from the launcher's ``CMN_TPU_HB_HOSTS`` attached: 3 clean barriers
    (the control), then ``hang@barrier:4`` on rank 2 (its beats frozen
    by the injector's freeze callback, the process asleep for 3 s): the
    others' 4th barrier raises the detector's verdict naming rank 2 and
    the op.  A healthy rank keeps beating for 1.5 s after its verdict, so
    that its gossip reaches the ring before it leaves."""
    from chainermn_tpu_torch.hostcomm import HostComm
    from chainermn_tpu_torch.resilience import PeerFailedError, faults
    from chainermn_tpu_torch.resilience import detector as det_mod

    r = int(os.environ["CMN_TPU_RANK"])
    res = {"interval_s": HB["interval_s"]}
    if r == 2:
        def bounded(s):
            time.sleep(3.0)
            raise _Unfreeze()

        inj = faults.FaultInjector(faults.parse_fault_spec("hang@barrier:4"),
                                   sleep=bounded)
        inj.add_freeze_callback(
            lambda: res.__setitem__("frozen_at", time.time()))
        faults._process_injector.update(built=True, inj=inj)
    hc = HostComm(timeout_ms=30000)
    det = det_mod.from_env(**HB)
    det.attach(hc)
    det.start()
    for _ in range(3):
        hc.barrier()
        time.sleep(0.05)
    res["control_dead"] = sorted(det.dead_ranks())
    try:
        hc.barrier()
        res["hang"] = "no error"
    except PeerFailedError as e:
        res["hang"] = dict(peer=e.peer, op=e.op, kind=e.kind, rank=e.rank,
                           message=str(e), at=time.time())
        try:
            det.check(op="allgather_obj")
        except PeerFailedError as e2:
            res["check"] = (e2.peer, e2.op, e2.kind)
        time.sleep(1.5)
    except _Unfreeze:
        res["hang"] = "frozen"
    res["dead"] = sorted(det.dead_ranks())
    res["liveness"] = det.liveness_report()
    det.stop()
    hc.close()
    return res


def consistency():
    """3 ranks: the digest of equal state, a clean vote over the process
    group, one flipped bit on rank 2 found by a vote over the launcher's
    ``HostComm``, and a vote at different steps, which raises."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.hostcomm import HostComm
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.resilience.consistency import (
        exchange_and_vote,
        tree_digest,
    )

    comm = create_communicator("naive", device="cpu")
    hc = HostComm(timeout_ms=30000)
    r = comm.rank
    model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu", seed=3)
    res = {"digest": tree_digest(model)}

    def vote(c, step):
        v = exchange_and_vote(c, model, step)
        return dict(clean=v.clean, divergent=v.divergent,
                    no_majority=v.no_majority, groups=v.groups,
                    describe=v.describe())

    res["clean"] = vote(comm, 1)
    if r == 2:
        with torch.no_grad():
            w = model.layers[0].weight.view(-1)
            w.view(torch.int32)[5] ^= 1
    res["flipped_digest"] = tree_digest(model)
    res["flip"] = vote(hc, 2)
    try:
        vote(comm, 3 if r != 1 else 4)
        res["desync"] = "no error"
    except RuntimeError as e:
        res["desync"] = str(e)
    hc.close()
    comm.barrier()
    return res


# ------------------------------------------ the training-health guard
class _DropNth:
    """An iterator that consumes its N-th batch unseen: the oracle of a
    skipped step (the data advanced, no update)."""

    def __init__(self, it, n):
        self._it, self._n, self._calls = it, int(n), 0

    def __next__(self):
        self._calls += 1
        batch = next(self._it)
        if self._calls == self._n:
            batch = next(self._it)
        return batch

    def __getattr__(self, name):
        return getattr(self._it, name)


def _guard_run(comm, label, fault=None, drop=None, stop=12, ckpt=True,
               skip_budget=3):
    """``tests/multiprocess_tests/worker_health_guard.py``'s run on the
    port: the MLP on the synthetic task over the ranks, SGD 0.1 momentum
    0.9, a guard voting every 2 iterations and a checkpoint every 2, up
    to ``stop``; ``fault`` on this rank, ``drop``: the oracle."""
    from chainermn_tpu_torch.datasets import (
        make_synthetic_classification,
        scatter_dataset,
    )
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        sgd,
    )
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        TrainingHealthGuard,
        parse_fault_spec,
        tree_digest,
    )
    from chainermn_tpu_torch.training import Extension, Trainer

    ds = scatter_dataset(make_synthetic_classification(384, 8, 4, seed=9),
                         comm, shuffle=True, seed=4)
    model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu")
    opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm)
    it = SerialIterator(ds, 32, shuffle=True, seed=2)
    if drop:
        it = _DropNth(it, drop)
    exts = []
    if ckpt:
        ckpt = create_multi_node_checkpointer(
            "guard", comm, path=f"{_OUT}/ckpt_{label}",
            trigger=(2, "iteration"), async_save=False, max_to_keep=8)
        exts.append(ckpt)
    guard = TrainingHealthGuard(comm=comm, checkpointer=ckpt or None,
                                vote_every=2 if ckpt else 0,
                                skip_budget=skip_budget)
    losses, oks, addrs = {}, {}, {}

    def capture(tr):
        m = tr.last_metrics
        losses[tr.iteration] = float(m["loss"])
        oks[tr.iteration] = float(m["step_ok"])
        if tr.iteration == 1:
            addrs["first"] = {k: t.data_ptr() for k, t in
                              opt._step_state(tr.state).items()}

    trainer = Trainer(opt, opt.init(model), classification_loss(model), it,
                      stop=(stop, "iteration"), has_aux=True,
                      health_guard=guard,
                      extensions=exts + [Extension(capture,
                                                   (1, "iteration"))])
    trainer._fault_injector = (FaultInjector(parse_fault_spec(fault))
                               if fault else None)
    trainer.run()
    return dict(losses=losses, step_ok=oks,
                final_iteration=trainer.iteration,
                final_digest=tree_digest(trainer.state.params),
                known_good=ckpt.known_good_steps() if ckpt else [],
                report=guard.guard_report(),
                addresses_kept=addrs["first"] == {
                    k: t.data_ptr() for k, t in
                    opt._step_state(trainer.state).items()})


def guard():
    """3 ranks under ``launch.supervise``.  Attempt 0: ``nan@grad:5`` on
    rank 1 and its oracle (batch 5 consumed unseen), ``flip@param:7`` on
    rank 1 and its unfaulted oracle; then, the results saved, a guard
    with no checkpointer meets ``nan@grad:2`` on rank 0 with a skip budget
    of 0: every rank escalates and exits 76.  The relaunch (attempt 1)
    only records that it ran."""
    attempt = int(os.environ.get("CMN_LAUNCH_ATTEMPT", "0"))
    rank = int(os.environ["RANK"])
    if attempt:
        with open(f"{_OUT}/guard.attempt{attempt}.rank{rank}", "w") as f:
            f.write("relaunched")
        return None
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.resilience import HealthEscalationInterrupt

    comm = create_communicator("naive", device="cpu")
    r = comm.rank
    res = {"nan": _guard_run(comm, "nan", "nan@grad:5" if r == 1 else None),
           "nan_oracle": _guard_run(comm, "oracle", drop=5, stop=11),
           "plain": _guard_run(comm, "plain"),
           "flip": _guard_run(comm, "flip",
                              "flip@param:7" if r == 1 else None)}
    save("guard", res)
    try:
        _guard_run(comm, "escalate", "nan@grad:2" if r == 0 else None,
                   stop=4, ckpt=False, skip_budget=0)
    except HealthEscalationInterrupt as e:
        with open(f"{_OUT}/guard.escalation.rank{rank}", "w") as f:
            f.write(f"{e.code} {e.iteration} {e.reason}")
        raise
    return None


# ------------------------------- preemption and peer replication (12b)
class _Signal:
    """An extension that preempts this rank at ``at``: SIGTERM to itself,
    then a wait for the guard's flag (the handler runs between
    bytecodes), so the vote after the iteration sees it."""

    def __init__(self, guard, at):
        from chainermn_tpu_torch.training import Extension

        self.guard, self.at = guard, int(at)
        self.extension = Extension(self, (1, "iteration"), name="signal")

    def __call__(self, tr):
        import signal

        if tr.iteration == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
            while not self.guard.preempted:
                time.sleep(0.001)


def _rep_run(comm, label, stop=12, zero=True, rep=None, ckpt=None,
             guard=None, fault=None, preempt_at=None, negotiate=False,
             elastic=False, stash=None):
    """The MLP on the synthetic task over the ranks (AdamW 1e-2; ZeRO by
    default), stopping at ``stop``: optionally under a replicator
    (cadence 2), a checkpointer, a preemption guard (``preempt_at``:
    this rank signals itself), a ``CMN_FAULT`` spec, and with a restore
    negotiated first (``elastic``: through ``maybe_load_elastic``; its
    report stashed under ``stash`` before the run)."""
    from chainermn_tpu_torch.datasets import (
        make_synthetic_classification,
        scatter_dataset,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
        create_zero_optimizer,
    )
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        negotiate_restore,
        parse_fault_spec,
        tree_digest,
    )
    from chainermn_tpu_torch.training import Trainer

    ds = scatter_dataset(make_synthetic_classification(384, 8, 4, seed=9),
                         comm, shuffle=True, seed=4)
    model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu")
    opt = (create_zero_optimizer(adamw(1e-2), comm) if zero
           else create_multi_node_optimizer(adamw(1e-2), comm))
    exts = [e for e in (rep, ckpt) if e is not None]
    if preempt_at is not None:
        exts.append(_Signal(guard, preempt_at).extension)
    trainer = Trainer(opt, opt.init(model), classification_loss(model),
                      SerialIterator(ds, 32, shuffle=True, seed=2),
                      stop=(stop, "iteration"), has_aux=True,
                      extensions=exts, preemption_guard=guard)
    trainer._fault_injector = (FaultInjector(parse_fault_spec(fault))
                               if fault else None)
    out = {"label": label}
    if negotiate:
        el = (lambda: ckpt.maybe_load_elastic(opt, model, trainer)) \
            if elastic else None
        _, it, report = negotiate_restore(rep, trainer.state, trainer,
                                          checkpointer=ckpt, elastic=el)
        out.update(resumed=it, report=report)
        if stash:
            _stash(stash, dict(out))
    trainer.run()
    params = (opt.materialize_params(trainer.state) if zero
              else trainer.state.params)
    opt_state = {f"{i}.{k}": v for i, st in enumerate(
        trainer.state.optimizer.state.values()) for k, v in st.items()
        if torch.is_tensor(v)}
    out.update(iteration=trainer.iteration,
               params_digest=tree_digest(params),
               state_digest=tree_digest({**params, **opt_state}))
    return out


def _stash(name, res):
    rank = int(os.environ["RANK"])
    attempt = os.environ.get("CMN_LAUNCH_ATTEMPT", "0")
    with open(f"{_OUT}/{name}.attempt{attempt}.rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def preempt():
    """2 ranks under ``launch.supervise``.  Attempt 0: the unfaulted run
    to 12, then a guarded run (a checkpoint every 4) that rank 1
    preempts at 6: every rank flushes, saves at 6 and exits 75.  Attempt
    1: ``maybe_load`` resumes at 6 and runs to 12."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.resilience import PreemptionGuard

    attempt = int(os.environ["CMN_LAUNCH_ATTEMPT"])
    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(
        "pre", comm, path=f"{_OUT}/ckpt", trigger=(4, "iteration"),
        async_save=False)
    if attempt == 0:
        _stash("preempt", {"oracle": _rep_run(comm, "oracle", zero=False)})
        guard = PreemptionGuard(comm=comm).install()
        _rep_run(comm, "preempted", zero=False, ckpt=ckpt, guard=guard,
                 preempt_at=6 if comm.rank == 1 else None)
        raise AssertionError("the preempted run did not exit")
    res = _resume(comm, ckpt)
    res["steps_saved"] = ckpt.all_steps()
    return res


def _resume(comm, ckpt):
    from chainermn_tpu_torch.datasets import (
        make_synthetic_classification,
        scatter_dataset,
    )
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.resilience import tree_digest
    from chainermn_tpu_torch.training import Trainer

    ds = scatter_dataset(make_synthetic_classification(384, 8, 4, seed=9),
                         comm, shuffle=True, seed=4)
    model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu")
    opt = create_multi_node_optimizer(adamw(1e-2), comm)
    trainer = Trainer(opt, opt.init(model), classification_loss(model),
                      SerialIterator(ds, 32, shuffle=True, seed=2),
                      stop=(12, "iteration"), has_aux=True, extensions=[ckpt])
    _, resumed = ckpt.maybe_load(trainer.state, trainer)
    trainer.run()
    st = trainer.state
    opt_state = {f"{i}.{k}": v for i, s in enumerate(
        st.optimizer.state.values()) for k, v in s.items()
        if torch.is_tensor(v)}
    return {"resumed": resumed, "iteration": trainer.iteration,
            "params_digest": tree_digest(st.params),
            "state_digest": tree_digest({**st.params, **opt_state})}


def replicate():
    """3 ranks under ``launch.supervise`` (ZeRO, a replicator every 2,
    factor 1, a checkpoint every 4).  Attempt 0: the unfaulted run to 12,
    then ``crash@iter:5`` on rank 1.  Attempt 1: rank 1's spill is wiped
    (its host died); the quorum restores it from rank 2's replica at 4;
    rank 0 preempts at 7 (flush, save, exit 75).  Attempt 2: every rank
    restores its own flush at 7; ``flip@replicate:1`` on rank 0 tears its
    first frame (rank 1 discards it); the run ends at 12."""
    import shutil

    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.observability import metrics as _omet
    from chainermn_tpu_torch.resilience import (
        FaultInjector,
        PreemptionGuard,
        ShardReplicator,
        parse_fault_spec,
    )

    attempt = int(os.environ["CMN_LAUNCH_ATTEMPT"])
    comm = create_communicator("naive", device="cpu")
    r = comm.rank
    ckpt = create_multi_node_checkpointer(
        "rep", comm, path=f"{_OUT}/ckpt", trigger=(4, "iteration"),
        async_save=False)
    inj = (FaultInjector(parse_fault_spec("flip@replicate:1"))
           if attempt == 2 and r == 0 else None)
    rep = ShardReplicator(comm, every=2, factor=1, spill_dir=f"{_OUT}/rep",
                          keep=4, injector=inj, _use_process_injector=False)
    if attempt == 0:
        _stash("replicate", {"oracle": _rep_run(comm, "oracle")})
        _rep_run(comm, "crash", rep=rep, ckpt=ckpt,
                 fault="crash@iter:5" if r == 1 else None)
        raise AssertionError("the crashed run did not stop")
    if attempt == 1 and r == 1:
        shutil.rmtree(rep.spill_dir)
        os.makedirs(rep.spill_dir)
    guard = PreemptionGuard(comm=comm).install() if attempt == 1 else None
    res = _rep_run(comm, f"attempt{attempt}", rep=rep, ckpt=ckpt,
                   guard=guard, negotiate=True, stash="replicate",
                   preempt_at=7 if attempt == 1 and r == 0 else None)
    snap = _omet.registry().snapshot()
    res.update(torn=snap.get("train.rep.torn", {}).get("value"),
               held=rep.report()["held"])
    return res


def replicate_elastic():
    """2 ranks relaunched over the 3-rank job's spill and checkpoints:
    the inventories name another world size, so the negotiation falls
    back to ``maybe_load_elastic`` and files ``replication_fallback``."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.observability import incident
    from chainermn_tpu_torch.resilience import ShardReplicator

    comm = create_communicator("naive", device="cpu")
    ckpt = create_multi_node_checkpointer(
        "rep", comm, path=f"{_OUT}/ckpt", trigger=(4, "iteration"),
        async_save=False)
    rep = ShardReplicator(comm, every=2, factor=1, spill_dir=f"{_OUT}/rep",
                          keep=4, _use_process_injector=False)
    res = _rep_run(comm, "elastic", rep=rep, ckpt=ckpt, negotiate=True,
                   elastic=True)
    mgr = incident.manager()
    mgr.evaluate()
    res["incidents"] = [m["rule"]["name"] if isinstance(m.get("rule"), dict)
                        else m.get("rule") for m in mgr.incidents]
    return res
