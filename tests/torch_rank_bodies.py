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
def hostcomm():
    from chainermn_tpu_torch.hostcomm import HostComm

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
    try:
        hc.attach_detector(object())
    except NotImplementedError as e:
        res["detector"] = str(e)
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


def run(name: str, out: str) -> None:
    """Run body ``name`` on this rank and save its result; a body reads
    the test's inputs, when the test wrote any, from ``_INPUTS``."""
    global _VGG_IN, _INPUTS
    if name == "vgg":
        _VGG_IN = f"{out}/vgg_inputs.pkl"
    _INPUTS = f"{out}/{name}_inputs.pkl"
    res = globals()[name]()
    rank = int(os.environ["RANK"])
    with open(f"{out}/{name}.rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
