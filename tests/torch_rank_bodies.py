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
def run(name: str, out: str) -> None:
    """Run body ``name`` on this rank and save its result."""
    global _VGG_IN
    if name == "vgg":
        _VGG_IN = f"{out}/vgg_inputs.pkl"
    res = globals()[name]()
    rank = int(os.environ["RANK"])
    with open(f"{out}/{name}.rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
