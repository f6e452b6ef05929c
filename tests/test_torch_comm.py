"""The port's communicator and data-parallel optimizer across ranks.

In-process tests run on the one-rank gloo group that
``create_communicator`` builds over a ``HashStore`` when no process group
exists.  One test starts two gloo ranks as separate processes (the
``torchrun`` environment: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and holds them against the one-rank run on the whole
batch.  Tolerance for the optimizer comparison: atol 2e-5 + rtol 1e-4
(the same float32 sums split over two ranks; Adam eps 1e-6 as in
``test_torch_training.py``, for the same reason).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.comm import (
    DummyCommunicator,
    ProcessGroupCommunicator,
    create_communicator,
)
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.optimizers import (
    adamw,
    create_multi_node_optimizer,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent
NAMES = ["hierarchical", "two_dimensional", "non_cuda_aware", "xla",
         "pure_nccl", "flat", "single_node", "naive", "dummy"]
MODEL = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, d_ff=64,
             max_len=16, pos_enc="rope", n_kv_heads=2)


@pytest.mark.parametrize("name", NAMES)
def test_create_communicator_names(name):
    comm = create_communicator(name, device="cpu")
    want = DummyCommunicator if name == "dummy" else ProcessGroupCommunicator
    assert type(comm) is want
    assert (comm.rank, comm.size) == (0, 1)
    assert (comm.intra_rank, comm.intra_size) == (0, 1)
    assert (comm.inter_rank, comm.inter_size) == (0, 1)


def test_unknown_name_and_unported_methods_raise():
    """Unknown names raise; since the rest of the communicator was ported
    no method raises as unported, and on one rank the collectives are
    identities (tests/test_torch_comm_collectives.py holds them across
    ranks)."""
    with pytest.raises(ValueError, match="unknown communicator name"):
        create_communicator("mpi", device="cpu")
    comm = create_communicator("xla", device="cpu")
    x = torch.tensor([[1.0, 2.0]])
    assert torch.equal(comm.allgather(x[0]), x)
    assert torch.equal(comm.alltoall(x), x)
    assert torch.equal(comm.permute(x, [(0, 0)]), x)
    assert torch.equal(comm.permute(x, []), torch.zeros_like(x))
    assert set(comm.split([7])) == {7} and comm.split([7])[7].size == 1
    assert comm.sub("data").members == comm.members
    comm.send_obj({"a": 1}, 0)
    assert comm.recv_obj(0) == {"a": 1}
    assert comm.axis_name is torch.distributed.group.WORLD
    with pytest.raises(ValueError, match="color must have one entry"):
        comm.split([0, 1])


def test_one_rank_collectives():
    comm = create_communicator("xla", device="cpu")
    x = torch.tensor([1.0, -2.0])
    assert torch.equal(comm.allreduce(x), x)
    assert torch.equal(comm.allreduce(x, op="mean"), x)
    assert comm.bcast_obj({"a": 1}) == {"a": 1}
    comm.barrier()
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([1.0, 2.0, 3.0])
    comm.allreduce_grad([p])
    assert torch.equal(p.grad, torch.tensor([1.0, 2.0, 3.0]))
    q = torch.nn.Parameter(torch.ones(2))  # no grad: reduced as zeros
    comm.allreduce_grad([q])
    assert torch.equal(q.grad, torch.zeros(2))
    with pytest.raises(ValueError, match="op="):
        comm.allreduce(x, op="xor")


def test_one_rank_object_plane():
    comm = create_communicator("xla", device="cpu")
    assert comm.allgather_obj({"a": [1, 2]}) == [{"a": [1, 2]}]
    assert comm.gather_obj("x") == ["x"]
    assert comm.allreduce_obj({"loss": 2.5, "n": (3, 4)}, op="mean") == \
        {"loss": 2.5, "n": (3, 4)}
    with pytest.raises(ValueError, match="unknown op"):
        comm.allreduce_obj(1.0, op="xor")


def test_wire_dtype_rounds_the_gradient_once():
    comm = create_communicator("pure_nccl", device="cpu",
                               allreduce_grad_dtype=torch.bfloat16)
    assert comm.allreduce_grad_dtype == torch.bfloat16
    g = torch.tensor([1.0 + 2 ** -10, 3.14159265, -1e-3])
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = g.clone()
    comm.allreduce_grad([p])
    assert p.grad.dtype == torch.float32
    assert torch.equal(p.grad, g.to(torch.bfloat16).float())
    assert create_communicator(
        "xla", device="cpu", allreduce_grad_dtype="float16"
    ).allreduce_grad_dtype == torch.float16


def _batches(B, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, size=(B, 16)).astype(np.int32),
             rng.randint(0, 64, size=(B, 16)).astype(np.int32))
            for _ in range(2)]


def _run(comm, seed, batches):
    tm = TransformerLM(**MODEL, dtype=torch.float32, device="cpu",
                       seed=seed)
    opt = create_multi_node_optimizer(adamw(1e-3, eps=1e-6,
                                            weight_decay=0.01), comm)
    state = opt.init(tm)
    step = opt.make_train_step(lm_loss(tm), has_aux=True)
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    return losses, {n: p.detach().numpy().copy()
                    for n, p in tm.named_parameters()}


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    sys.path.insert(0, {tests!r})
    import test_torch_comm as t
    from chainermn_tpu_torch.comm import create_communicator

    comm = create_communicator("naive", device="cpu")
    r = comm.rank
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(r + 1))
    comm.allreduce_grad([p])
    objs = {{"all": comm.allgather_obj({{"r": r}}),
            "gather": comm.gather_obj(r * 10, root=1),
            "sum": comm.allreduce_obj({{"a": r + 1.0, "b": [r, 2 * r]}}),
            "max": comm.allreduce_obj(np.array([r, -r]), op="max").tolist()}}
    # Each rank holds its half of every global batch; rank 1 starts from
    # other weights, which opt.init's broadcast must overwrite.
    halves = [tuple(a[r * 4:(r + 1) * 4] for a in b)
              for b in t._batches(8)]
    losses, params = t._run(comm, 5 + r, halves)
    np.savez({out!r} + f"/rank{{r}}.npz", **params)
    json.dump({{"grad": p.grad.tolist(), "losses": losses, "objs": objs}},
              open({out!r} + f"/rank{{r}}.json", "w"))
""")


def test_a_gloo_default_group_is_destroyed_at_exit():
    """``init_distributed`` destroys its gloo group at exit (after a
    barrier over its ranks), while the interpreter runs: a gloo worker
    thread freeing a collective's tensors during finalization would abort
    the process.  The check registered first runs last, after the port's
    handler."""
    code = textwrap.dedent("""
        import atexit
        import torch
        import torch.distributed as dist
        atexit.register(lambda: print("left", dist.is_initialized()))
        from chainermn_tpu_torch.distributed import init_distributed
        assert init_distributed("gloo")
        dist.all_reduce(torch.ones(3))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["left", "False"], out.stdout


def test_two_gloo_ranks_equal_one_rank_on_the_whole_batch(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(tests=str(REPO / "tests"),
                                    out=str(tmp_path)))
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for pr in procs:
        out, _ = pr.communicate(timeout=180)
        assert pr.returncode == 0, out

    comm = create_communicator("xla", device="cpu")
    want_losses, want = _run(comm, 5, _batches(8))
    for r in range(2):
        info = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert info["grad"] == [1.5, 1.5, 1.5], "allreduce_grad is the mean"
        assert info["objs"] == {"all": [{"r": 0}, {"r": 1}],
                                "gather": [0, 10] if r == 1 else None,
                                "sum": {"a": 3.0, "b": [1, 2]},
                                "max": [1, 0]}
        np.testing.assert_allclose(info["losses"], want_losses, rtol=1e-5)
        got = np.load(tmp_path / f"rank{r}.npz")
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=2e-5,
                                       rtol=1e-4, err_msg=f"rank {r} {n}")
