"""The port's multi-node checkpointer (``chainermn_tpu/extensions/
checkpoint.py``'s contract) on the CPU.

Exact resume: the MLP through the ``Trainer`` over the native
``PrefetchIterator`` and the device-prefetch stage, with double
buffering, int8 error feedback and an EMA on, trained 2 epochs straight
equals 1 epoch + a (background) save + a restore into a fresh model,
optimizer and pipeline + 1 epoch: the second epoch's losses, every
parameter, the optimizer's momentum, the pending gradients, the EMA and
the int8 residual, bit for bit.  A restore reproduces the saved tensors
byte for byte.  Garbage collection keeps ``max_to_keep`` steps.  Two gloo
ranks agree on the newest step COMMON to both when one rank holds an
extra one, and each restores its own residual.
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

from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import make_synthetic_classification
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.iterators import (
    PrefetchIterator,
    create_device_prefetch_iterator,
)
from chainermn_tpu_torch.models import MLP, classification_loss
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd
from chainermn_tpu_torch.training import Extension, LogReport, Trainer

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent


def _trainer(path, seed, stop):
    comm = create_communicator("xla", device="cpu")
    ds = make_synthetic_classification(100, 24, 10, seed=4)
    model = MLP(hidden=(16,), in_features=24, device="cpu", seed=seed)
    opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm,
                                      double_buffering=True,
                                      grad_compression="int8_ef",
                                      ema_decay=0.9)
    it = create_device_prefetch_iterator(
        PrefetchIterator(ds, 16, seed=7, copy=False), comm, depth=2)
    tr = Trainer(opt, opt.init(model), classification_loss(model), it,
                 stop=stop, has_aux=True)
    losses = []
    tr.extend(Extension(lambda t: losses.append(
        (t.iteration, t.epoch, float(t.last_metrics["loss"]))),
        (1, "iteration")))
    tr.extend(LogReport(print_report=False))
    ckpt = create_multi_node_checkpointer("t", comm, path=str(path),
                                          async_save=True)
    tr.extend(ckpt)
    return tr, ckpt, losses


def _tensors(tr):
    st = tr.state
    out = {f"p:{n}": p for n, p in st.model.named_parameters()}
    for field in ("pending_grads", "ef_residual", "ema_params"):
        out.update({f"{field}:{n}": t for n, t in getattr(st, field).items()})
    for i, s in st.optimizer.state.items():
        out[f"opt:{i}"] = s["momentum_buffer"]
    return out


def test_resume_equals_uninterrupted(tmp_path):
    straight, _, want = _trainer(tmp_path / "a", 0, (2, "epoch"))
    straight.run()
    first, ckpt, _ = _trainer(tmp_path / "b", 0, (1, "epoch"))
    first.run()
    assert ckpt.all_steps() == [first.iteration] == [7]
    resumed, ckpt2, got = _trainer(tmp_path / "b", 123, (2, "epoch"))
    _, it = ckpt2.maybe_load(resumed.state, resumed)
    assert it == 7 and resumed.epoch == 1 and resumed.state.step == 7
    resumed.run()
    assert got == [w for w in want if w[0] > 7]
    a, b = _tensors(straight), _tensors(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(t.abs().sum() > 0 for k, t in b.items()
               if k.startswith("ef_residual"))
    # LogReport fired once per epoch in both, not again on resume.
    assert [e["epoch"] for e in resumed.extensions[1].log] == [2]
    assert ckpt2.all_steps() == [7, 13]


def test_restore_is_byte_exact_and_gc_keeps_max_to_keep(tmp_path):
    comm = create_communicator("xla", device="cpu")
    model = MLP(hidden=(8,), in_features=6, device="cpu", seed=1)
    opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9), comm,
                                      grad_compression="int8_ef")
    st = opt.init(model)
    loss = classification_loss(model)
    rng = np.random.RandomState(0)
    ckpt = create_multi_node_checkpointer("gc", comm, path=str(tmp_path),
                                          max_to_keep=2, async_save=False)
    for _ in range(5):
        opt.update(st, (rng.randn(8, 6).astype(np.float32),
                        rng.randint(0, 10, 8)), loss, has_aux=True)
        ckpt.save(st)
    assert ckpt.all_steps() == [4, 5]
    assert sorted(os.listdir(ckpt.directory)) == ["4", "5"]
    saved = {k: v.clone() for k, v in _tensors_of(st).items()}
    fresh = MLP(hidden=(8,), in_features=6, device="cpu", seed=9)
    st2 = opt.init(fresh)
    ckpt2 = create_multi_node_checkpointer("gc", comm, path=str(tmp_path),
                                           max_to_keep=2)
    assert ckpt2.last_restore == {}
    st2, _ = ckpt2.maybe_load(st2)
    assert st2.step == 5
    rec = ckpt2.last_restore
    assert rec["step"] == 5
    assert rec["bytes"] == os.path.getsize(ckpt2._rank_file(5))
    assert 0 < rec["load_s"] <= rec["seconds"]
    for k, v in _tensors_of(st2).items():
        assert v.dtype == saved[k].dtype
        assert v.numpy().tobytes() == saved[k].numpy().tobytes(), k
    with pytest.raises(NotImplementedError, match="item 11"):
        ckpt.maybe_load_elastic(opt, None)


def test_known_good_ring_emergency_save_and_discard(tmp_path):
    """The rollback targets of the JAX checkpointer's known-good ring: a
    vote at iteration N blesses the snapshots up to N (persisted beside
    them), ``discard_after`` deletes the newer ones and unblesses them,
    and ``emergency_save`` snapshots the trainer's iteration once."""
    comm = create_communicator("xla", device="cpu")
    model = MLP(hidden=(8,), in_features=6, device="cpu")
    opt = create_multi_node_optimizer(sgd(0.1), comm)
    st = opt.init(model)
    ck = create_multi_node_checkpointer("kg", comm, path=str(tmp_path),
                                        async_save=False, known_good_keep=2)
    for step in (2, 4, 6):
        st.step = step
        ck.save(st)
    assert ck.mark_known_good_upto(5) == [2, 4]
    assert ck.mark_known_good_upto(5) == []
    assert ck.latest_known_good() == 4
    again = create_multi_node_checkpointer("kg", comm, path=str(tmp_path))
    assert again.known_good_steps() == [2, 4]
    assert ck.discard_after(2) == [4, 6]
    assert ck.all_steps() == [2] and ck.known_good_steps() == [2]
    tr = Trainer(opt, st, classification_loss(model), iter([]),
                 stop=(0, "iteration"))
    tr.iteration = 9
    assert ck.emergency_save(tr) == 9 and ck.emergency_save(tr) == 9
    assert ck.all_steps() == [2, 9]


def _tensors_of(st):
    out = {f"m:{k}": v for k, v in st.model.state_dict().items()}
    out.update({f"r:{k}": v for k, v in st.ef_residual.items()})
    for i, s in st.optimizer.state.items():
        out[f"o:{i}"] = s["momentum_buffer"]
    return out


WORKER = textwrap.dedent("""
    import json
    import numpy as np
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    comm = create_communicator("naive", device="cpu")
    r = comm.rank

    def fresh(seed):
        model = MLP(hidden=(8,), in_features=6, device="cpu", seed=seed)
        opt = create_multi_node_optimizer(sgd(0.1), comm,
                                          grad_compression="int8_ef")
        return model, opt, opt.init(model)

    model, opt, st = fresh(0)
    rng = np.random.RandomState(r)
    ckpt = create_multi_node_checkpointer("c", comm, path={path!r},
                                          async_save=False)
    resid = {{}}
    for step in range(3):
        opt.update(st, (rng.randn(8, 6).astype(np.float32),
                        rng.randint(0, 10, 8)), classification_loss(model),
                   has_aux=True)
        if step < 2 or r == 1:  # rank 1 holds one more step
            ckpt.save(st)
            resid[st.step] = {{k: v.tolist()
                               for k, v in st.ef_residual.items()}}
    model2, opt2, st2 = fresh(5)
    ckpt2 = create_multi_node_checkpointer("c", comm, path={path!r})
    common = ckpt2.latest_common_step()
    st2, _ = ckpt2.maybe_load(st2)
    json.dump({{"own": ckpt2.all_steps(), "common": common,
                "step": st2.step,
                "resid_ok": all(v.tolist() == resid[2][k]
                                for k, v in st2.ef_residual.items())}},
              open({path!r} + f"/rank{{r}}.json", "w"))
""")


def test_two_gloo_ranks_agree_on_the_latest_common_step(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(path=str(tmp_path)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script)], cwd=str(REPO),
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for pr in procs:
        out, _ = pr.communicate(timeout=180)
        assert pr.returncode == 0, out
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert got[0]["own"] == [1, 2] and got[1]["own"] == [1, 2, 3]
    assert [g["common"] for g in got] == [2, 2]
    assert [g["step"] for g in got] == [2, 2]
    assert all(g["resid_ok"] for g in got)
