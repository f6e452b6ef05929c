"""The port's ``Trainer`` and its extensions against the JAX package's
(``chainermn_tpu/training``), on the MNIST example's path.

The MLP (hidden (64, 64), 784 inputs, 10 classes) with bridged Flax
parameters (``mlp_params_from_flax``) trains 2 epochs of the synthetic
task (1024 examples, global batch 128, SGD 0.05 momentum 0.9) through
both packages' ``Trainer``; the JAX one on the conftest's 8-device CPU
mesh, the port's on one rank.  Every step's loss, read by a per-iteration
extension, within rtol 1e-5, and the parameters at the end within rtol
1e-5 + atol 1e-6 (fp32; the JAX step averages 8 device shards' gradients
where the port takes the whole batch's mean).  The ``LogReport`` entries
(keys, epochs, iterations; means within rtol 1e-5), the ticks at which
epoch and iteration triggers fire, and ``MetricsReport``'s JSONL keys and
steps are equal.  ``nan@grad`` poisons the same iteration in both, and
``flip@param`` corrupts the same element after the same update (the
losses after it still agree).

One 2-rank gloo spawn holds the rank-0 merged metrics feed: each rank's
entry verbatim under ``per_rank``, the counters summed.
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

import jax
import optax

import chainermn_tpu as cmn
from chainermn_tpu.datasets import make_synthetic_classification as jax_data
from chainermn_tpu.iterators import SerialIterator as JaxSerial
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import classification_loss as jax_cls_loss
from chainermn_tpu.resilience import faults as jax_faults
from chainermn_tpu import training as jax_training
from chainermn_tpu_torch import training
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import (
    make_synthetic_classification,
    scatter_dataset,
)
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import MLP, classification_loss
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd
from chainermn_tpu_torch.resilience import faults
from chainermn_tpu_torch.utils import mlp_params_from_flax, mlp_params_to_flax

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent
HIDDEN, N, BS, LR = (64, 64), 1024, 128, 0.05
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxMLP(hidden=HIDDEN, n_out=10)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, 784), np.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _recorder(store):
    def rec(tr):
        store.append(float(np.asarray(tr.last_metrics["loss"])))
    return rec


def jax_run(flax_params, stop=(2, "epoch"), fault=None, extra=()):
    model, params = flax_params
    comm = cmn.create_communicator("xla")
    ds = cmn.scatter_dataset(jax_data(N, 784, 10, seed=1), comm,
                             shuffle=True, seed=42)
    opt = cmn.create_multi_node_optimizer(optax.sgd(LR, momentum=0.9), comm)
    tr = jax_training.Trainer(opt, opt.init(params), jax_cls_loss(model),
                              JaxSerial(ds, BS, shuffle=True, seed=0),
                              stop=stop, has_aux=True)
    tr._fault_injector = fault
    losses = []
    tr.extend(jax_training.Extension(_recorder(losses), (1, "iteration")))
    for e in extra:
        tr.extend(e)
    tr.run()
    return tr, losses


def port_run(flax_params, stop=(2, "epoch"), fault=None, extra=()):
    _, params = flax_params
    comm = create_communicator("xla", device="cpu")
    ds = scatter_dataset(make_synthetic_classification(N, 784, 10, seed=1),
                         comm, shuffle=True, seed=42)
    model = MLP(hidden=HIDDEN, n_out=10, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params, device="cpu"))
    opt = create_multi_node_optimizer(sgd(LR, momentum=0.9), comm)
    tr = training.Trainer(opt, opt.init(model), classification_loss(model),
                          SerialIterator(ds, BS, shuffle=True, seed=0),
                          stop=stop, has_aux=True)
    tr._fault_injector = fault
    losses = []
    tr.extend(training.Extension(_recorder(losses), (1, "iteration")))
    for e in extra:
        tr.extend(e)
    tr.run()
    return tr, losses


def _port_params(tr):
    return mlp_params_to_flax({n: p for n, p in
                               tr.state.model.named_parameters()})


def test_mnist_mlp_trainer_matches_jax(flax_params):
    jtr, jl = jax_run(flax_params)
    ptr, pl = port_run(flax_params)
    assert len(pl) == len(jl) == 2 * N // BS
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    got = _port_params(ptr)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       err_msg=f"{layer}/{leaf}", **TOL)
    assert ptr.iteration == jtr.iteration and ptr.epoch == jtr.epoch == 2


def test_reports_and_trigger_ticks_match_jax(flax_params, tmp_path):
    def ticks(pkg, fired):
        def ext(trigger):
            def fn(tr):
                fired.append((trigger, tr.iteration, tr.epoch))
            return pkg.Extension(fn, trigger)
        return [ext((1, "epoch")), ext((3, "iteration")),
                ext((5, "iteration"))]

    runs = {}
    for name, run, pkg in (("jax", jax_run, jax_training),
                           ("port", port_run, training)):
        fired = []
        log = pkg.LogReport(trigger=(1, "epoch"),
                            out=str(tmp_path / name / "log.json"))
        mrep = pkg.MetricsReport(comm=None, trigger=(4, "iteration"),
                                 out_dir=str(tmp_path / name / "obs"))
        tr, _ = run(flax_params, stop=(10, "iteration"),
                    extra=[log, mrep, *ticks(pkg, fired)])
        feed = [json.loads(ln) for ln in
                (tmp_path / name / "obs" / "metrics.rank0.jsonl")
                .read_text().splitlines()]
        merged = [json.loads(ln) for ln in
                  (tmp_path / name / "obs" / "metrics.merged.jsonl")
                  .read_text().splitlines()]
        runs[name] = (log.log, fired, feed, merged,
                      json.loads((tmp_path / name / "log.json").read_text()))
    (jlog, jfired, jfeed, jmerged, jfile), (plog, pfired, pfeed, pmerged,
                                            pfile) = runs["jax"], runs["port"]
    assert pfired == jfired
    assert [sorted(e) for e in plog] == [sorted(e) for e in jlog]
    assert [(e["epoch"], e["iteration"]) for e in plog] == \
        [(e["epoch"], e["iteration"]) for e in jlog] == [(1, 8), (1, 10)]
    for pe, je in zip(plog, jlog):
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-5)
    assert [sorted(e) for e in pfile] == [sorted(e) for e in jfile]
    assert [e["step"] for e in pfeed] == [e["step"] for e in jfeed] \
        == [4, 8, 10]
    assert [sorted(e) for e in pfeed] == [sorted(e) for e in jfeed]
    assert [sorted(e["metrics"]) for e in pfeed] == \
        [sorted(e["metrics"]) for e in jfeed]
    for pe, je in zip(pfeed, jfeed):
        np.testing.assert_allclose(pe["metrics"]["loss"],
                                   je["metrics"]["loss"], rtol=1e-5)
    # The registry is per process: its counter grows by the iterations
    # between two lines.
    count = [e["registry"]["train.iterations"]["value"] for e in pfeed]
    assert np.diff(count).tolist() == [4, 2]
    assert [sorted(m) for m in pmerged] == [sorted(m) for m in jmerged]
    assert [m["per_rank"]["0"] for m in pmerged] == pfeed


@pytest.mark.parametrize("spec,site", [("nan@grad:3", "nan"),
                                       ("flip@param:5", "flip")])
def test_fail_silent_faults_hit_the_same_iteration(flax_params, spec, site):
    _, jl = jax_run(flax_params, stop=(8, "iteration"),
                    fault=jax_faults.FaultInjector(
                        jax_faults.parse_fault_spec(spec)))
    _, pl = port_run(flax_params, stop=(8, "iteration"),
                     fault=faults.FaultInjector(faults.parse_fault_spec(spec)))
    _, clean = port_run(flax_params, stop=(8, "iteration"))
    if site == "nan":
        assert [np.isnan(x) for x in pl] == [np.isnan(x) for x in jl]
        assert np.isnan(pl).tolist().index(True) == 2   # iteration 3
    else:
        # Same losses through update 5; from update 6 on both runs carry
        # the same corrupted element.
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        assert pl[:5] == clean[:5] and pl[5] != clean[5]


def test_trainer_refuses_unported_guards(flax_params):
    comm = create_communicator("xla", device="cpu")
    model = MLP(hidden=(4,), in_features=8, device="cpu")
    opt = create_multi_node_optimizer(sgd(0.1), comm)
    # The health guard is ported (tests/test_torch_guard.py holds it
    # against the JAX package); preemption is item 12b.
    with pytest.raises(NotImplementedError, match="item 12b"):
        training.Trainer(opt, opt.init(model), classification_loss(model),
                         iter([]), preemption_guard=object())
    with pytest.raises(NotImplementedError, match="item 13"):
        training.MetricsReport(device=True)


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import (make_synthetic_classification,
                                              scatter_dataset)
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer, sgd

    comm = create_communicator("naive", device="cpu")
    ds = scatter_dataset(make_synthetic_classification(256, 32, 10, seed=3),
                         comm, shuffle=True, seed=1)
    model = MLP(hidden=(16,), in_features=32, device="cpu")
    opt = create_multi_node_optimizer(sgd(0.1), comm)
    tr = training.Trainer(opt, opt.init(model), classification_loss(model),
                          SerialIterator(ds, 32, seed=comm.rank),
                          stop=(1, "epoch"), has_aux=True)
    tr.extend(training.MetricsReport(comm=comm, trigger=(2, "iteration"),
                                     out_dir={out!r}))
    tr.extend(training.LogReport())
    tr.run()
    print("RAN", comm.rank, tr.iteration, flush=True)
""")


def _spawn(script, n, timeout=180):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=timeout)
        assert pr.returncode == 0, out
        outs.append(out)
    return outs


def test_two_gloo_ranks_merge_their_metrics_on_rank_0(tmp_path):
    script = tmp_path / "worker.py"
    out = tmp_path / "obs"
    script.write_text(WORKER.format(tests=str(REPO / "tests"), out=str(out)))
    outs = _spawn(script, 2)
    # LogReport prints on rank 0 only.
    assert "epoch 1" in outs[0] and "epoch 1" not in outs[1]
    feeds = [[json.loads(ln) for ln in
              (out / f"metrics.rank{r}.jsonl").read_text().splitlines()]
             for r in range(2)]
    merged = [json.loads(ln) for ln in
              (out / "metrics.merged.jsonl").read_text().splitlines()]
    assert [m["step"] for m in merged] == [e["step"] for e in feeds[0]] \
        == [2, 4]
    for m, e0, e1 in zip(merged, *feeds):
        assert m["nranks"] == 2
        assert m["per_rank"] == {"0": e0, "1": e1}
        assert m["merged"]["train.iterations"]["value"] == \
            e0["registry"]["train.iterations"]["value"] + \
            e1["registry"]["train.iterations"]["value"]
        assert m["merged"]["train.loss"]["per_rank"] == \
            [e0["metrics"]["loss"], e1["metrics"]["loss"]]


@pytest.mark.parametrize("flags", [[], ["--double-buffering"],
                                   ["--grad-compression", "int8_ef"],
                                   ["--ema-decay", "0.9"]],
                         ids=["plain", "dbuf", "int8_ef", "ema"])
def test_train_mnist_twin_runs_on_cpu(flags, tmp_path, capsys):
    from chainermn_tpu_torch.examples import train_mnist

    base = ["--device", "cpu", "--epoch", "2", "--unit", "32",
            "--out", str(tmp_path / "log.json"),
            "--checkpoint", str(tmp_path / "ck")]
    tr, history = train_mnist.main(base + flags)
    log = tr.extensions[0].log
    assert [e["epoch"] for e in log] == [1, 2] and len(history) == 2
    assert all(np.isfinite(e["loss"]) for e in log)
    assert log[1]["loss"] < log[0]["loss"]
    assert all(0.0 <= h["val/accuracy"] <= 1.0 for h in history)
    assert json.loads((tmp_path / "log.json").read_text()) == log
    # A rerun with one more epoch resumes from the newest snapshot.
    tr2, history2 = train_mnist.main(base[:3] + ["3"] + base[4:] + flags)
    out = capsys.readouterr().out
    assert "resumed from iteration 64" in out
    assert tr2.iteration == 96 and len(history2) == 1
