"""The port's multi-node evaluator against the JAX package's
(``chainermn_tpu/extensions/evaluator.py``).

The small MLP with bridged parameters evaluates ``classification_metrics``
(per-example loss and accuracy) over a validation set whose last batch is
ragged (97 examples, batch 16: six full batches and one of 1).  The JAX
evaluator runs on the conftest's 8-device CPU mesh (its batches padded to
a multiple of 8 and masked); the port's on one rank and, in one spawn, on
two gloo ranks over ``scatter_dataset(..., force_equal_length=False)``
shards of 49 and 48 examples, which take 4 and 3 batches: every rank
still runs one reduction, and the sums over both equal the one-rank
pass.  The mean path and a ``finalize=`` path (summed statistics and the
example count) within rtol 1e-6; counts exactly.
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

import chainermn_tpu as cmn
from chainermn_tpu.extensions import Evaluator as JaxEvaluator
from chainermn_tpu.iterators import SerialIterator as JaxSerial
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import classification_metrics as jax_metrics
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import ArrayDataset
from chainermn_tpu_torch.extensions import (
    Evaluator,
    create_multi_node_evaluator,
)
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import MLP, classification_metrics
from chainermn_tpu_torch.utils import mlp_params_from_flax

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

REPO = pathlib.Path(__file__).resolve().parent.parent
N, BS, D_IN = 97, 16, 12


def finalize(sums, count):
    return {"loss_sum": sums["val/loss"], "correct": sums["val/accuracy"],
            "count": count}


@pytest.fixture(scope="module")
def setup():
    model = JaxMLP(hidden=(8,), n_out=10)
    params = model.init(jax.random.PRNGKey(1),
                        np.zeros((1, D_IN), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(3)
    data = (rng.randn(N, D_IN).astype(np.float32),
            rng.randint(0, 10, size=N).astype(np.int32))
    comm = cmn.create_communicator("xla")
    want = {}
    for name, fin in (("mean", None), ("finalize", finalize)):
        ev = JaxEvaluator(lambda: JaxSerial(cmn.datasets.ArrayDataset(*data),
                                            BS, repeat=False, shuffle=False),
                          jax_metrics(model), comm, finalize=fin)
        want[name] = {k: float(v) for k, v in ev.evaluate(params).items()}
    return params, data, want


def _port_eval(params, data, comm, fin):
    model = MLP(hidden=(8,), in_features=D_IN, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params, device="cpu"))
    ev = create_multi_node_evaluator(
        Evaluator(lambda: SerialIterator(data, BS, repeat=False,
                                         shuffle=False),
                  classification_metrics(model), comm, finalize=fin), comm)
    return ev.evaluate(model), ev.batches


def test_mask_exact_mean_and_finalize_match_jax_on_one_rank(setup):
    params, data, want = setup
    comm = create_communicator("xla", device="cpu")
    for name, fin in (("mean", None), ("finalize", finalize)):
        got, batches = _port_eval(params, ArrayDataset(*data), comm, fin)
        assert batches == 7
        assert sorted(got) == sorted(want[name])
        for k in want[name]:
            np.testing.assert_allclose(got[k], want[name][k], rtol=1e-6,
                                       err_msg=f"{name} {k}")
    assert got["count"] == N


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import ArrayDataset, scatter_dataset
    from chainermn_tpu_torch.extensions import (Evaluator,
                                                create_multi_node_evaluator)
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_metrics
    import torch

    f = np.load({data!r})
    comm = create_communicator("naive", device="cpu")
    shard = scatter_dataset(ArrayDataset(f["x"], f["y"]), comm,
                            force_equal_length=False)
    model = MLP(hidden=(8,), in_features={d_in}, device="cpu")
    model.load_state_dict({{k[2:]: torch.from_numpy(f[k]) for k in f.files
                           if k.startswith("p:")}})

    def fin(sums, count):
        return {{"loss_sum": sums["val/loss"],
                 "correct": sums["val/accuracy"], "count": count}}

    out = {{"shard": len(shard)}}
    for name, fn in (("mean", None), ("finalize", fin)):
        ev = create_multi_node_evaluator(Evaluator(
            lambda: SerialIterator(shard, {bs}, repeat=False, shuffle=False),
            classification_metrics(model), comm, finalize=fn), comm)
        out[name] = ev.evaluate(model)
        out["batches"] = ev.batches
    json.dump(out, open({out!r} + f"/rank{{comm.rank}}.json", "w"))
""")


def test_two_gloo_ranks_with_ragged_shards_match_jax(setup, tmp_path):
    params, data, want = setup
    sd = mlp_params_from_flax(params, device="cpu")
    np.savez(tmp_path / "data.npz", x=data[0], y=data[1],
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(tests=str(REPO / "tests"),
                                    data=str(tmp_path / "data.npz"),
                                    d_in=D_IN, bs=BS, out=str(tmp_path)))
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
    assert [g["shard"] for g in got] == [49, 48]
    assert [g["batches"] for g in got] == [4, 3]
    for g in got:
        for name in ("mean", "finalize"):
            for k in want[name]:
                np.testing.assert_allclose(g[name][k], want[name][k],
                                           rtol=1e-6, err_msg=f"{name} {k}")
        assert g["finalize"]["count"] == N
