"""The port's training-health guard against the JAX package's
(``chainermn_tpu/resilience/guard.py`` and the health check of
``chainermn_tpu/optimizers``; ``tests/resilience_tests/test_guard.py``
and ``tests/multiprocess_tests/test_health_guard.py``).

In the test process, on bridged Flax parameters (the JAX step on the
conftest's 8-device CPU mesh, the port's on one rank):

* ``make_train_step(health_check=True)`` over a warm-up, a NaN batch and
  a 1000x spike batch: ``step_ok`` and ``health_skipped`` exactly, the
  gradient norm and the ``(3,)`` carry within rtol 1e-6, the losses
  within rtol 1e-5 and the parameters at the end within rtol 1e-5 + atol
  1e-6 (SGD with momentum; AdamW with double buffering and an EMA);
* a skipped step leaves every tensor the step rewrites (parameters,
  buffers, optimizer state, the options' state) bit-equal, and the steps
  after it are bit-equal to a run that never saw its batch;
* the guard through both packages' ``Trainer`` (the MLP on the synthetic
  task, SGD 0.1 momentum 0.9): skip verdicts, votes, escalation without
  a checkpointer (exit 76), rollback from the known-good ring (the
  port's state restored into its own tensors, as a captured step needs),
  stragglers from peer statistics; ``guard_report`` keys and verdicts
  equal to JAX's; the ZeRO tier refused as JAX refuses it.

One 3-rank gloo job (``torch_rank_bodies.guard``) runs under
``launch.supervise``: ``nan@grad:5`` on rank 1 is skipped on every rank
and the run is bit-identical to an oracle that consumed batch 5 unseen;
``flip@param:7`` on rank 1 is named by the vote at 8, every rank rolls
back to known-good step 6 and the run ends bit-equal to an unfaulted
one; then a guard with no checkpointer exits 76 on every rank, which
``supervise`` counts against ``health_restarts`` (the crash allowance is
0) and relaunches.
"""

import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chainermn_tpu as cmn
from chainermn_tpu import training as jax_training
from chainermn_tpu.datasets import make_synthetic_classification as jax_data
from chainermn_tpu.extensions import (
    create_multi_node_checkpointer as jax_checkpointer,
)
from chainermn_tpu.iterators import SerialIterator as JaxSerial
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import classification_loss as jax_cls_loss
from chainermn_tpu.resilience import TrainingHealthGuard as JaxGuard
from chainermn_tpu.resilience import faults as jax_faults
from chainermn_tpu_torch import training
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import make_synthetic_classification
from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
from chainermn_tpu_torch.iterators import SerialIterator
from chainermn_tpu_torch.models import MLP, classification_loss
from chainermn_tpu_torch.optimizers import (
    adamw,
    create_multi_node_optimizer,
    create_zero_optimizer,
    seed_health,
    sgd,
)
from chainermn_tpu_torch.resilience import (
    HEALTH_EXIT_CODE,
    TrainingHealthGuard,
    faults,
    tree_digest,
)
from chainermn_tpu_torch.utils import mlp_params_from_flax, mlp_params_to_flax

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

D_IN, HID, N_OUT, B = 8, (8,), 4, 32
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxMLP(hidden=HID, n_out=N_OUT)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, D_IN), np.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    m = MLP(hidden=HID, n_out=N_OUT, in_features=D_IN, device="cpu")
    m.load_state_dict(mlp_params_from_flax(params, device="cpu"))
    return m


def _check_params(port_model, jax_params):
    got = mlp_params_to_flax(dict(port_model.named_parameters()))
    want = jax.tree_util.tree_map(np.asarray, jax_params)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf], want[layer][leaf],
                                       err_msg=f"{layer}/{leaf}", **TOL)


# ------------------------------------------------------ the in-step check
def _health_batches(n=9, nan_at=5, spike_at=7, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(1, n + 1):
        x = rng.randn(B, D_IN).astype(np.float32)
        y = rng.randint(0, N_OUT, size=B).astype(np.int32)
        if k == nan_at:
            x = np.full_like(x, np.nan)
        if k == spike_at:
            x = x * np.float32(1e3)
        out.append((x, y))
    return out


HEALTH_KW = dict(health_check=True, spike_warmup=3)
TXS = {"sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                        lambda: sgd(0.1, momentum=0.9), {}),
       "adamw_dbuf_ema": (lambda: optax.adamw(1e-2), lambda: adamw(1e-2),
                          dict(double_buffering=True, ema_decay=0.9))}


@pytest.mark.parametrize("tx", list(TXS))
def test_health_check_matches_jax(flax_params, tx):
    jm, params = flax_params
    jtx, ptx, opts = TXS[tx]
    batches = _health_batches()
    comm = cmn.create_communicator("xla")
    jopt = cmn.create_multi_node_optimizer(jtx(), comm, **opts)
    js = jopt.init(params)
    js = js.replace(health=comm.replicate(jnp.zeros(3, jnp.float32)))
    model = _port_model(params)
    popt = create_multi_node_optimizer(
        ptx(), create_communicator("xla", device="cpu"), **opts)
    ps = seed_health(popt.init(model))
    jloss, ploss = jax_cls_loss(jm), classification_loss(model)
    jrows, prows = [], []
    for b in batches:
        js, jmet = jopt.update(js, b, jloss, has_aux=True, **HEALTH_KW)
        ps, pmet = popt.update(ps, b, ploss, has_aux=True, **HEALTH_KW)
        for rows, met, h in ((jrows, jmet, js.health),
                             (prows, pmet, ps.health)):
            rows.append([float(np.asarray(met[k])) for k in
                         ("step_ok", "health_skipped", "grad_norm",
                          "loss")] + np.asarray(h).tolist())
    jrows, prows = np.array(jrows), np.array(prows)
    # The NaN step and the spike step are skipped, the rest taken.
    assert jrows[:, 0].tolist() == [1, 1, 1, 1, 0, 1, 0, 1, 1]
    np.testing.assert_array_equal(prows[:, :2], jrows[:, :2])
    np.testing.assert_allclose(prows[:, 2], jrows[:, 2], rtol=1e-6)
    np.testing.assert_allclose(prows[:, 3], jrows[:, 3], rtol=1e-5)
    np.testing.assert_allclose(prows[:, 4:], jrows[:, 4:], rtol=1e-6)
    _check_params(model, js.params)
    if "ema_decay" in opts:
        got = mlp_params_to_flax(ps.ema_params)
        for layer, leaves in js.ema_params.items():
            for leaf, v in leaves.items():
                np.testing.assert_allclose(got[layer][leaf], np.asarray(v),
                                           **TOL)


class _BNNet(torch.nn.Module):
    """A small net with buffers (batch norm's running statistics)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.net = torch.nn.Sequential(
            torch.nn.Linear(D_IN, 16), torch.nn.BatchNorm1d(16),
            torch.nn.ReLU(), torch.nn.Linear(16, N_OUT))

    def forward(self, x):
        return self.net(x)


def _bn_loss(model, batch):
    """Cross-entropy times the batch's weight: batch norm cancels a
    scaled input, so the spike scales the weight."""
    x, y, w = batch
    return torch.as_tensor(w).sum() * torch.nn.functional.cross_entropy(
        model(torch.as_tensor(x)), torch.as_tensor(y, dtype=torch.long))


NOOP_CASES = {
    "sgd_momentum_dbuf": (lambda: sgd(0.1, momentum=0.9),
                          dict(double_buffering=True)),
    "adamw_int8ef_ema": (lambda: adamw(1e-2),
                         dict(grad_compression="int8_ef", ema_decay=0.9)),
}


@pytest.mark.parametrize("case", list(NOOP_CASES))
def test_skipped_step_is_a_bit_equal_noop(case):
    """Every tensor the step rewrites in place, after the NaN step (5)
    and the spike step (7), equals its value before them bit for bit;
    the steps after them equal, bit for bit, a run that never saw
    batches 5 and 7."""
    tx, opts = NOOP_CASES[case]
    batches = [(x, y, np.full(1, 1e3 if k == 7 else 1.0, np.float32))
               for k, (x, y) in enumerate(_health_batches(spike_at=0), 1)]
    comm = create_communicator("xla", device="cpu")

    def run(skip_bad):
        model = _BNNet()
        opt = create_multi_node_optimizer(tx(), comm, **opts)
        st = seed_health(opt.init(model))
        step = opt.make_train_step(_bn_loss, **HEALTH_KW)
        out = []
        for k, b in enumerate(batches, 1):
            if skip_bad and k in (5, 7):
                continue
            before = {key: t.clone()
                      for key, t in opt._step_state(st).items()}
            st, met = step(st, b)
            after = opt._step_state(st)
            if k in (5, 7):
                assert float(met["step_ok"]) == 0.0, k
                assert set(after) == set(before)
                for key, t in after.items():
                    assert torch.equal(t, before[key]), (k, key)
            else:
                assert float(met["step_ok"]) == 1.0
            out.append({key: t.clone() for key, t in after.items()})
        return out, st

    guarded, st = run(False)
    oracle, _ = run(True)
    assert any(key[0] == "buffer" for key in guarded[-1])
    assert any(key[0] == "optimizer" for key in guarded[-1])
    # Guarded steps 6, 8, 9 against the oracle's 5th, 6th, 7th step.
    for g, o in ((guarded[5], oracle[4]), (guarded[7], oracle[5]),
                 (guarded[8], oracle[6])):
        for key in o:
            assert torch.equal(g[key], o[key]), key
    assert st.health.tolist()[1:] == [7.0, 2.0]


def test_zero_tier_is_refused():
    comm = create_communicator("xla", device="cpu")
    zopt = create_zero_optimizer(sgd(0.1), comm)
    jcomm = cmn.create_communicator("xla")
    jzopt = cmn.create_zero_optimizer(optax.sgd(0.1), jcomm)
    errors = []
    for guard, opt in ((TrainingHealthGuard(), zopt), (JaxGuard(), jzopt)):
        with pytest.raises(TypeError) as e:
            guard.bind(types.SimpleNamespace(optimizer=opt, step_kwargs={},
                                             state=None))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "ZeroMultiNodeOptimizer" in errors[0]
    # The step itself: JAX's ZeRO step takes no health check either.
    with pytest.raises(TypeError):
        jzopt.make_train_step(lambda p, b: 0.0, health_check=True)
    with pytest.raises(TypeError, match="no health check"):
        zopt.make_train_step(lambda m, b: 0.0, health_check=True)


# ------------------------------------------------ the guard in the Trainer
def _jax_trainer(flax_params, guard, stop=8, fault=None, extensions=()):
    model, params = flax_params
    comm = cmn.create_communicator("xla")
    opt = cmn.create_multi_node_optimizer(optax.sgd(0.1, momentum=0.9),
                                          comm)
    tr = jax_training.Trainer(
        opt, opt.init(params), jax_cls_loss(model),
        JaxSerial(jax_data(128, D_IN, N_OUT, seed=3), B, shuffle=True,
                  seed=5),
        stop=(stop, "iteration"), has_aux=True, health_guard=guard,
        extensions=list(extensions))
    tr._fault_injector = (jax_faults.FaultInjector(
        jax_faults.parse_fault_spec(fault)) if fault else None)
    return tr


def _port_trainer(flax_params, guard, stop=8, fault=None, extensions=()):
    _, params = flax_params
    model = _port_model(params)
    opt = create_multi_node_optimizer(sgd(0.1, momentum=0.9),
                                      create_communicator("xla",
                                                          device="cpu"))
    tr = training.Trainer(
        opt, opt.init(model), classification_loss(model),
        SerialIterator(make_synthetic_classification(128, D_IN, N_OUT,
                                                     seed=3), B,
                       shuffle=True, seed=5),
        stop=(stop, "iteration"), has_aux=True, health_guard=guard,
        extensions=list(extensions))
    tr._fault_injector = (faults.FaultInjector(
        faults.parse_fault_spec(fault)) if fault else None)
    return tr


def _digests(pkg, store):
    def cap(tr):
        store[tr.iteration] = tree_digest(tr.state.params) \
            if pkg is training else \
            jax.tree_util.tree_map(np.asarray, tr.state.params)
    return pkg.Extension(cap, (1, "iteration"))


def _same_report(port, jax_rep):
    """Equal keys throughout; equal verdicts (the timing statistics aside:
    their keys and counts only)."""
    assert sorted(port) == sorted(jax_rep)
    for k in ("rank", "skips", "votes", "rollbacks", "stragglers",
              "last_divergence", "peer_step_time"):
        assert port[k] == jax_rep[k], k
    assert sorted(port["step_time"]) == sorted(jax_rep["step_time"])
    assert port["step_time"]["n"] == jax_rep["step_time"]["n"]


SCENARIOS = {
    "nan": ("nan@grad:3", dict(spike_warmup=3), 8),
    "spike": ("spike@loss:5", dict(spike_warmup=2, spike_factor=10.0), 8),
    "two_skips": ("nan@grad:2;nan@grad:4", dict(skip_budget=1,
                                                spike_warmup=4), 8),
    "votes": (None, dict(vote_every=2), 4),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_guard_verdicts_and_report_match_jax(flax_params, scenario):
    fault, kw, stop = SCENARIOS[scenario]
    jd, pd = {}, {}
    jg, pg = JaxGuard(**kw), TrainingHealthGuard(**kw)
    jtr = _jax_trainer(flax_params, jg, stop, fault,
                       [_digests(jax_training, jd)])
    ptr = _port_trainer(flax_params, pg, stop, fault,
                        [_digests(training, pd)])
    jtr.run()
    ptr.run()
    _same_report(pg.guard_report(), jg.guard_report())
    np.testing.assert_allclose(np.asarray(ptr.state.health),
                               np.asarray(jtr.state.health), rtol=1e-6)
    for it in pg.guard_report()["skips"]["steps"]:
        assert pd[it] == pd[it - 1]            # the skipped step: a no-op
        assert pd[it + 1] != pd[it]            # and training went on
    _check_params(ptr.state.model, jtr.state.params)


def test_skip_budget_escalates_without_checkpointer(flax_params):
    raised = []
    for make, guard in ((_jax_trainer, JaxGuard(skip_budget=2,
                                                 spike_warmup=3)),
                        (_port_trainer, TrainingHealthGuard(
                            skip_budget=2, spike_warmup=3))):
        tr = make(flax_params, guard,
                  fault="nan@grad:2;nan@grad:3;nan@grad:4")
        with pytest.raises(SystemExit) as e:
            tr.run()
        raised.append((e.value.code, e.value.reason, e.value.iteration,
                       guard.guard_report()["skips"]))
    assert raised[0] == raised[1]
    assert raised[1][0] == HEALTH_EXIT_CODE == 76
    assert "skip budget" in raised[1][1]


def test_rollback_restores_in_place_and_matches_jax(flax_params, tmp_path):
    """A skip storm (nan@grad:4,5, budget 1) escalates at iteration 5;
    both packages roll back to known-good step 4 and finish the 8
    iterations.  The port restores into the tensors the step already
    rewrites in place (a captured step replays on their addresses): the
    same tensors, before and after, hold the rolled-back run's state."""
    fault = "nan@grad:4;nan@grad:5"
    kw = dict(skip_budget=1, spike_warmup=3, vote_every=1)
    jg, pg = JaxGuard(**kw), TrainingHealthGuard(**kw)
    jck = jax_checkpointer("guard", cmn.create_communicator("xla"),
                           path=str(tmp_path / "jax"),
                           trigger=(1, "iteration"), async_save=False)
    pck = create_multi_node_checkpointer(
        "guard", create_communicator("xla", device="cpu"),
        path=str(tmp_path / "port"), trigger=(1, "iteration"),
        async_save=False)
    jtr = _jax_trainer(flax_params, jg, fault=fault, extensions=[jck])
    ptr = _port_trainer(flax_params, pg, fault=fault, extensions=[pck])
    opt = ptr.optimizer
    seen = {}

    def addresses(tr):
        if tr.iteration == 1:
            seen["first"] = {k: t.data_ptr() for k, t in
                             opt._step_state(tr.state).items()}
    ptr.extend(training.Extension(addresses, (1, "iteration")))
    jtr.run()
    ptr.run()
    jck.finalize(jtr)
    pck.finalize(ptr)
    _same_report(pg.guard_report(), jg.guard_report())
    ev = pg.guard_report()["rollbacks"]["events"]
    assert [(e["at_iteration"], e["step"]) for e in ev] == [(5, 4)]
    assert ptr.iteration == jtr.iteration == 8
    assert pck.all_steps()[-1] == 8 and pck.latest_known_good() == 8
    assert pck.known_good_steps() == jck.known_good_steps()
    now = {k: t.data_ptr() for k, t in opt._step_state(ptr.state).items()}
    assert now == seen["first"]
    assert any(k[0] == "optimizer" for k in now)
    _check_params(ptr.state.model, jtr.state.params)
    np.testing.assert_allclose(np.asarray(ptr.state.health),
                               np.asarray(jtr.state.health), rtol=1e-6)
    jck.close()


class _StatsDetectorStub:
    def __init__(self, peers):
        self._peers = peers
        self.local = None

    def set_local_stats(self, stats):
        self.local = stats

    def peer_stats(self):
        return dict(self._peers)


def test_straggler_flagged_from_peer_stats(flax_params):
    peers = {1: {"mean_ms": 10.0}, 2: {"mean_ms": 11.0},
             3: {"mean_ms": 95.0}}
    reports = []
    for make, guard_cls in ((_jax_trainer, JaxGuard),
                            (_port_trainer, TrainingHealthGuard)):
        stub = _StatsDetectorStub(peers)
        guard = guard_cls(detector=stub, stats_every=2,
                          straggler_factor=3.0)
        make(flax_params, guard, stop=2).run()
        reports.append(guard.guard_report())
        assert stub.local is not None and stub.local["n"] == 2
    assert reports[1]["stragglers"] == reports[0]["stragglers"]
    assert reports[1]["stragglers"][3]["mean_ms"] == 95.0
    assert reports[1]["peer_step_time"] == reports[0]["peer_step_time"]


# ------------------------------------------------- across 3 ranks, supervised
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("guard")
    res = run_ranks("guard", out, 3,
                    supervised=dict(restarts=0, health_restarts=1))
    return res, pathlib.Path(out)


def test_nan_on_one_rank_is_skipped_everywhere_bit_identical_to_oracle(
        ranks):
    res, _ = ranks
    for r in res:
        f, o = r["nan"], r["nan_oracle"]
        assert f["report"]["skips"]["steps"] == [5]
        assert f["step_ok"][5] == 0.0 and np.isnan(f["losses"][5])
        for k in range(1, 5):
            assert f["losses"][k] == o["losses"][k], k
        # After the skip the faulted run is the oracle one batch behind,
        # bit for bit.
        for k in range(6, 13):
            assert f["losses"][k] == o["losses"][k - 1], k
        assert f["final_digest"] == o["final_digest"]
        assert f["report"]["rollbacks"]["count"] == 0
        assert all(v["clean"] for v in f["report"]["votes"])
    assert len({r["nan"]["final_digest"] for r in res}) == 1


def test_flip_is_localized_rolled_back_and_resumed_bit_exact(ranks):
    res, _ = ranks
    for r in res:
        rep = r["flip"]["report"]
        dirty = [v for v in rep["votes"] if not v["clean"]]
        assert dirty == [{"step": 8, "clean": False, "divergent": [1],
                          "no_majority": False}]
        assert rep["last_divergence"]["divergent"] == [1]
        assert [(e["step"], e["at_iteration"])
                for e in rep["rollbacks"]["events"]] == [(6, 8)]
        assert r["flip"]["final_iteration"] == 12
        assert 12 in r["flip"]["known_good"]
        # Restored into the step's own tensors.
        assert r["flip"]["addresses_kept"]
        assert r["plain"]["report"]["rollbacks"]["count"] == 0
    assert {r["flip"]["final_digest"] for r in res} == \
        {res[0]["plain"]["final_digest"]}


def test_unrecoverable_guard_exits_76_counted_as_health(ranks):
    """Every rank escalated with no checkpointer and exited 76; the
    supervisor, with no crash allowance, relaunched on its health
    allowance and the relaunch ended clean (``run_ranks`` saw 0)."""
    _, out = ranks
    for r in range(3):
        code, it, reason = (out / f"guard.escalation.rank{r}").read_text() \
            .split(" ", 2)
        assert (int(code), int(it)) == (HEALTH_EXIT_CODE, 2)
        assert reason.startswith("skip budget exhausted")
        assert (out / f"guard.attempt1.rank{r}").read_text() == \
            "relaunched"
