"""The port's preemption guard against the JAX package's
(``chainermn_tpu/resilience/preemption.py``;
``tests/resilience_tests/test_preemption.py``,
``tests/serving_tests/test_disagg.py::test_preemption_drain_zero_loss_oracle``
and ``tests/multiprocess_tests/test_resilience.py::test_preemption_emergency_checkpoint_and_resume``).

In the test process: the exit code and interrupt, the signal that only
sets a flag, the vote and its cadence (the same iterations voted as the
JAX guard under the same polls), the emergency save before the exit,
the replicator's flush before the save; the trainer polls it last; the
serving drain a role binds with ``guard.attach_drain`` (a decode role's,
a prefill role's) migrates every live request to its peer, and the
union of completions equals the JAX run's and the undrained run's; ``shutdown_distributed`` ends a gloo group.

One 2-rank gloo job under ``launch.supervise``
(``torch_rank_bodies.preempt``): rank 1 signals itself at 6, every rank
saves at 6 and exits 75 (the flight record says ``preemption_exit``),
the relaunch resumes at 6 and ends bit for bit on the unfaulted run's
parameters and AdamW state.
"""

import json
import os
import pathlib
import signal
import time

import pytest
import torch

from chainermn_tpu.resilience import PreemptionGuard as JaxGuard
from chainermn_tpu.resilience import PreemptionInterrupt as JaxInterrupt
from chainermn_tpu_torch.resilience import (
    PREEMPTION_EXIT_CODE,
    PreemptionGuard,
    PreemptionInterrupt,
)
from torch_fleet_common import (
    FixedClock,
    assert_same,
    build_models,
    jax_pkg,
    make_prompts,
    port_pkg,
    tokens_of,
)
from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1


class FakeTrainer:
    def __init__(self, iteration=7):
        self.iteration = iteration
        self.extensions = []


class FakeCheckpointer:
    def __init__(self):
        self.saved_at = []

    def emergency_save(self, trainer):
        self.saved_at.append(int(trainer.iteration))
        return int(trainer.iteration)


def test_exit_code_is_distinguished():
    assert PREEMPTION_EXIT_CODE == 75
    assert PREEMPTION_EXIT_CODE not in (0, 1, 2)
    assert PREEMPTION_EXIT_CODE < 128


def test_interrupt_is_system_exit_with_code():
    exc = PreemptionInterrupt(42)
    assert isinstance(exc, SystemExit)
    assert exc.code == PREEMPTION_EXIT_CODE == JaxInterrupt(42).code
    assert exc.iteration == 42


def test_signal_sets_flag_without_raising():
    with PreemptionGuard() as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        while not guard.preempted and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.preempted
    assert signal.getsignal(signal.SIGTERM) is not guard._on_signal


def test_poll_quiet_until_flagged():
    ckpt = FakeCheckpointer()
    PreemptionGuard(checkpointer=ckpt).poll(FakeTrainer(iteration=3))
    assert ckpt.saved_at == []


def test_poll_saves_then_raises_with_agreed_iteration():
    ckpt = FakeCheckpointer()
    guard = PreemptionGuard(checkpointer=ckpt)
    guard.request()
    with pytest.raises(PreemptionInterrupt) as ei:
        guard.poll(FakeTrainer(iteration=9))
    assert ei.value.code == PREEMPTION_EXIT_CODE
    assert ei.value.iteration == 9
    assert ckpt.saved_at == [9]


def test_poll_finds_checkpointer_in_trainer_extensions():
    from chainermn_tpu_torch.extensions.checkpoint import (
        MultiNodeCheckpointer,
    )

    class InlineCkpt(MultiNodeCheckpointer):
        def __init__(self):
            self.saved_at = []

        def emergency_save(self, trainer):
            self.saved_at.append(int(trainer.iteration))
            return int(trainer.iteration)

    tr = FakeTrainer(iteration=4)
    ckpt = InlineCkpt()
    tr.extensions.append(ckpt)
    guard = PreemptionGuard()
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(tr)
    assert ckpt.saved_at == [4]


def test_poll_without_checkpointer_still_exits():
    guard = PreemptionGuard()
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(FakeTrainer())


@pytest.mark.parametrize("check_every,flag_at", [(4, 6), (1, 3), (3, 9)])
def test_vote_cadence_matches_jax(check_every, flag_at):
    """Both guards over the same polls (the flag raised at ``flag_at``):
    the same iterations vote and the same one exits."""

    def drive(guard_cls, interrupt):
        votes = []

        class Counting(guard_cls):
            def _vote(self):
                votes.append(it)
                return super()._vote()

        guard = Counting(checkpointer=FakeCheckpointer(),
                         check_every=check_every)
        for it in range(1, 13):
            if it == flag_at:
                guard.request()
            try:
                guard.poll(FakeTrainer(iteration=it))
            except interrupt as e:
                return votes, e.iteration, e.code
        return votes, None, None

    assert drive(PreemptionGuard, PreemptionInterrupt) == \
        drive(JaxGuard, JaxInterrupt)


def test_vote_uses_hostcomm_style_callable_op():
    class ObjComm:
        size = 2

        def __init__(self):
            self.called = []

        def allreduce_obj(self, obj, op):
            assert callable(op)
            self.called.append(obj)
            return op(obj, 1)  # the peer voted yes

    comm = ObjComm()
    guard = PreemptionGuard(comm=comm, checkpointer=FakeCheckpointer())
    with pytest.raises(PreemptionInterrupt):
        guard.poll(FakeTrainer(iteration=2))
    assert comm.called == [0]


def test_repeat_signal_is_idempotent():
    ckpt = FakeCheckpointer()
    guard = PreemptionGuard(checkpointer=ckpt)
    guard.request()
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(FakeTrainer(iteration=5))
    assert ckpt.saved_at == [5]


def test_check_every_validation():
    with pytest.raises(ValueError):
        PreemptionGuard(check_every=0)


# --------------------------------------------------- replication ordering
def test_replication_flush_lands_before_emergency_save(tmp_path):
    from chainermn_tpu_torch.resilience.replicate import ShardReplicator

    events = []

    class OrderCkpt(FakeCheckpointer):
        def emergency_save(self, trainer):
            events.append(("ckpt", int(trainer.iteration)))
            return super().emergency_save(trainer)

    class OrderRep(ShardReplicator):
        def flush_local(self, trainer):
            events.append(("rep", int(trainer.iteration)))
            return super().flush_local(trainer)

    rep = OrderRep(None, every=4, spill_dir=str(tmp_path),
                   _use_process_injector=False)
    from chainermn_tpu_torch.optimizers import TrainState

    model = torch.nn.Linear(3, 1)
    tr = FakeTrainer(iteration=5)
    tr.state = TrainState(step=5, model=model,
                          optimizer=torch.optim.SGD(model.parameters(),
                                                    lr=0.1))
    tr.train_iter = None
    guard = PreemptionGuard(checkpointer=OrderCkpt())
    guard.attach_replicator(rep)
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(tr)
    assert events == [("rep", 5), ("ckpt", 5)]
    assert sorted(rep.inventory()["own"]) == [5]


def test_replication_flush_failure_does_not_block_emergency_save(tmp_path):
    from chainermn_tpu_torch.resilience.replicate import ShardReplicator

    class BrokenRep(ShardReplicator):
        def flush_local(self, trainer):
            raise RuntimeError("spill disk gone")

    rep = BrokenRep(None, every=4, spill_dir=str(tmp_path),
                    _use_process_injector=False)
    ckpt = FakeCheckpointer()
    guard = PreemptionGuard(checkpointer=ckpt)
    guard.attach_replicator(rep)
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(FakeTrainer(iteration=6))
    assert ckpt.saved_at == [6]


def test_poll_finds_replicator_in_trainer_extensions(tmp_path):
    from chainermn_tpu_torch.resilience.replicate import ShardReplicator

    flushed = []

    class TrackingRep(ShardReplicator):
        def flush_local(self, trainer):
            flushed.append(int(trainer.iteration))
            return int(trainer.iteration)

    tr = FakeTrainer(iteration=9)
    tr.extensions.append(TrackingRep(None, every=2, spill_dir=str(tmp_path),
                                     _use_process_injector=False))
    guard = PreemptionGuard(checkpointer=FakeCheckpointer())
    guard.request()
    with pytest.raises(PreemptionInterrupt):
        guard.poll(tr)
    assert flushed == [9]


# ------------------------------------------------------ the serving drain
def drain_scenario(pkg, prompts, preempt=True):
    """Prefill rank 0 feeds decode rank 1; rank 1 is guarded and drains
    to decode rank 2 when preempted (after every request reached it)."""
    guard_cls, interrupt = (
        (PreemptionGuard, PreemptionInterrupt) if pkg.name == "port"
        else (JaxGuard, JaxInterrupt))
    comm, clock = pkg.LocalComm(3), FixedClock()
    regs = [pkg.MetricsRegistry() for _ in range(3)]
    trs = [pkg.MigrationTransport(comm.endpoint(i), registry=regs[i])
           for i in range(3)]
    kw = dict(capacity=3, num_blocks=48, prefill_chunk=16)

    def sched(i):
        return pkg.Scheduler(pkg.engine(**kw), registry=regs[i], clock=clock)

    guard = guard_cls()
    pre = pkg.PrefillRole(sched(0), trs[0], decode_ranks=[1])
    d1 = pkg.DecodeRole(sched(1), trs[1], prefill_ranks=[0], guard=guard)
    guard.attach_drain(lambda: d1.drain(2))
    d2 = pkg.DecodeRole(sched(2), trs[2], prefill_ranks=[], peer_ranks=[1])
    for i, p in enumerate(prompts):
        pre.submit(pkg.Request(id=i, prompt=p, max_new_tokens=8))
    while pre.pending:
        d1.tick()
        pre.tick()
    pre.finish()
    out = {"exit": None}
    if preempt:
        for _ in range(2):
            d1.tick()
        guard.request()
        with pytest.raises(interrupt) as ei:
            for _ in range(64):
                d1.tick()
        out["exit"] = ei.value.code
        out["migrated"] = regs[1].peek(
            "serve.migration.slots_migrated").value
        done = list(d2.run_loop(poll_ms=0))
    else:
        done = list(d1.run_loop(poll_ms=0))
    done += list(pre.sched.completions) + list(d1.sched.completions)
    out.update(ids=sorted(c.id for c in done), tokens=tokens_of(done))
    return out


def test_decode_role_drain_to_peer_zero_loss_matches_jax():
    models = build_models()
    prompts = make_prompts()
    port, ref = port_pkg(models), jax_pkg(models)
    got = drain_scenario(port, prompts)
    assert_same(got, drain_scenario(ref, prompts))
    assert got["exit"] == PREEMPTION_EXIT_CODE and got["migrated"] > 0
    assert got["ids"] == list(range(len(prompts)))
    undrained = drain_scenario(port, prompts, preempt=False)
    assert got["tokens"] == undrained["tokens"]


def prefill_drain_scenario(pkg, prompts, preempt=True):
    """Prefill rank 0, guarded, feeds decode ranks 1 and 2; preempted after
    its second tick, it drains to rank 1 and every decode rank gets its
    eof, so both decode loops end."""
    guard_cls, interrupt = (
        (PreemptionGuard, PreemptionInterrupt) if pkg.name == "port"
        else (JaxGuard, JaxInterrupt))
    comm, clock = pkg.LocalComm(3), FixedClock()
    regs = [pkg.MetricsRegistry() for _ in range(3)]
    trs = [pkg.MigrationTransport(comm.endpoint(i), registry=regs[i])
           for i in range(3)]
    kw = dict(capacity=3, num_blocks=48, prefill_chunk=16)

    def sched(i):
        return pkg.Scheduler(pkg.engine(**kw), registry=regs[i], clock=clock)

    guard = guard_cls()
    pre = pkg.PrefillRole(sched(0), trs[0], decode_ranks=[1, 2],
                          guard=guard)
    guard.attach_drain(lambda: pre.drain(1))
    decs = [pkg.DecodeRole(sched(i), trs[i], prefill_ranks=[0])
            for i in (1, 2)]
    for i, p in enumerate(prompts):
        pre.submit(pkg.Request(id=i, prompt=p, max_new_tokens=8))
    out = {"exit": None}
    if preempt:
        for _ in range(2):
            pre.tick()
        out["held"] = len(pre.sched._queue) + sum(
            s is not None for s in pre.sched._slots)
        guard.request()
        with pytest.raises(interrupt) as ei:
            pre.tick()
        out["exit"] = ei.value.code
        out["left"] = pre.sched.pending
    else:
        while pre.pending:
            pre.tick()
        pre.finish()
    done = list(pre.sched.completions)
    for d in decs:
        done += list(d.run_loop(poll_ms=0))
    out.update(ids=sorted(c.id for c in done), tokens=tokens_of(done))
    return out


def test_prefill_role_preempted_drains_and_eofs_every_decode_rank():
    """The drain a prefill role binds with ``guard.attach_drain``: on the
    tick after the flag, everything it holds goes to one decode rank,
    every decode rank it feeds gets the eof, the rank exits 75, and the
    completions are the JAX run's and the undrained run's."""
    models = build_models()
    prompts = make_prompts()
    port, ref = port_pkg(models), jax_pkg(models)
    got = prefill_drain_scenario(port, prompts)
    assert_same(got, prefill_drain_scenario(ref, prompts))
    assert got["exit"] == PREEMPTION_EXIT_CODE and not got["left"]
    assert got["held"] > 0  # the drain had live work to move
    assert got["ids"] == list(range(len(prompts)))
    undrained = prefill_drain_scenario(port, prompts, preempt=False)
    assert got["tokens"] == undrained["tokens"]


# ---------------------------------------------------------- the trainer
def test_trainer_polls_the_guard_and_exits_after_the_save(tmp_path):
    """``Trainer(preemption_guard=)``: the vote at the iteration the flag
    went up, the checkpointer's emergency save at it, then exit 75; a
    resumed run ends where the unpreempted one does, bit for bit."""
    from chainermn_tpu_torch.comm import create_communicator
    from chainermn_tpu_torch.datasets import make_synthetic_classification
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.iterators import SerialIterator
    from chainermn_tpu_torch.models import MLP, classification_loss
    from chainermn_tpu_torch.optimizers import (
        adamw,
        create_multi_node_optimizer,
    )
    from chainermn_tpu_torch.resilience import tree_digest
    from chainermn_tpu_torch.training import Extension, Trainer

    comm = create_communicator("naive", device="cpu")
    ds = make_synthetic_classification(256, 8, 4, seed=9)

    def trainer(guard=None, exts=()):
        model = MLP(hidden=(8,), n_out=4, in_features=8, device="cpu")
        opt = create_multi_node_optimizer(adamw(1e-2), comm)
        return Trainer(opt, opt.init(model), classification_loss(model),
                       SerialIterator(ds, 32, shuffle=True, seed=2),
                       stop=(10, "iteration"), has_aux=True,
                       extensions=list(exts), preemption_guard=guard)

    oracle = trainer()
    oracle.run()
    guard = PreemptionGuard(comm=comm)
    ckpt = create_multi_node_checkpointer(
        "p", comm, path=str(tmp_path), trigger=(4, "iteration"),
        async_save=False)
    tr = trainer(guard, [ckpt, Extension(
        lambda t: guard.request() if t.iteration == 5 else None,
        (1, "iteration"))])
    with pytest.raises(PreemptionInterrupt) as ei:
        tr.run()
    assert (ei.value.code, ei.value.iteration) == (75, 5)
    assert ckpt.all_steps() == [4, 5]
    again = trainer(exts=[create_multi_node_checkpointer(
        "p", comm, path=str(tmp_path), trigger=(4, "iteration"),
        async_save=False)])
    _, it = again.extensions[0].maybe_load(again.state, again)
    again.run()
    assert it == 5 and again.iteration == 10
    assert tree_digest(again.state.params) == tree_digest(
        oracle.state.params)


def test_shutdown_distributed_ends_the_group():
    import torch.distributed as dist

    from chainermn_tpu_torch import distributed

    had = dist.is_initialized()
    if not had:
        distributed.init_distributed("gloo")
    assert distributed.is_initialized()
    distributed.shutdown_distributed()
    assert not distributed.is_initialized() and not dist.is_initialized()
    distributed.shutdown_distributed()  # a no-op once gone
    if had:
        distributed.init_distributed("gloo")


# -------------------------------------------------------- the gloo job
@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("preempt")
    run_ranks("preempt", out, nproc=2, timeout_s=120,
              supervised=dict(restarts=0, preempt_restarts=1))
    return out


def test_preempted_job_exits_75_and_resumes_bitwise(job):
    import pickle

    for r in range(2):
        with open(job / f"preempt.attempt0.rank{r}.pkl", "rb") as f:
            oracle = pickle.load(f)["oracle"]
        with open(job / f"preempt.rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert res["resumed"] == 6 and res["iteration"] == 12
        assert 6 in res["steps_saved"]
        assert res["state_digest"] == oracle["state_digest"]
        assert res["params_digest"] == oracle["params_digest"]


def test_preempted_job_flight_record_names_the_exit(job):
    records = []
    for path in pathlib.Path(job / "flight").rglob("flight.rank*.jsonl"):
        for line in path.read_text().splitlines():
            records.append(json.loads(line))
    reasons = {rec.get("reason") for rec in records}
    assert "preemption_exit" in reasons, reasons
