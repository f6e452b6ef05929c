"""The comparison that decides ``correct``, seen to fail: each cell run on
the CPU at a tiny size with its timed path broken underneath, and with
the control (the plain reference in float8) in the program's place.

Each fault the cell can have: a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; a served token
altered where it is produced.  (No cell spans chips, so none can leave
out the exchange between them.)"""

import pytest

from portbench import judge, tiny
from portbench.drivers import train
from portbench.reference.lowp import e4m3

TRAIN = ["resnet50.train.b256", "gpt2-xl.train.s1024-b16"]
SERVE = ["gpt2-xl.serve.closed128"]


def _unchanged(monkeypatch):
    """Every train step built from here on computes its loss and returns
    the state as it was."""
    from chainermn_tpu_torch.optimizers import MultiNodeOptimizer

    make = MultiNodeOptimizer.make_train_step

    def broken(self, loss_fn, *a, **kw):
        make(self, loss_fn, *a, **kw)

        def step(state, batch):
            import torch

            with torch.no_grad():
                out = loss_fn(state.model, batch)
            return state, {"loss": out[0]}

        return step

    monkeypatch.setattr(MultiNodeOptimizer, "make_train_step", broken)


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(
        workload, monkeypatch):
    _unchanged(monkeypatch)
    cell, rec = tiny.cpu_run(workload)
    ok, _ = judge.verdict(rec["numbers"], cell.limits)
    assert not ok
    assert rec["numbers"]["delta_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out_is_not_correct(workload):
    cell, rec = tiny.cpu_run(workload, fault_loss=train.half_batch)
    ok, checks = judge.verdict(rec["numbers"], cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", SERVE)
def test_a_token_altered_where_it_is_produced_is_not_correct(
        workload, monkeypatch):
    from chainermn_tpu_torch.serving import DecodeEngine

    step = DecodeEngine.step

    def altered(self, *a, **kw):
        return (step(self, *a, **kw) + 1) % self.model.vocab

    monkeypatch.setattr(DecodeEngine, "step", altered)
    cell, rec = tiny.cpu_run(workload)
    ok, checks = judge.verdict(rec["numbers"], cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_in_the_programs_place_is_not_correct(workload):
    import torch

    from portbench.run import Run

    cell = tiny.tiny_cell(workload)
    run = Run(torch=torch, cell=cell, device=torch.device("cpu"), seed=11,
              seconds=0.1, trace=False)
    fam, cfg, t = cell.family, cell.config, cell.traffic
    batches = fam.make_batches(cfg, t, run.seed, run.device, torch)
    n = t["check_steps"]
    low = train.reference_readings(run, batches, n, rnd=e4m3)
    ref = train.reference_readings(run, batches, n)
    numbers = judge.train_numbers(low, ref)
    ok, checks = judge.verdict(
        {k: numbers[k] for k in judge.TRAIN_NUMBERS}, cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", SERVE)
def test_the_serving_control_is_not_correct(workload):
    import torch

    from portbench.drivers.serve_closed import reference_gaps
    from portbench.run import Run

    cell, rec = tiny.cpu_run(workload)
    run = Run(torch=torch, cell=cell, device=torch.device("cpu"),
              seed=2 ** 31 + 17, seconds=0.1, trace=False)
    picks, prompts, served = rec["sample"]
    gaps = reference_gaps(run, picks, prompts, served, rnd=e4m3)
    ok, checks = judge.verdict({"logit_gap": max(gaps)}, cell.limits)
    assert not ok, checks


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_fails_at_the_cells_own_size_on_the_card(workload, card):
    import torch

    from portbench.cell import find
    from portbench.run import Run

    cell = find(workload)
    run = Run(torch=torch, cell=cell, device=card, seed=3000000021,
              seconds=1.0, trace=False)
    fam, cfg, t = cell.family, cell.config, cell.traffic
    batches = fam.make_batches(cfg, t, run.seed, card, torch)
    n = t["check_steps"]
    low = train.reference_readings(run, batches, n, rnd=e4m3)
    ref = train.reference_readings(run, batches, n)
    numbers = judge.train_numbers(low, ref)
    ok, checks = judge.verdict(
        {k: numbers[k] for k in judge.TRAIN_NUMBERS}, cell.limits)
    assert not ok, checks
