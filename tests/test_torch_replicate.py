"""The port's peer-replication plane against the JAX package's
(``chainermn_tpu/resilience/replicate.py``;
``tests/resilience_tests/test_replicate.py`` and
``tests/multiprocess_tests/test_replicate_multiprocess.py``).

Against the JAX package on the same inputs, exactly: ``pick_quorum`` on
seeded random inventories, ``chaos_schedule`` for a range of seeds and
shapes, ``shard_digest`` of the same bytes, and the in-process chaos
invariant (the same schedule, the same lost steps, the oracle's final
digest).  On the port, the JAX test file's behaviour cases over the
in-process ``LocalComm``: a replica byte-identical to its sender's
snapshot, torn and out-of-order frames and torn spill files discarded,
the double buffer, the quorum rules, a fast restore from a peer into the
trainer's own tensors, and the clean fallbacks.

One 3-rank gloo job under ``launch.supervise``
(``torch_rank_bodies.replicate``, ZeRO with AdamW): ``crash@iter:5`` on
rank 1 with its spill wiped, restored from rank 2's replica at 4; a
SIGTERM on rank 0 at 7 (flush, save, exit 75); the relaunch restores
every rank's own flush and tears one frame (``flip@replicate``); the run
ends on the unfaulted run's parameters and optimizer shards bit for bit.
Then 2 ranks over the same spill (``replicate_elastic``) fall back to
``maybe_load_elastic`` and file ``replication_fallback``.
"""

import os
import pickle
import random
import threading
import zlib

import numpy as np
import pytest
import torch

from chainermn_tpu.resilience import replicate as jax_rep
from chainermn_tpu_torch.optimizers import TrainState
from chainermn_tpu_torch.resilience import faults as _faults
from chainermn_tpu_torch.resilience.replicate import (
    REPLICATE_SCHEMA,
    ShardReplicator,
    chaos_schedule,
    negotiate_restore,
    pick_quorum,
    shard_digest,
)
from chainermn_tpu_torch.serving.disagg import LocalComm
from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1


class FakeTrainer:
    """The trainer surface the replication plane touches."""

    def __init__(self, state, iteration=0):
        self.state = state
        self.iteration = iteration
        self.train_iter = None
        self.extensions = []


class _Toy(torch.nn.Module):
    """Seeded fp32 parameters and a bf16 buffer."""

    def __init__(self, seed, n=32):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.w = torch.nn.Parameter(
            torch.from_numpy(rng.randn(n).astype(np.float32)))
        self.b = torch.nn.Parameter(
            torch.from_numpy(rng.randn(4).astype(np.float32)))
        self.register_buffer("h", torch.from_numpy(
            rng.randn(6).astype(np.float32)).to(torch.bfloat16))


def _state(seed, n=32):
    """A TrainState of a seeded model whose AdamW moments come from one
    step on seeded gradients."""
    model = _Toy(seed, n)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    rng = np.random.RandomState(seed + 100)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    opt.step()
    opt.zero_grad(set_to_none=True)
    return TrainState(step=1, model=model, optimizer=opt)


def _zeros_like(s):
    """A relaunched process's state: the model's shapes, zeroed, and an
    optimizer that has not stepped."""
    model = _Toy(0, s.model.w.shape[0])
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    return TrainState(step=0, model=model,
                      optimizer=torch.optim.AdamW(model.parameters(),
                                                  lr=1e-2))


def _tensors(state):
    """Every tensor a snapshot restores, by name, and the step."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    out["step"] = torch.tensor(state.step)
    return out


def _replicators(tmp_path, size=2, every=2, injectors=None):
    mesh = LocalComm(size)
    return mesh, [ShardReplicator(
        mesh.endpoint(r), every=every, spill_dir=str(tmp_path / "spill"),
        keep=4, injector=(injectors or {}).get(r),
        _use_process_injector=False) for r in range(size)]


# ---------------------------------------------------- parity with JAX
def _random_inventories(rng, size):
    steps = sorted(rng.sample(range(2, 30, 2), 4))
    invs = []
    for r in range(size):
        own = {s: f"d{r}_{s}" for s in steps if rng.random() < 0.7}
        held = {}
        for src in range(size):
            if src != r and rng.random() < 0.6:
                held[src] = {s: (f"d{src}_{s}" if rng.random() < 0.9
                                 else "stale") for s in steps
                             if rng.random() < 0.6}
        invs.append({"rank": r, "size": size if rng.random() < 0.9 else 7,
                     "own": own, "held": held, "stale_world": False})
    return invs


@pytest.mark.parametrize("seed", range(6))
def test_pick_quorum_matches_jax(seed):
    rng = random.Random(seed)
    for size in (2, 3, 4):
        invs = _random_inventories(rng, size)
        assert pick_quorum(invs, size) == jax_rep.pick_quorum(invs, size)


@pytest.mark.parametrize("kw", [
    dict(seed=7, failures=3, target_step=24, cadence=4),
    dict(seed=0, failures=1, target_step=8, cadence=2,
         kinds=("crash", "preempt", "torn")),
    dict(seed=11, failures=2, target_step=24, cadence=4, kinds=("crash",)),
    dict(seed=5, failures=4, target_step=12, cadence=3,
         kinds=("preempt", "torn")),
])
def test_chaos_schedule_matches_jax(kw):
    assert chaos_schedule(**kw) == jax_rep.chaos_schedule(**kw)


def test_shard_digest_matches_jax():
    rng = np.random.RandomState(3)
    for n in (0, 1, 100, 4097):
        blob = rng.bytes(n)
        assert shard_digest(blob) == jax_rep.shard_digest(blob)
    assert REPLICATE_SCHEMA == jax_rep.REPLICATE_SCHEMA


# ------------------------------------------------------------- wire format
def test_round_trip_byte_identity(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path)
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    rep1._fire(FakeTrainer(_state(1), iteration=2))
    rep0._fire(FakeTrainer(_state(0), iteration=4))  # drains rank 1's frame
    own = rep1._load_spill(1, 2)
    replica = rep0._load_spill(1, 2)
    assert own is not None and replica is not None
    assert replica["payload"] == own["payload"]
    assert shard_digest(replica["payload"]) == shard_digest(own["payload"])


def test_crc_rejects_torn_frame(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path)
    snap = rep1._snapshot(FakeTrainer(_state(1), iteration=2))
    torn = bytearray(snap["payload"])
    torn[len(torn) // 2] ^= 0xFF
    rep0._accept({"schema": REPLICATE_SCHEMA, "seq": 0, "kind": "shard",
                  "step": 2, "src": 1, "size": 2, "crc": snap["crc"],
                  "payload": bytes(torn)}, 1)
    assert rep0._load_spill(1, 2) is None
    assert 2 not in rep0.inventory()["held"].get(1, {})


def test_flip_fault_ships_torn_replica_local_copy_clean(tmp_path):
    inj = _faults.FaultInjector(_faults.parse_fault_spec("flip@replicate:1"))
    _, (rep0, rep1) = _replicators(tmp_path, injectors={0: inj})
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    rep1._fire(FakeTrainer(_state(1), iteration=2))
    assert rep1._load_spill(0, 2) is None
    assert rep0._load_spill(0, 2) is not None


def test_seq_gap_detected_and_resynced(tmp_path):
    inj = _faults.FaultInjector(_faults.parse_fault_spec("drop@replicate:1"))
    _, (rep0, rep1) = _replicators(tmp_path, injectors={0: inj})
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    rep1._fire(FakeTrainer(_state(1), iteration=2))
    assert rep1._load_spill(0, 2) is None
    rep0._fire(FakeTrainer(_state(0), iteration=4))
    rep1._fire(FakeTrainer(_state(1), iteration=4))
    assert rep1._load_spill(0, 4) is not None
    assert rep1._seq_in[0] == 2


def test_schema_mismatch_rejected(tmp_path):
    _, (rep0, _) = _replicators(tmp_path)
    rep0._accept({"schema": "cmn-ckptrep-99", "seq": 0, "step": 2,
                  "src": 1, "size": 2, "crc": 0, "payload": b"x"}, 1)
    assert rep0._load_spill(1, 2) is None


def test_torn_spill_file_discarded_on_read(tmp_path):
    _, (rep0, _) = _replicators(tmp_path)
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    path = rep0._spill_path(0, 2)
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    assert rep0._load_spill(0, 2) is None
    assert not os.path.exists(path)


def test_double_buffer_never_exposes_half_written_snapshot(tmp_path):
    _, (rep0, _) = _replicators(tmp_path)
    assert rep0._buffer is None
    published = []

    def crashing_persist(rec, src):
        published.append(rep0._buffer)
        with open(rep0._spill_path(src, rec["step"]) + ".tmp", "wb") as f:
            f.write(b"partial")
        raise OSError("simulated crash mid-write")

    orig, rep0._persist = rep0._persist, crashing_persist
    with pytest.raises(OSError):
        rep0._fire(FakeTrainer(_state(0), iteration=2))
    snap = published[0]
    assert snap is not None and \
        zlib.crc32(snap["payload"]) & 0xFFFFFFFF == snap["crc"]
    rep0._persist = orig
    assert rep0.inventory()["own"] == {}


# ------------------------------------------------------------------ quorum
def _inv(rank, size, own=None, held=None, stale=False):
    return {"rank": rank, "size": size, "own": own or {},
            "held": held or {}, "stale_world": stale}


def test_quorum_picks_newest_fully_reachable_step():
    plan = pick_quorum([
        _inv(0, 2, own={2: "a0", 4: "b0"}, held={1: {2: "a1"}}),
        _inv(1, 2, own={2: "a1", 4: "b1"})], 2)
    assert plan["step"] == 4
    assert plan["sources"] == {0: "local", 1: "local"}


def test_quorum_serves_missing_rank_from_holder():
    plan = pick_quorum([
        _inv(0, 2, own={2: "a0", 4: "b0"}, held={1: {2: "a1"}}),
        _inv(1, 2)], 2)
    assert plan["step"] == 2
    assert plan["sources"] == {0: "local", 1: 0}
    assert plan["digests"][1] == "a1"


def test_quorum_digest_mismatch_skips_to_older_step():
    plan = pick_quorum([
        _inv(0, 2, own={2: "a0", 4: "b0"}, held={1: {2: "a1", 4: "XX"}}),
        _inv(1, 2, own={2: "a1", 4: "b1"}, held={0: {2: "a0"}})], 2)
    assert plan["step"] == 2


def test_quorum_none_when_a_rank_has_no_copy_anywhere():
    assert pick_quorum([_inv(0, 2, own={4: "b0"}), _inv(1, 2)], 2) is None


# ------------------------------------------------------------ fast restore
def _drive_threads(fns):
    out, errs = [None] * len(fns), []

    def runner(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=runner, args=(i, fn))
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs, errs
    return out


def test_peer_fast_restore_bit_exact_in_place(tmp_path):
    """Rank 1 loses its spill; the negotiation restores it from rank 0's
    replica bit for bit, into the tensors its state already holds."""
    _, (rep0, rep1) = _replicators(tmp_path, every=2)
    s0, s1 = _state(0), _state(1)
    rep0._fire(FakeTrainer(s0, iteration=2))
    rep1._fire(FakeTrainer(s1, iteration=2))
    rep0._fire(FakeTrainer(s0, iteration=4))
    for f in os.listdir(rep1.spill_dir):
        os.unlink(os.path.join(rep1.spill_dir, f))
    _, (rep0, rep1) = _replicators(tmp_path, every=2)
    t0, t1 = FakeTrainer(_zeros_like(s0)), FakeTrainer(_zeros_like(s1))
    live = {k: v.data_ptr() for k, v in t1.state.model.state_dict().items()}
    (st0, it0, rpt0), (st1, it1, rpt1) = _drive_threads([
        lambda: negotiate_restore(rep0, t0.state, trainer=t0),
        lambda: negotiate_restore(rep1, t1.state, trainer=t1)])
    assert (it0, it1) == (2, 2)
    assert (rpt0["source"], rpt1["source"]) == ("local", "peer")
    for got, want in ((st0, s0), (st1, s1)):
        got, want = _tensors(got), _tensors(want)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert {k: v.data_ptr()
            for k, v in st1.model.state_dict().items()} == live
    assert t1.iteration == 2
    assert rpt1["lost_steps"] <= rep1.every


class FakeCheckpointer:
    def __init__(self, step=0):
        self.calls = 0
        self.step = step

    def maybe_load(self, state, trainer=None):
        self.calls += 1
        return state, self.step


def test_no_quorum_falls_back_to_checkpointer(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path)
    ck0, ck1 = FakeCheckpointer(7), FakeCheckpointer(7)
    t0, t1 = FakeTrainer(_state(0)), FakeTrainer(_state(1))
    r0, r1 = _drive_threads([
        lambda: negotiate_restore(rep0, t0.state, t0, checkpointer=ck0),
        lambda: negotiate_restore(rep1, t1.state, t1, checkpointer=ck1)])
    for (_, it, rpt), ck in ((r0, ck0), (r1, ck1)):
        assert it == 7 and ck.calls == 1
        assert (rpt["source"], rpt["reason"]) == ("orbax", "no-quorum")


def test_world_size_change_falls_back_to_elastic(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path)
    for rep, seed in ((rep0, 0), (rep1, 1)):
        snap = rep._snapshot(FakeTrainer(_state(seed), iteration=2))
        snap["size"] = 3
        rep._persist(snap, rep.rank)
    calls = []

    def elastic(seed):
        def run():
            calls.append(seed)
            return _state(seed), 2
        return run

    t0, t1 = FakeTrainer(_state(0)), FakeTrainer(_state(1))
    r0, r1 = _drive_threads([
        lambda: negotiate_restore(rep0, t0.state, t0, elastic=elastic(0)),
        lambda: negotiate_restore(rep1, t1.state, t1, elastic=elastic(1))])
    for _, it, rpt in (r0, r1):
        assert it == 2
        assert (rpt["source"], rpt["reason"]) == ("orbax",
                                                  "world-size-changed")
    assert sorted(calls) == [0, 1]


def test_digest_mismatch_on_arrival_falls_back(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path, every=2)
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    rep1._fire(FakeTrainer(_state(1), iteration=2))
    rep0._fire(FakeTrainer(_state(0), iteration=4))
    for f in os.listdir(rep1.spill_dir):
        os.unlink(os.path.join(rep1.spill_dir, f))
    rec = rep0._load_spill(1, 2)
    torn = bytearray(rec["payload"])
    torn[0] ^= 0xFF
    rep0._persist({"step": 2, "size": 2,
                   "crc": zlib.crc32(bytes(torn)) & 0xFFFFFFFF,
                   "payload": bytes(torn)}, 1)
    _, (rep0, rep1) = _replicators(tmp_path, every=2)
    ck0, ck1 = FakeCheckpointer(), FakeCheckpointer()
    t0, t1 = FakeTrainer(_state(0)), FakeTrainer(_state(1))
    r0, r1 = _drive_threads([
        lambda: negotiate_restore(rep0, t0.state, t0, checkpointer=ck0),
        lambda: negotiate_restore(rep1, t1.state, t1, checkpointer=ck1)])
    for (_, _, rpt), ck in ((r0, ck0), (r1, ck1)):
        assert rpt["source"] == "orbax" and ck.calls == 1
    assert r1[2]["reason"] in ("transfer-or-structure-mismatch",
                               "no-quorum")


def test_structure_mismatch_falls_back(tmp_path):
    """A shard of another model never installs: the live state's shapes
    are checked before the confirmation."""
    _, (rep0,) = _replicators(tmp_path, size=1)
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    ck = FakeCheckpointer(0)
    live = _state(0, n=31)
    _, it, rpt = negotiate_restore(rep0, live, FakeTrainer(live),
                                   checkpointer=ck)
    assert (rpt["reason"], ck.calls, it) == (
        "transfer-or-structure-mismatch", 1, 0)


# ------------------------------------------------------------- chaos (1p)
def test_chaos_schedule_seeded_and_crash_guaranteed():
    a = chaos_schedule(seed=7, failures=3, target_step=24, cadence=4)
    assert a == chaos_schedule(seed=7, failures=3, target_step=24,
                               cadence=4)
    assert any(e["kind"] == "crash" for e in a["events"])
    for e in a["events"]:
        assert a["cadence"] < e["iter"] < a["target_step"]
    with pytest.raises(ValueError):
        chaos_schedule(seed=0, failures=0)
    with pytest.raises(ValueError):
        chaos_schedule(seed=0, target_step=3, cadence=4)


def _chaos(rep_mod, digest, spill, state0, restore_copy, update):
    """The JAX test's in-process chaos run with ``rep_mod``'s replicator,
    negotiation and harness: a deterministic update per iteration."""
    cadence, target = 4, 24

    def train(state, start, stop, crash_at=None, replicator=None,
              trainer=None):
        for it in range(start + 1, stop + 1):
            state = update(state, np.float32(0.01) * np.float32(it))
            if trainer is not None:
                trainer.state, trainer.iteration = state, it
            if replicator is not None and it % cadence == 0:
                replicator._fire(trainer)
            if crash_at is not None and it == crash_at:
                return state, it, True
        return state, stop, False

    oracle = digest(train(state0(), 0, target)[0])

    def run_attempt(attempt, event):
        rep = rep_mod.ShardReplicator(None, every=cadence,
                                      spill_dir=str(spill), keep=4,
                                      _use_process_injector=False)
        trainer = FakeTrainer(state0())
        restored = 0
        if attempt > 0:
            new_state, it, rpt = rep_mod.negotiate_restore(
                rep, trainer.state, trainer=trainer)
            assert rpt["source"] == "local"
            trainer.state = restore_copy(new_state)
            trainer.iteration = restored = it
        state, final, crashed = train(
            trainer.state, trainer.iteration, target,
            crash_at=event["iter"] if event else None, replicator=rep,
            trainer=trainer)
        return {"rc": 1 if crashed else 0, "final_step": final,
                "restored_step": restored,
                "digest": None if crashed else digest(state)}

    schedule = rep_mod.chaos_schedule(seed=11, failures=2,
                                      target_step=target, cadence=cadence,
                                      kinds=("crash",))
    result = rep_mod.TrainingChaosHarness(run_attempt, schedule).run()
    return result, rep_mod.TrainingChaosHarness.verify(result, oracle)


def test_chaos_invariant_in_process_matches_jax(tmp_path):
    from chainermn_tpu.resilience.consistency import tree_digest as jdig
    from chainermn_tpu_torch.resilience import tree_digest

    import chainermn_tpu_torch.resilience.replicate as port_rep

    def np_state():
        rng = np.random.RandomState(3)
        return {"w": rng.randn(32).astype(np.float32),
                "b": rng.randn(4).astype(np.float32)}

    def port_update(state, delta):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(torch.tensor(delta))
        return state

    got, verdict = _chaos(
        port_rep, lambda s: tree_digest(s.model), tmp_path / "port",
        lambda: _state(3), lambda s: s, port_update)
    want, jverdict = _chaos(jax_rep, jdig, tmp_path / "jax", np_state,
                            lambda s: {k: np.asarray(v) for k, v in
                                       s.items()},
                            lambda s, d: {k: v + d for k, v in s.items()})
    assert verdict["holds"] and jverdict["holds"], (verdict, jverdict)
    for key in ("completed", "lost_steps_per_failure", "useful_steps",
                "total_steps_executed"):
        assert got[key] == want[key], key
    assert [a["restored_step"] for a in got["attempts"]] == \
        [a["restored_step"] for a in want["attempts"]]


# ---------------------------------------------------------------- plumbing
def test_cadence_off_by_default_and_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("CMN_REP_EVERY", raising=False)
    assert ShardReplicator.maybe_from_env() is None
    with pytest.raises(ValueError):
        ShardReplicator(None, every=0, spill_dir=str(tmp_path))
    monkeypatch.setenv("CMN_REP_EVERY", "3")
    monkeypatch.setenv("CMN_REP_DIR", str(tmp_path / "envspill"))
    rep = ShardReplicator.maybe_from_env()
    assert rep is not None and rep.every == 3
    assert rep.spill_dir.startswith(str(tmp_path / "envspill"))


def test_report_shape(tmp_path):
    _, (rep0, rep1) = _replicators(tmp_path, every=2)
    rep0._fire(FakeTrainer(_state(0), iteration=2))
    rep1._fire(FakeTrainer(_state(1), iteration=2))
    rpt = rep1.report()
    assert rpt["own_steps"] == [2]
    assert rpt["held"] == {0: [2]}
    assert rpt["every"] == 2 and rpt["factor"] == 1
    assert rpt["last_cadence"]["bytes"] > 0


# -------------------------------------------------------- the gloo job
@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("replicate")
    run_ranks("replicate", out, nproc=3, timeout_s=120,
              supervised=dict(restarts=1, preempt_restarts=1))
    elastic = run_ranks("replicate_elastic", out, nproc=2, timeout_s=120)
    ranks = []
    for r in range(3):
        with open(out / f"replicate.attempt0.rank{r}.pkl", "rb") as f:
            oracle = pickle.load(f)["oracle"]
        with open(out / f"replicate.rank{r}.pkl", "rb") as f:
            ranks.append((oracle, pickle.load(f)))
    return ranks, elastic, out


def test_crash_then_preemption_restore_bitwise(job):
    ranks, _, out = job
    for r, (oracle, res) in enumerate(ranks):
        # The relaunch after the preemption restored its own flush at 7.
        assert res["report"]["source"] == "local"
        assert res["resumed"] == 7 and res["report"]["lost_steps"] == 0
        assert res["iteration"] == 12
        assert res["params_digest"] == oracle["params_digest"]
        assert res["state_digest"] == oracle["state_digest"]


def test_crash_restored_from_peer_replica(job):
    """The relaunch after ``crash@iter:5``: rank 1's spill was wiped, so
    its shard came from rank 2's replica; every rank resumed at 4."""
    ranks, _, out = job
    reports = []
    for r in range(3):
        with open(out / f"replicate.attempt1.rank{r}.pkl", "rb") as f:
            reports.append(pickle.load(f))
    assert [x["report"]["source"] for x in reports] == \
        ["local", "peer", "local"]
    assert all(x["resumed"] == 4 for x in reports)
    assert all(x["report"]["lost_steps"] <= 2 for x in reports)
    assert 1 in ranks[2][1]["held"]  # rank 2 holds its predecessor's


def test_torn_frame_discarded(job):
    ranks, _, _ = job
    assert ranks[1][1]["torn"] >= 1
    assert ranks[0][1]["torn"] in (None, 0)


def test_different_world_size_falls_back_to_elastic(job):
    ranks, elastic, _ = job
    want = ranks[0][0]["params_digest"]
    for res in elastic:
        assert res["report"]["source"] == "orbax"
        assert res["report"]["reason"] == "world-size-changed"
        assert res["resumed"] == 12
        assert res["params_digest"] == want
        assert "replication_fallback" in res["incidents"]
