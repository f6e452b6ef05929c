"""The port's heartbeat failure detector against the JAX package's
(``chainermn_tpu/resilience/detector.py``;
``tests/resilience_tests/test_detector.py`` and
``tests/multiprocess_tests/test_resilience.py``'s hang tests).

``DetectorCore`` runs the same scripted sequences of beats, gossip,
deaths and clock readings as JAX's and reaches the same verdicts, dead
sets and reasons.  ``FailureDetector`` over an in-process transport: an
attributed ``PeerFailedError`` for a silent predecessor, beats that keep
a peer alive, the gossip payload, ``freeze``, step-time statistics merged
freshest-first.  The fault injector's ``hang`` runs the freeze callbacks
before it sleeps, as JAX's does.

One 3-rank job (``torch_rank_bodies.detector``, heartbeats every 0.1 s,
dead after 10 silent intervals): a detector from the launcher's
``CMN_TPU_HB_HOSTS`` attached to each rank's ``HostComm``; 3 barriers
with no fault leave nobody dead; then ``hang@barrier:4`` on rank 2
freezes its beats and the other ranks' 4th barrier raises
``PeerFailedError(kind="dead")`` naming rank 2 and ``barrier`` within a
few intervals of the transport's 30 s deadline, rank 0 from its own
watch, rank 1 from rank 0's gossip.
"""

import queue
import threading
import time

import numpy as np
import pytest

from chainermn_tpu.resilience import detector as jax_det
from chainermn_tpu.resilience import faults as jax_faults
from chainermn_tpu_torch.resilience import (
    ALIVE,
    DEAD,
    SUSPECT,
    DetectorCore,
    FailureDetector,
    PeerFailedError,
    faults,
)

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1


# ----------------------------------------------------------- DetectorCore
def _script(seed, size):
    """A random sequence of core events on a rising clock."""
    rng = np.random.RandomState(seed)
    now, out = 0.0, []
    for _ in range(60):
        now += float(rng.choice([0.1, 0.3, 0.7, 1.5]))
        kind = rng.choice(["beat", "beat", "eval", "eval", "gossip", "mark"])
        if kind == "beat":
            out.append(("note_heartbeat", int(rng.randint(size)), now, ()))
        elif kind == "gossip":
            dead = tuple(int(r) for r in rng.choice(size, 2))
            out.append(("note_heartbeat", int(rng.randint(size)), now, dead))
        elif kind == "mark":
            out.append(("mark_dead", int(rng.randint(size)), "fenced"))
        else:
            out.append(("evaluate", now))
    return out


def _play(core, events):
    seen = []
    for ev in events:
        name, args = ev[0], ev[1:]
        if name == "note_heartbeat":
            core.note_heartbeat(args[0], args[1], dead_ranks=args[2])
        elif name == "mark_dead":
            core.mark_dead(*args)
        else:
            seen.append(core.evaluate(*args))
        seen.append((sorted(core.dead()),
                     [core.reason(r) for r in range(core.size)]))
    return seen


@pytest.mark.parametrize("seed,size,rank", [(0, 2, 0), (1, 3, 1), (2, 4, 0),
                                            (3, 4, 3), (4, 1, 0)])
def test_core_matches_jax_on_scripted_sequences(seed, size, rank):
    kw = dict(interval_s=0.5, suspect_after=2.0, dead_after=4.0)
    port, ref = DetectorCore(rank, size, **kw), jax_det.DetectorCore(
        rank, size, **kw)
    events = _script(seed, size)
    for core in (port, ref):
        core.start(0.0)
    assert (port.pred, port.succ) == (ref.pred, ref.succ)
    assert _play(port, events) == _play(ref, events)


def test_core_transitions_and_validation_match_jax():
    for pkg in (jax_det, None):
        Core = DetectorCore if pkg is None else pkg.DetectorCore
        c = Core(rank=0, size=3, interval_s=1.0, suspect_after=2.0,
                 dead_after=4.0)
        c.start(now=0.0)
        c.note_heartbeat(2, now=1.0)
        assert [c.evaluate(t) for t in (2.9, 3.5)] == [ALIVE, SUSPECT]
        c.note_heartbeat(2, now=3.6)
        assert c.evaluate(4.0) == ALIVE
        assert c.evaluate(8.0) == DEAD and c.dead() == {2}
        c.note_heartbeat(2, now=8.1)        # death is sticky
        assert c.evaluate(8.2) == DEAD
        assert "no heartbeat" in c.reason(2)
        c.note_heartbeat(2, now=9.0, dead_ranks=[0, 1])
        assert c.dead() == {1, 2}           # gossip, never this rank
        assert "gossip" in c.reason(1)
        for bad in (dict(rank=2, size=2),
                    dict(rank=0, size=2, suspect_after=3.0, dead_after=2.0)):
            with pytest.raises(ValueError):
                Core(**bad)


# -------------------------------------------------- the detector's threads
class MockTransport:
    """Per-source queues, TimeoutError on an empty one: HostComm's
    contract in one process."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size
        self.sent = []
        self._in = {r: queue.Queue() for r in range(size)}
        self.closed = False

    def send_obj(self, obj, dest, **kw):
        self.sent.append((dest, obj))

    def deliver(self, source, obj):
        self._in[source].put(obj)

    def recv_obj(self, source, timeout_ms=-1, **kw):
        try:
            return self._in[source].get(timeout=max(timeout_ms, 1) / 1000.0)
        except queue.Empty:
            raise TimeoutError(f"recv from {source} timed out")

    def close(self):
        self.closed = True


def _until(pred, limit=5.0):
    end = time.monotonic() + limit
    while not pred() and time.monotonic() < end:
        time.sleep(0.005)
    return pred()


def test_silent_peer_raises_attributed_then_beats_keep_alive():
    tp = MockTransport(0, 2)
    det = FailureDetector(tp, interval_s=0.05).start()
    try:
        for seq in range(8):                 # beats keep rank 1 alive
            tp.deliver(1, ("hb", seq, []))
            det.check(op="recv_obj")
            time.sleep(0.03)
        assert det.dead_ranks() == set()
        with pytest.raises(PeerFailedError) as e:   # then silence kills
            end = time.monotonic() + 5.0
            while time.monotonic() < end:
                det.check(op="barrier")
                time.sleep(0.02)
        err = e.value
        assert (err.peer, err.op, err.rank, err.kind) == (1, "barrier", 0,
                                                          "dead")
        assert isinstance(err, TimeoutError)
        assert str(err).startswith("rank 0: peer rank 1 failed during "
                                   "barrier (no heartbeat for")
    finally:
        det.stop()


def test_beats_carry_gossip_and_stats_freshest_first():
    tp = MockTransport(0, 3)
    det = FailureDetector(tp, interval_s=0.02, dead_after=10000.0)
    det.set_local_stats({"mean_ms": 12.5, "n": 4})
    det.start()
    try:
        assert _until(lambda: tp.sent)
        dest, payload = tp.sent[0]
        assert dest == 1 and payload[0] == "hb" and payload[2] == []
        assert payload[3][0][1]["mean_ms"] == 12.5
        tp.deliver(2, ("hb", 1, [], {2: (1, {"mean_ms": 40.0}),
                                     1: (7, {"mean_ms": 99.0})}))
        assert _until(lambda: {1, 2} <= set(det.peer_stats()))
        stats = det.peer_stats()
        assert (stats[0]["mean_ms"], stats[1]["mean_ms"],
                stats[2]["mean_ms"]) == (12.5, 99.0, 40.0)
        tp.deliver(2, ("hb", 2, [], {1: (3, {"mean_ms": 1.0})}))  # staler
        tp.deliver(2, ("hb", 3, []))         # a beat without statistics
        time.sleep(0.1)
        assert det.peer_stats()[1]["mean_ms"] == 99.0
        assert det.dead_ranks() == set()
        # Gossip of a death reaches check().
        tp.deliver(2, ("hb", 4, [1]))
        assert _until(lambda: det.dead_ranks() == {1})
        with pytest.raises(PeerFailedError) as e:
            det.check(op="gather_obj")
        assert e.value.peer == 1 and "gossip" in e.value.reason
        rep = det.liveness_report()
        assert rep["dead"] == [1] and rep["rank"] == 0
    finally:
        det.stop()
    assert all(not t.is_alive() for t in threading.enumerate()
               if t.name.startswith("cmn-hb-"))


def test_freeze_stops_beats_and_one_rank_is_a_noop():
    tp = MockTransport(0, 2)
    det = FailureDetector(tp, interval_s=0.02).start()
    time.sleep(0.1)
    det.freeze()
    time.sleep(0.06)
    n = len(tp.sent)
    time.sleep(0.1)
    assert len(tp.sent) == n and not tp.closed
    one = FailureDetector(MockTransport(0, 1), interval_s=0.01).start()
    one.check(op="anything")
    one.stop()


def test_hang_runs_freeze_callbacks_first_as_jax_does():
    for pkg in (jax_faults, faults):
        order = []

        def sleep(s):
            order.append("sleep")
            raise KeyboardInterrupt

        inj = pkg.FaultInjector(pkg.parse_fault_spec("hang@barrier:2"),
                                sleep=sleep)
        inj.add_freeze_callback(lambda: order.append("freeze"))
        assert inj.hook("barrier") is None
        with pytest.raises(KeyboardInterrupt):
            inj.hook("barrier")
        assert order == ["freeze", "sleep"], pkg


# ----------------------------------------------------------- across ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("detector", tmp_path_factory.mktemp("detector"), 3)


def test_hang_free_control_is_clean(ranks):
    assert all(r["control_dead"] == [] for r in ranks)


def test_hung_rank_is_named_with_the_op(ranks):
    frozen = ranks[2]["frozen_at"]
    assert ranks[2]["hang"] == "frozen"
    interval = ranks[0]["interval_s"]
    for r in (0, 1):
        hang = ranks[r]["hang"]
        assert (hang["peer"], hang["op"], hang["kind"], hang["rank"]) == \
            (2, "barrier", "dead", r)
        assert hang["message"].startswith(
            f"rank {r}: peer rank 2 failed during barrier")
        assert ranks[r]["check"] == (2, "allgather_obj", "dead")
        assert ranks[r]["dead"] == [2]
        # Dead after 10 silent intervals: the verdict comes after that,
        # and far inside the transport's 30 s deadline.
        waited = (hang["at"] - frozen) / interval
        assert 9.0 <= waited < 100.0, waited
    assert "no heartbeat" in ranks[0]["liveness"]["dead_reasons"]["2"]
    assert "gossip" in ranks[1]["liveness"]["dead_reasons"]["2"]
