"""The serving fleet on the card: KV-block migration between engines whose
decode steps are captured CUDA graphs, and the card memory an engine
frees when it leaves its fleet.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_fleet_cuda.py

Checked:

* a migrated block re-reads byte for byte on the destination, for a bf16
  cache (shipped as its int16 bits) and an int8 cache with grouped-query
  heads (values and scales);
* slots installed into an engine whose decode step was captured before
  the install continue under replay with the tokens an engine that never
  migrated gives (fp32, TF32 off: the same kernels on the same inputs),
  with no second capture and the pool tensors at the addresses the graph
  was captured over;
* a dead, retired or deregistered engine returns every byte its pools
  and graph held: ``torch.cuda.memory_allocated()`` comes back to the
  footprint of the replicas still alive.
"""

import gc

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.observability.metrics import MetricsRegistry
from chainermn_tpu_torch.resilience.faults import (
    FaultInjector,
    parse_fault_spec,
)
from chainermn_tpu_torch.serving import (
    DecodeEngine,
    DecodeRole,
    LocalComm,
    MigrationTransport,
    Request,
    Router,
    Scheduler,
)
from chainermn_tpu_torch.serving import disagg as dz

pytestmark = pytest.mark.cuda

SMALL = dict(vocab=257, n_layers=3, d_model=128, n_heads=4, d_ff=256,
             max_len=256, pos_enc="rope", decode_attention="fused")
CONFIGS = {
    "fp32": dict(dtype=torch.float32),
    "bf16": dict(dtype=torch.bfloat16),
    "int8_gqa": dict(dtype=torch.bfloat16, n_kv_heads=2,
                     kv_dtype=torch.int8),
}
ENG = dict(capacity=4, num_blocks=40, block_len=8, prefill_chunk=16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fleet's engines capture "
                    "their decode steps only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(dev, cfg):
    return TransformerLM(**SMALL, **CONFIGS[cfg], device=dev, seed=0)


def _requests(seed, n=4, new=12):
    rng = np.random.RandomState(seed)
    return [Request(id=i, prompt=rng.randint(1, 257, size=int(p)).tolist(),
                    max_new_tokens=new)
            for i, p in enumerate(rng.randint(5, 30, size=n))]


def _prefill_until_ready(sched):
    for _ in range(64):
        while sched._try_admit():
            pass
        sched._prefill_round()
        live = [s for s in sched._slots if s is not None]
        if live and all(not s.prefilling for s in live):
            return live
    raise AssertionError("prefill never finished")


def _block_bytes(engine, block):
    data = engine.read_block(block)
    return b"".join(layer[name].tobytes() for layer in data["target"]
                    for name in sorted(layer))


@pytest.mark.parametrize("cfg", ["bf16", "int8_gqa"])
def test_migrated_blocks_reread_byte_for_byte(dev, cfg):
    model = _model(dev, cfg)
    src = Scheduler(DecodeEngine(model, **ENG, device=dev),
                    registry=MetricsRegistry())
    dst = Scheduler(DecodeEngine(model, **ENG, device=dev),
                    registry=MetricsRegistry())
    comm = LocalComm(2)
    t0 = MigrationTransport(comm.endpoint(0), registry=MetricsRegistry())
    t1 = MigrationTransport(comm.endpoint(1), registry=MetricsRegistry())
    for r in _requests(1, n=3):
        src.submit(r)
    slots = _prefill_until_ready(src)
    want = {s.entry.req.id: [_block_bytes(src.engine, b) for b in s.blocks]
            for s in slots}
    names = sorted(src.engine.read_block(slots[0].blocks[0])["target"][0])
    assert names == (["k", "k_scale", "v", "v_scale"] if cfg == "int8_gqa"
                     else ["k", "v"])
    dz.migrate_slots(src, t0, 1, slots)
    installed, queued, rest = dz.install_payload(dst, t1.recv(0)["body"])
    assert (installed, queued, rest) == (3, 0, None)
    for s in dst._slots:
        if s is not None:
            got = [_block_bytes(dst.engine, b) for b in s.blocks]
            assert got == want[s.entry.req.id]


def test_install_under_a_captured_graph_replays_the_installed_kv(dev):
    model = _model(dev, "fp32")
    reqs = _requests(2)
    # The engine that never migrates: prefill and decode on one engine.
    ref = {c.id: c.tokens for c in Scheduler(
        DecodeEngine(model, **ENG, device=dev),
        registry=MetricsRegistry()).run(reqs)}
    # The destination captures its decode step BEFORE any install.
    dst_eng = DecodeEngine(model, **ENG, device=dev)
    Scheduler(dst_eng, registry=MetricsRegistry()).run(
        [Request(id=99, prompt=[3, 4, 5], max_new_tokens=6)])
    dst_eng.drop_prefix_cache()
    assert dst_eng.decode_compiles == 1 and len(dst_eng._graphs) == 1
    ptrs = [t.data_ptr() for layer in dst_eng.pools for t in layer.values()]
    replays0 = dst_eng.decode_replays
    comm = LocalComm(2)
    src = Scheduler(DecodeEngine(model, **ENG, device=dev),
                    registry=MetricsRegistry())
    t0 = MigrationTransport(comm.endpoint(0), registry=MetricsRegistry())
    for r in reqs:
        src.submit(r)
    dz.migrate_slots(src, t0, 1, _prefill_until_ready(src))
    t0.send_eof(1)
    role = DecodeRole(Scheduler(dst_eng, registry=MetricsRegistry()),
                      MigrationTransport(comm.endpoint(1),
                                         registry=MetricsRegistry()),
                      prefill_ranks=[0])
    got = {c.id: c.tokens for c in role.run_loop(poll_ms=0)}
    assert got == ref
    assert dst_eng.decode_compiles == 1 and len(dst_eng._graphs) == 1
    assert dst_eng.decode_replays > replays0
    assert [t.data_ptr() for layer in dst_eng.pools
            for t in layer.values()] == ptrs


def _allocated():
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def test_engines_that_leave_free_the_card(dev):
    model = _model(dev, "bf16")
    footprint = {}

    def factory():
        before = _allocated()
        eng = DecodeEngine(model, **ENG, device=dev)
        # Prompts whose chunks take each prefill ladder geometry (8, 16),
        # so that every graph the engine captures is in its footprint.
        Scheduler(eng, registry=MetricsRegistry()).run(
            [Request(id=99, prompt=[3, 4, 5], max_new_tokens=6),
             Request(id=98, prompt=list(range(3, 15)), max_new_tokens=2)])
        eng.drop_prefix_cache()
        footprint[id(eng)] = (eng, _allocated() - before)
        return eng

    # One engine first, dropped: the process-wide state a first warm-up
    # may create (cuBLAS workspaces, the kernels' run counter) then sits
    # in the baseline rather than in a footprint.
    factory().release()
    footprint.clear()
    base = _allocated()

    def live():
        return sum(b for e, b in footprint.values() if not e.released)

    engines = [factory() for _ in range(3)]
    assert all(b > 0 for _, b in footprint.values())
    router = Router(engines, registry=MetricsRegistry(),
                    faults=[None, FaultInjector(parse_fault_spec(
                        "crash@serve_step:3")), None])
    comps = router.run(_requests(3, n=6))
    assert sorted(c.id for c in comps) == list(range(6))
    assert router.health.state(1) == "dead" and engines[1].released
    del engines, comps
    held = [(_allocated() - base, live())]        # the dead one freed
    router.drain_replica(2)
    router.deregister_replica(2)
    held.append((_allocated() - base, live()))    # deregistered
    router.revive_replica(1, factory())
    held.append((_allocated() - base, live()))    # a revival captures
    router.drain_replica(1)
    router.retire_replica(1)
    held.append((_allocated() - base, live()))    # retired
    assert all(got == want for got, want in held), held
    assert sum(not e.released for e, _ in footprint.values()) == 1
