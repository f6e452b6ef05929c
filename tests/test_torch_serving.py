"""The port's Scheduler + DecodeEngine against the JAX package's, on the
serving drive's geometry (vocab 257, 2 layers, d_model 64, capacity 4,
40 blocks of 8, prefill chunk 16) with Flax parameters carried across.

Both models compute in float32.  The JAX engine runs the gathered einsum
decode; the port's runs ``decode_attention="fused"``, so its paged
kernel's plain version is what the JAX tokens check.  Tokens are
compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu_torch.models import TransformerLM, lm_generate
from chainermn_tpu_torch.observability import MetricsRegistry
from chainermn_tpu_torch.resilience import FaultInjector, InjectedFault
from chainermn_tpu_torch.resilience import parse_fault_spec
from chainermn_tpu_torch.serving import DecodeEngine, Request, Scheduler
from chainermn_tpu_torch.serving import PolicyPlane
from chainermn_tpu_torch.serving.engine import lane_seed
from chainermn_tpu_torch.utils import params_from_flax

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

KW = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope")
ENG = dict(capacity=4, num_blocks=40, block_len=8, prefill_chunk=16)
SHAPES = [(5, 7), (20, 12), (33, 3), (9, 20)]


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**KW, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(**KW, dtype=torch.float32, decode_attention="fused",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [(rng.randint(1, 257, size=n).tolist(), m) for n, m in SHAPES]


def _engine(tm, **over):
    return DecodeEngine(tm, **{**ENG, **over}, device="cpu")


def _serve(eng, reqs, **kw):
    return {c.id: c for c in Scheduler(eng, **kw).run(reqs)}


def test_tokens_match_jax_engine(models, prompts):
    jm, params, tm = models
    jeng = JaxEngine(jm, params, **ENG)
    want = {c.id: c.tokens for c in JaxScheduler(jeng).run(
        [JaxRequest(id=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(prompts)])}
    reg = MetricsRegistry()
    eng = _engine(tm)
    got = _serve(eng, [Request(id=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(prompts)], registry=reg)
    for i in want:
        assert got[i].tokens == want[i], f"request {i}"
        assert got[i].status == "ok"
    assert eng.decode_compiles == 1
    assert eng.prefill_compiles <= len(eng.prefill_ladder)
    snap = reg.snapshot()
    assert snap["serve.tokens"]["value"] == sum(m for _, m in SHAPES)
    assert eng.prefix.cached_blocks > 0
    eng.drop_prefix_cache()
    assert eng.free_blocks() == 39


def test_engine_matches_lm_generate(models, prompts):
    _, _, tm = models
    eng = _engine(tm)
    got = _serve(eng, [Request(id=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(prompts)])
    for i, (p, m) in enumerate(prompts):
        want = lm_generate(tm, torch.tensor([p]), m)[0].tolist()
        assert got[i].tokens == want, f"request {i}"


def _family(seed=1):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, 257, size=21).tolist()  # 2 full 8-blocks + 5
    return [prefix + rng.randint(1, 257, size=4).tolist() for _ in range(3)]


def test_shared_prefix_copy_on_write(models):
    _, _, tm = models
    fam = _family()
    reqs = [Request(id=i, prompt=p, max_new_tokens=9)
            for i, p in enumerate(fam)]
    base = _serve(_engine(tm, capacity=1, prefix_cache=False), reqs)
    eng = _engine(tm, capacity=1, num_blocks=64)
    sched = Scheduler(eng)
    got = {c.id: c for c in sched.run(reqs)}
    assert sched.prefix_hit_tokens > 0
    assert eng.cow_compiles == 1  # the partial block was copied
    for i in base:
        assert got[i].tokens == base[i].tokens, f"request {i}"
    assert eng.decode_compiles == 1
    eng.drop_prefix_cache()
    assert eng.free_blocks() == 63


def test_self_draft_speculation_accepts_everything(models, prompts):
    _, _, tm = models
    reqs = [Request(id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    base = _serve(_engine(tm), reqs)
    eng = _engine(tm, num_blocks=64, draft_model=tm, spec_k=3)
    sched = Scheduler(eng)
    got = {c.id: c for c in sched.run(reqs)}
    assert sched.spec_proposed > 0
    assert sched.spec_accepted == sched.spec_proposed
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    for i in base:
        assert got[i].tokens == base[i].tokens, f"request {i}"
    eng.drop_prefix_cache()
    assert eng.free_blocks() == 63


def test_eviction_under_pool_pressure_keeps_greedy(models, prompts):
    _, _, tm = models
    reqs = [Request(id=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    base = _serve(_engine(tm), reqs)
    eng = _engine(tm, num_blocks=9, prefix_cache=False)
    got = _serve(eng, reqs)
    assert sum(c.evictions for c in got.values()) > 0
    for i in base:
        assert got[i].tokens == base[i].tokens, f"request {i}"
    assert eng.free_blocks() == 8


def test_sampling_is_deterministic_per_seed(models, prompts):
    _, _, tm = models
    p, _ = prompts[1]

    def run(seed, top_k=0, temperature=0.8):
        eng = _engine(tm, top_k=top_k)
        return _serve(eng, [Request(id=0, prompt=p, max_new_tokens=10,
                                    temperature=temperature,
                                    seed=seed)])[0].tokens

    assert run(7) == run(7)
    assert run(7) != run(8)
    assert run(7, top_k=1) == run(0, temperature=0.0)
    assert lane_seed(7, 3) != lane_seed(7, 4) != lane_seed(8, 3)


def test_deadline_cancels(models, prompts):
    _, _, tm = models
    p, _ = prompts[0]
    got = _serve(_engine(tm), [
        Request(id=0, prompt=p, max_new_tokens=5),
        Request(id=1, prompt=p, max_new_tokens=5, arrival=0.0,
                deadline_ms=1e-6),
    ])
    assert got[0].status == "ok" and len(got[0].tokens) == 5
    assert got[1].status == "deadline"


def test_fault_hook_fires_at_decode_iteration(models, prompts):
    _, _, tm = models
    p, _ = prompts[0]
    sched = Scheduler(_engine(tm), fault=FaultInjector(
        parse_fault_spec("crash@serve_step:2")))
    with pytest.raises(InjectedFault, match="serve_step"):
        sched.run([Request(id=0, prompt=p, max_new_tokens=5)])


def test_unported_seams_raise(models):
    """The tensor-parallel engine is not ported and raises; the policy
    plane is, and the scheduler hands its quota view to the trie."""
    _, _, tm = models
    eng = _engine(tm)
    plane = PolicyPlane(registry=MetricsRegistry())
    Scheduler(eng, policy=plane, registry=MetricsRegistry())
    assert eng.prefix.quotas is plane.prefix_quotas
    with pytest.raises(NotImplementedError, match="TP engine"):
        DecodeEngine(tm, **ENG, device="cpu", mesh=object())


def test_kv_block_round_trip(models, prompts):
    _, _, tm = models
    eng = _engine(tm)
    _serve(eng, [Request(id=0, prompt=prompts[1][0], max_new_tokens=2)])
    blk = eng.prefix._root_children[next(iter(eng.prefix._root_children))]
    data = eng.read_block(blk.block)
    eng.write_block(5, data)
    again = eng.read_block(5)
    for a, b in zip(data["target"], again["target"]):
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert eng.gather_compiles == 1 and eng.put_compiles == 1
