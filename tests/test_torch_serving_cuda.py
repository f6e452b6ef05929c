"""The serving engine's decode step captured as a CUDA graph, on the card.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_serving_cuda.py

Checked, through a Scheduler drive with slot churn, eviction and block
tables rewritten between replays, in fp32, bf16 and with int8 pools and
grouped-query heads:

* the replayed step's logits equal an eager forward of the same model on
  the same inputs taken just before the replay (fp32 atol 1e-4: the same
  kernels, sums possibly in another order; bf16 and int8 atol 5e-2: one
  bf16 rounding of O(10) logits), and its greedy tokens equal the eager
  argmax wherever the eager top-2 gap exceeds twice that tolerance;
* one capture per signature, a replay per decode iteration, the capture
  recording one paged-kernel launch per layer, and the paged kernel's
  runs counted on the card equal to replays x layers, with no launch
  made by its wrapper outside the graph;
* a temperature slot's samples equal those drawn from the eager logits
  with the same per-position seeds.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops import decode_attention as tda
from chainermn_tpu_torch.serving import DecodeEngine, Request, Scheduler

pytestmark = pytest.mark.cuda

SMALL = dict(vocab=257, n_layers=3, d_model=128, n_heads=4, d_ff=256,
             max_len=256, pos_enc="rope", decode_attention="fused")
CONFIGS = {
    "fp32": dict(dtype=torch.float32),
    "bf16": dict(dtype=torch.bfloat16),
    "int8_gqa": dict(dtype=torch.bfloat16, n_kv_heads=2,
                     kv_dtype=torch.int8),
}
TOL = {"fp32": 1e-4, "bf16": 5e-2, "int8_gqa": 5e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode step is captured "
                    "only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _engine(dev, cfg, **over):
    model = TransformerLM(**SMALL, **CONFIGS[cfg], device=dev, seed=0)
    kw = dict(capacity=4, num_blocks=12, block_len=8, prefill_chunk=16)
    return DecodeEngine(model, **{**kw, **over}, device=dev)


def _requests(seed, n=8):
    rng = np.random.RandomState(seed)
    return [Request(id=i, prompt=rng.randint(1, 257, size=int(p)).tolist(),
                    max_new_tokens=int(m))
            for i, (p, m) in enumerate(zip(rng.randint(4, 40, size=n),
                                           rng.randint(4, 24, size=n)))]


def _eager(eng, host):
    tokens, pos, tables, active = (torch.from_numpy(np.ascontiguousarray(a))
                                   .to(eng.device) for a in host)
    with torch.no_grad():
        logits, _ = eng._forward(tokens.long(), pos, tables, active)
    return logits.clone()


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_replayed_step_equals_eager_forward(dev, cfg):
    eng = _engine(dev, cfg)
    seen = []
    replay = eng._replay

    def checked(host):
        want = _eager(eng, host)
        logits, greedy = replay(host)
        seen.append((host[3].copy(), want, logits.clone(), greedy.clone()))
        return logits, greedy

    eng._replay = checked
    comps = Scheduler(eng).run(_requests(1))
    assert all(c.status == "ok" for c in comps)
    assert sum(c.evictions for c in comps) > 0  # the pool forced churn
    assert eng.decode_compiles == 1 and len(eng._graphs) == 1
    tol = TOL[cfg]
    for active, want, got, greedy in seen:
        rows = torch.from_numpy(active).to(dev)
        err = (got[rows] - want[rows]).abs().max().item()
        assert err <= tol, f"{cfg}: logits differ by {err}"
        top2 = want[rows].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        agree = greedy[rows] == want[rows].argmax(dim=-1)
        assert bool(agree[clear].all()), f"{cfg}: greedy token differs"
    assert len(seen) == eng.decode_replays


def test_one_capture_and_counted_replays(dev):
    eng = _engine(dev, "bf16", num_blocks=64)
    Scheduler(eng).run(_requests(2, n=2))  # captures
    graph = next(iter(eng._graphs.values()))
    assert graph.captured == {
        "paged_decode_attention": SMALL["n_layers"],
        "fused_decode_attention": 0,
    }
    eng.drop_prefix_cache()
    replays0 = eng.decode_replays
    tda.paged_decode_attention.launches = 0
    tda.zero_kernel_runs(dev)
    sched = Scheduler(eng)
    sched.run(_requests(3))
    runs = tda.kernel_runs(dev)
    replays = eng.decode_replays - replays0
    assert replays == sched.decode_iterations > 0
    assert runs == {"paged_decode_attention": replays * SMALL["n_layers"],
                    "fused_decode_attention": 0}
    assert tda.paged_decode_attention.launches == 0
    assert eng.decode_compiles == 1 and len(eng._graphs) == 1


def test_temperature_slot_samples_equal_eager(dev):
    eng = _engine(dev, "fp32", num_blocks=32)
    S, MB = eng.capacity, eng.max_blocks
    prompt = list(range(3, 19))
    table = np.zeros((MB,), np.int32)
    table[:4] = eng.alloc_blocks(4)
    eng.seed_slot(1, seed=7, temperature=0.8)
    tok = eng.prefill(1, np.asarray(prompt, np.int32), 0, table,
                      last_idx=len(prompt) - 1)
    tokens = np.zeros(S, np.int32)
    pos = np.zeros(S, np.int32)
    tables = np.zeros((S, MB), np.int32)
    active = np.zeros(S, bool)
    tables[1], active[1] = table, True
    for p in range(len(prompt), len(prompt) + 8):
        tokens[1], pos[1] = tok, p
        host = (tokens.copy(), pos.copy(), tables.copy(), active.copy())
        want = eng._pick(_eager(eng, host), np.arange(S), pos)
        tok = int(eng.step(*host)[1])
        assert tok == int(want[1]), f"position {p}"
    assert eng.decode_replays == 8 and eng.decode_compiles == 1
