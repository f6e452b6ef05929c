"""The bodies of the port's captured programs, run eagerly on the CPU,
against the JAX package on the same bridged parameters.

On a card the engine captures prefill (one graph per ladder geometry) and
the speculative round as CUDA graphs, and the optimizer captures the train
step per batch signature; on the CPU the same function bodies run
eagerly, and that is what these tests hold:

* prefill from a 0-d position tensor, chunks 8, 16 and 32, one of them
  starting mid-block: the tokens and every pool's contents against the
  JAX engine's prefill (fp32, atol 1e-5 on the pools: sums in another
  order);
* the speculative round's body against the JAX ``spec_step``: tokens and
  accepted counts exactly, in fp32, over two rounds;
* the model's positions: a 0-d tensor gives the int's result and never
  takes the verify path, a ``(B,)`` vector does;
* the train step's copy-based double buffering, int8 error feedback and
  EMA against the JAX optimizer (losses rtol 1e-5,
  parameters and option state rtol 1e-5 + atol 1e-6), with the carry,
  residual and average keeping their addresses;
* the capture watch's accounting, as ``tests/serving_tests/
  test_compile_watch.py`` holds the JAX engine's: ``prefill <=
  len(ladder)``, ``spec_round`` 1 and its ``device.spec_round.*`` gauges,
  and a ``train_step`` program with no budget whose batch-shape change
  records a blame naming the argument and axis;
* ``resolve_attention`` with lengths and ``causal``.

No gloo ranks are spawned: the one-rank communicator runs in this
process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chainermn_tpu as cmn
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import classification_loss as jax_cls_loss
from chainermn_tpu.serving import DecodeEngine as JaxEngine
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.models import MLP, TransformerLM, classification_loss
from chainermn_tpu_torch.models import transformer as ttransformer
from chainermn_tpu_torch.observability import MetricsRegistry, SLOMonitor
from chainermn_tpu_torch.observability import device as odev
from chainermn_tpu_torch.ops import (
    FLASH_MIN_SEQ,
    FLASH_MIN_SEQ_NONCAUSAL,
    resolve_attention,
)
from chainermn_tpu_torch.optimizers import (
    adamw,
    create_multi_node_optimizer,
    sgd,
)
from chainermn_tpu_torch.serving import DecodeEngine, Request, Scheduler
from chainermn_tpu_torch.utils import (
    mlp_params_from_flax,
    mlp_params_to_flax,
    params_from_flax,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

LM = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope")
DRAFT = dict(LM, n_layers=1)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)


def _bridge(cfg, seed):
    jm = JaxLM(**cfg, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(**cfg, dtype=torch.float32, decode_attention="fused",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def target():
    return _bridge(LM, 0)


@pytest.fixture(scope="module")
def draft():
    return _bridge(DRAFT, 1)


def _pools_equal(jpools, tpools):
    assert len(jpools) == len(tpools)
    for i, (jl, tl) in enumerate(zip(jpools, tpools)):
        for name in jl:
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]),
                                       err_msg=f"layer {i} {name}",
                                       **POOL_TOL)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 257, size=n) \
        .astype(np.int32)


# ------------------------------------------------------------- positions
def test_zero_d_position_gives_the_int_result_and_no_verify(target,
                                                            monkeypatch):
    """A 0-d tensor start position gives exactly the Python int's output
    and cache writes, and never reaches the paged kernel's multi-query
    (verify) mode; a ``(B,)`` position vector of the same chunk does."""
    _, _, tm = target
    calls = []
    real = ttransformer.paged_decode_attention

    def spy(q, *a, **k):
        calls.append(tuple(q.shape))
        return real(q, *a, **k)

    monkeypatch.setattr(ttransformer, "paged_decode_attention", spy)
    BL, MB = 8, 4
    toks = torch.from_numpy(_prompt(8, 3)[None].astype(np.int64))
    tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    outs = {}
    for name, pos in (("int", 5), ("0-d", torch.tensor(5, dtype=torch.int32))):
        pools = [{n: torch.zeros((tm.kv_heads, 6, BL, tm.head_dim))
                  for n in ("k", "v")} for _ in range(tm.n_layers)]
        h, _ = tm(toks, return_hidden=True, cache=pools, decode_pos=pos,
                  block_tables=tbl)
        outs[name] = (h, pools)
    assert calls == []  # both prefill chunks: gathered attention
    torch.testing.assert_close(outs["0-d"][0], outs["int"][0], rtol=0,
                               atol=0)
    for a, b in zip(outs["0-d"][1], outs["int"][1]):
        for n in a:
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)
    pools = [{n: torch.zeros((tm.kv_heads, 6, BL, tm.head_dim))
              for n in ("k", "v")} for _ in range(tm.n_layers)]
    tm(toks, cache=pools, decode_pos=torch.tensor([5], dtype=torch.int32),
       block_tables=tbl)
    assert calls == [(1, 8, tm.n_heads, tm.head_dim)] * tm.n_layers
    assert MB == tbl.shape[1]


# ----------------------------------------------------------------- prefill
def test_prefill_matches_jax_engine(target):
    """Chunks 32, 16 and 8 of the ladder, the last of them from a start
    position in the middle of a block (as a prefix-cache hit resumes),
    through the port's prefill body (a 0-d device start position, the
    LM head at a device index) and the JAX engine's."""
    jm, params, tm = target
    geo = dict(capacity=2, num_blocks=16, block_len=8, prefill_chunk=32,
               prefix_cache=False)
    jeng = JaxEngine(jm, params, **geo)
    eng = DecodeEngine(tm, **geo, device="cpu")
    assert eng.prefill_ladder == (8, 16, 32)
    MB = eng.max_blocks
    t0 = np.zeros((MB,), np.int32)
    t0[:6] = [1, 2, 3, 4, 5, 6]
    t1 = np.zeros((MB,), np.int32)
    t1[:2] = [7, 8]
    text = _prompt(45, 4)
    c32 = text[:32]
    c16 = np.zeros((16,), np.int32)
    c16[:13] = text[32:]
    mid = np.zeros((8,), np.int32)
    mid[:6] = _prompt(6, 5)
    calls = [(0, c32, 0, t0, -1), (0, c16, 32, t0, 12), (1, mid, 5, t1, 5)]
    for slot, chunk, p0, table, last in calls:
        want = jeng.prefill(slot, chunk, p0, table, last_idx=last)
        got = eng.prefill(slot, chunk, p0, table, last_idx=last)
        assert got == want, (chunk.shape, p0)
    assert eng.prefill_compiles == 3 <= len(eng.prefill_ladder)
    _pools_equal(jeng.pools, eng.pools)


# --------------------------------------------------------- speculative round
def test_spec_round_matches_jax_spec_step(target, draft):
    jm, params, tm = target
    jd, dparams, td = draft
    geo = dict(capacity=2, num_blocks=24, block_len=8, prefill_chunk=16,
               prefix_cache=False, spec_k=3)
    jeng = JaxEngine(jm, params, draft_model=jd, draft_params=dparams, **geo)
    eng = DecodeEngine(tm, draft_model=td, **geo, device="cpu")
    MB = eng.max_blocks
    tables = np.zeros((2, MB), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]
    pos = np.zeros((2,), np.int32)
    tokens = np.zeros((2,), np.int32)
    for s, n in ((0, 11), (1, 5)):
        chunk = np.zeros((16,), np.int32)
        chunk[:n] = _prompt(n, 10 + s)
        want = jeng.prefill(s, chunk, 0, tables[s], last_idx=n - 1)
        assert eng.prefill(s, chunk, 0, tables[s], last_idx=n - 1) == want
        pos[s], tokens[s] = n, want
    active = np.ones((2,), bool)
    accepted = []
    for _ in range(2):
        jt, jn = jeng.spec_step(tokens, pos, tables, active)
        pt, pn = eng.spec_step(tokens, pos, tables, active)
        np.testing.assert_array_equal(pt, np.asarray(jt))
        np.testing.assert_array_equal(pn, np.asarray(jn))
        accepted += pn.tolist()
        for s in range(2):
            pos[s] += int(pn[s]) + 1
            tokens[s] = pt[s, int(pn[s])]
    _pools_equal(jeng.pools, eng.pools)
    _pools_equal(jeng.draft_pools, eng.draft_pools)
    assert eng.verify_compiles == 1 and eng._step.compiles == 0
    assert len(accepted) == 4


# -------------------------------------------------------------- train step
D_IN, HID, B, STEPS = 32, (16,), 32, 3

OPTIONS = {
    "dbuf_sgd": (lambda: optax.sgd(0.1, momentum=0.9),
                 lambda: sgd(0.1, momentum=0.9),
                 dict(double_buffering=True)),
    "int8_ef": (lambda: optax.sgd(0.1, momentum=0.9),
                lambda: sgd(0.1, momentum=0.9),
                dict(grad_compression="int8_ef")),
    "ema_adamw": (lambda: optax.adamw(1e-2, eps=1e-6, weight_decay=0.1),
                  lambda: adamw(1e-2, eps=1e-6, weight_decay=0.1),
                  dict(ema_decay=0.9)),
    "all_three_adamw": (lambda: optax.adamw(1e-2, eps=1e-6,
                                            weight_decay=0.1),
                        lambda: adamw(1e-2, eps=1e-6, weight_decay=0.1),
                        dict(double_buffering=True,
                             grad_compression="int8_ef", ema_decay=0.9)),
}


@pytest.fixture(scope="module")
def mlp_setup():
    model = JaxMLP(hidden=HID, n_out=10)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, D_IN), np.float32))["params"]
    rng = np.random.RandomState(0)
    batches = [(rng.randn(B, D_IN).astype(np.float32),
                rng.randint(0, 10, size=B).astype(np.int32))
               for _ in range(STEPS)]
    return model, jax.tree_util.tree_map(np.asarray, params), batches


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_mlp(params):
    m = MLP(hidden=HID, in_features=D_IN, device="cpu")
    m.load_state_dict(mlp_params_from_flax(params, device="cpu"))
    return m


def _ptrs(d):
    return None if d is None else {n: t.data_ptr() for n, t in d.items()}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_train_step_options_match_jax(mlp_setup, option):
    """The train step's body (``capture=False``, what a card captures)
    with each option, on one rank, against the JAX optimizer (on a
    one-device mesh with int8 error feedback, whose scale is then this
    rank's own, as on the port's one rank)."""
    jm, params, batches = mlp_setup
    jtx, ptx, opts = OPTIONS[option]
    # int8 error feedback shares one scale over the ranks: on one device,
    # as the port's one rank.  The other options reduce means, which the
    # full mesh gives as the existing option tests take them.
    int8 = "grad_compression" in opts
    jcomm = cmn.create_communicator(
        "xla", devices=jax.devices()[:1] if int8 else None)
    jopt = cmn.create_multi_node_optimizer(jtx(), jcomm, **opts)
    js = jopt.init(params)
    jl = []
    for b in batches:
        js, met = jopt.update(js, b, jax_cls_loss(jm), has_aux=True)
        jl.append(float(met["loss"]))
    model = _port_mlp(params)
    popt = create_multi_node_optimizer(
        ptx(), create_communicator("xla", device="cpu"), **opts)
    ps = popt.init(model)
    step = popt.make_train_step(classification_loss(model), has_aux=True,
                                capture=False)
    held = [_ptrs(d) for d in (ps.pending_grads, ps.ef_residual,
                               ps.ema_params)]
    pl = []
    for b in batches:
        ps, met = step(ps, b)
        pl.append(float(met["loss"]))
    # Copies between buffers that keep their addresses, as a captured
    # graph needs them.
    assert [_ptrs(d) for d in (ps.pending_grads, ps.ef_residual,
                               ps.ema_params)] == held
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, js.params))
    got = _flat(mlp_params_to_flax(dict(ps.model.named_parameters())))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    for name in ("pending_grads", "ema_params"):
        if getattr(ps, name) is None:
            continue
        want = _flat(jax.tree_util.tree_map(np.asarray, getattr(js, name)))
        got = _flat(mlp_params_to_flax(getattr(ps, name)))
        for k in want:
            np.testing.assert_allclose(got[k], want[k],
                                       err_msg=f"{name} {k}", **TOL)
    if ps.ef_residual is not None:
        want = _flat(jax.tree_util.tree_map(np.asarray, js.ef_residual))
        got = _flat(mlp_params_to_flax(ps.ef_residual))
        for k in want:
            np.testing.assert_allclose(got[k].reshape(-1),
                                       want[k].reshape(-1),
                                       err_msg=f"ef_residual {k}", **TOL)


# ------------------------------------------------------------------- watch
@pytest.fixture(scope="module")
def spec_churn_run(target):
    """A sharing + speculative engine over a churny 5-requests / 3-slots
    workload (the JAX compile-watch test's geometry), long enough that
    the scheduler crosses its device-publish cadence."""
    _, _, tm = target
    eng = DecodeEngine(tm, capacity=3, num_blocks=32, block_len=8,
                       prefill_chunk=8, draft_model=tm, spec_k=3,
                       device="cpu")
    reg = MetricsRegistry()
    sched = Scheduler(eng, registry=reg,
                      slo=SLOMonitor(registry=reg, check_every=4))
    rng = np.random.RandomState(0)
    reqs = [Request(id=i, prompt=rng.randint(1, 257, size=n).tolist(),
                    max_new_tokens=12)
            for i, n in enumerate((5, 9, 3, 12, 7))]
    comps = sched.run(reqs)
    return eng, reg, comps


def test_watch_budgets_hold_under_spec_churn(spec_churn_run):
    eng, _, comps = spec_churn_run
    assert len(comps) == 5
    assert eng.decode_compiles == 1 and eng.verify_compiles == 1
    assert eng._spec.program == "spec_round" and eng._spec.budget == 1
    assert eng.prefill_compiles == 1 <= len(eng.prefill_ladder)
    assert eng._prefill.budget == len(eng.prefill_ladder)
    assert eng._step.compiles == 0  # the round is the hot loop
    for prog in (eng._step, eng._spec, eng._prefill, eng._cow):
        assert not prog.over_budget, prog.program
    assert "compile_over_budget" not in eng.stats()


def test_scheduler_publishes_spec_round_roofline(spec_churn_run):
    eng, reg, _ = spec_churn_run
    snap = reg.snapshot()
    assert snap["device.spec_round.tflops"]["value"] > 0
    assert snap["device.spec_round.ai"]["value"] > 0
    cost = eng.hot_program.cost_analysis()
    assert cost and cost["flops"] > 0 and cost["bytes accessed"] > 0


def test_train_step_program_blames_the_batch_axis(mlp_setup, monkeypatch):
    """A ``train_step`` program with no budget: an uneven final batch is a
    second signature, recorded with a blame naming each batch leaf and
    axis 0, and no budget is exceeded (on a private watch)."""
    _, params, batches = mlp_setup
    reg = MetricsRegistry()
    monkeypatch.setattr(odev, "_watch", odev.CompileWatch(registry=reg))
    model = _port_mlp(params)
    opt = create_multi_node_optimizer(
        sgd(0.1), create_communicator("xla", device="cpu"))
    state = opt.init(model)
    step = opt.make_train_step(classification_loss(model), has_aux=True)
    assert step.program.program == "train_step"
    assert step.program.budget is None
    for b in batches[:2]:
        state, _ = step(state, b)
    assert step.program.compiles == 1
    x, y = batches[2]
    state, _ = step(state, (x[:20], y[:20]))
    assert step.program.compiles == 2 and not step.program.over_budget
    blame = odev.watch().blames()[-1]
    assert blame["program"] == "train_step" and blame["kind"] == "eager"
    diff = {d["arg"]: d for d in blame["diff"]}
    assert set(diff) == {"batch[0]", "batch[1]"}
    assert diff["batch[0]"]["axes"] == [0]
    assert diff["batch[0]"]["before"]["shape"] == [B, D_IN]
    assert diff["batch[0]"]["after"]["shape"] == [20, D_IN]
    assert reg.snapshot()["compile.budget_exceeded"]["value"] == 0
    assert state.step == 3


def test_capture_needs_a_card():
    model = MLP(hidden=HID, in_features=D_IN, device="cpu")
    opt = create_multi_node_optimizer(
        sgd(0.1), create_communicator("xla", device="cpu"))
    state = opt.init(model)
    step = opt.make_train_step(classification_loss(model), has_aux=True,
                               capture=True)
    x = np.zeros((4, D_IN), np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        step(state, (x, np.zeros((4,), np.int32)))


# --------------------------------------------------------------- crossover
def test_resolve_attention_lengths_and_causality():
    assert resolve_attention("auto", 4096, device="cpu") == "xla"
    assert resolve_attention("auto", 4096, causal=False, device="cpu") \
        == "xla"
    cuda = torch.device("cuda")
    assert resolve_attention("auto", FLASH_MIN_SEQ, device=cuda) == "flash"
    assert resolve_attention("auto", FLASH_MIN_SEQ, 2 * FLASH_MIN_SEQ,
                             device=cuda) == "flash"
    if FLASH_MIN_SEQ > 1:
        assert resolve_attention("auto", FLASH_MIN_SEQ - 1,
                                 device=cuda) == "xla"
        assert resolve_attention("auto", 4096, FLASH_MIN_SEQ - 1,
                                 device=cuda) == "xla"
    assert resolve_attention("auto", FLASH_MIN_SEQ_NONCAUSAL, causal=False,
                             device=cuda) == "flash"
    if FLASH_MIN_SEQ_NONCAUSAL > 1:
        assert resolve_attention("auto", FLASH_MIN_SEQ_NONCAUSAL - 1,
                                 causal=False, device=cuda) == "xla"
    # Two lengths (cross attention) take the causal crossover.
    lo = min(FLASH_MIN_SEQ, FLASH_MIN_SEQ_NONCAUSAL)
    hi = max(FLASH_MIN_SEQ, FLASH_MIN_SEQ_NONCAUSAL)
    assert resolve_attention("auto", hi, hi, causal=False, device=cuda) \
        == "flash"
    if lo < FLASH_MIN_SEQ:
        assert resolve_attention("auto", lo, lo, causal=False,
                                 device=cuda) == "xla"
    assert resolve_attention("flash", 8, device="cpu") == "flash"
    assert resolve_attention("xla", 8192, device=cuda) == "xla"
    with pytest.raises(ValueError):
        resolve_attention("pallas", 128)


def test_model_passes_its_length_to_auto(monkeypatch):
    seen = []
    real = ttransformer.resolve_attention

    def spy(impl, *lengths, **kw):
        seen.append((impl, lengths, kw.get("causal", True)))
        return real(impl, *lengths, **kw)

    monkeypatch.setattr(ttransformer, "resolve_attention", spy)
    m = TransformerLM(vocab=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                      max_len=64, dtype=torch.float32, device="cpu")
    x = torch.randint(0, 64, (2, 24), generator=torch.Generator()
                      .manual_seed(0))
    ref = TransformerLM(vocab=64, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                        max_len=64, dtype=torch.float32, attention="xla",
                        device="cpu")
    torch.testing.assert_close(m(x), ref(x), rtol=0, atol=0)
    auto = [s for s in seen if s[0] == "auto"]
    assert len(auto) == 2 and set(auto) == {("auto", (24,), True)}
