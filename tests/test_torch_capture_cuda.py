"""The compile-once contract on the card: prefill, the speculative round
and the train step captured as CUDA graphs, each against its eager run.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_capture_cuda.py

Checked, in fp32 with TF32 off:

* prefill (chunks 8, 16 and 32, one from a start position in the middle
  of a block) and the speculative round replayed from their graphs give
  the greedy tokens and accepted counts of the same bodies run eagerly on
  a twin engine, and pools within atol 1e-5 (the same kernels; sums
  possibly in another order; the parking block 0 aside, which only the
  captured engine's warm-ups write); one capture per ladder geometry and
  one for the round; two chunks of one geometry issued back to back
  without waiting for the card each read their own controls;
* three train steps captured against three eager ones (``capture=False``)
  from the same weights, for an MLP with SGD momentum, a small LM on the
  flash kernels with AdamW and a small sync-BN ResNet, each plain and
  with double buffering, int8 error feedback and an EMA: losses within
  rtol 1e-5, parameters and the options' state within atol 1e-5; the
  LM under each scheduled rule (AdamW, SGD, LARS, LAMB, Adafactor), the
  same;
* one capture per batch signature, an uneven last batch being a second
  one, and the kernel launches each capture recorded (the LM's K1/K2/K3,
  remat: 2L/L/L per step);
* ``release()`` returns the card bytes of the engine's graphs and pools,
  and of the train step's graphs.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.models import (
    MLP,
    ResNetTiny,
    TransformerLM,
    classification_loss,
    lm_loss,
    resnet_loss,
)
from chainermn_tpu_torch.observability import device as odev
from chainermn_tpu_torch.optimizers import (
    CAPTURE_WARMUP,
    adafactor,
    adamw,
    create_multi_node_optimizer,
    lamb,
    lars,
    sgd,
    warmup_cosine_schedule,
)
from chainermn_tpu_torch.serving import DecodeEngine

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.cuda

LM = dict(vocab=257, n_layers=2, d_model=64, n_heads=4, d_ff=128,
          max_len=128, pos_enc="rope", decode_attention="fused",
          dtype=torch.float32)
POOL_ATOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 257, size=n) \
        .astype(np.int32)


def _engines(dev, **kw):
    """A captured engine and its twin, whose bodies the test calls
    eagerly, over the same weights."""
    out = []
    for _ in range(2):
        tm = TransformerLM(**LM, device=dev, seed=0)
        d = (TransformerLM(**{**LM, "n_layers": 1}, device=dev, seed=1)
             if kw.get("spec_k") else None)
        out.append(DecodeEngine(tm, draft_model=d, prefix_cache=False,
                                device=dev, **kw))
    return out


def _pools_close(a, b):
    """Every block but the parking block 0, which the captured engine's
    warm-ups write and no request reads."""
    for la, lb in zip(a, b):
        for n in la:
            err = (la[n][:, 1:].float() - lb[n][:, 1:].float()).abs().max() \
                .item()
            assert err <= POOL_ATOL, (n, err)


def _eager_prefill(eng, chunk, p0, table, last):
    ctrl = torch.from_numpy(np.concatenate(
        [chunk, [p0, max(last, 0)], table]).astype(np.int32)).to(eng.device)
    C = len(chunk)
    with torch.no_grad():
        _, greedy = eng._prefill_views(ctrl[:C], ctrl[C:C + 1],
                                       ctrl[C + 1:C + 2], ctrl[C + 2:])
    return int(greedy[0]) if last >= 0 else None


def test_captured_prefill_equals_eager(dev):
    eng, twin = _engines(dev, capacity=2, num_blocks=16, block_len=8,
                         prefill_chunk=32)
    MB = eng.max_blocks
    t0 = np.zeros((MB,), np.int32)
    t0[:10] = np.arange(1, 11)
    t1 = np.zeros((MB,), np.int32)
    t1[:2] = [11, 12]
    # Two 32-chunks back to back (neither the last: no wait for the
    # card between them), then a 16-chunk tail.
    text = _prompt(77, 4)
    c16 = np.zeros((16,), np.int32)
    c16[:13] = text[64:]
    mid = np.zeros((8,), np.int32)
    mid[:6] = _prompt(6, 5)
    calls = [(0, text[:32], 0, t0, -1), (0, text[32:64], 32, t0, -1),
             (0, c16, 64, t0, 12), (1, mid, 5, t1, 5),
             (1, _prompt(8, 6), 11, t1, 7)]
    for slot, chunk, p0, table, last in calls:
        got = eng.prefill(slot, chunk, p0, table, last_idx=last)
        want = _eager_prefill(twin, chunk, p0, table, last)
        assert got == want, (len(chunk), p0)
    torch.cuda.synchronize()
    _pools_close(eng.pools, twin.pools)
    assert eng.prefill_compiles == 3 == len(eng._prefill_graphs)
    assert eng.prefill_replays == len(calls)
    assert eng.prefill_compiles <= len(eng.prefill_ladder)
    kinds = [r["kind"] for r in odev.watch().records()
             if r["program"] == "prefill"][-3:]
    assert kinds == ["capture"] * 3


def test_captured_spec_round_equals_eager(dev):
    eng, twin = _engines(dev, capacity=2, num_blocks=24, block_len=8,
                         prefill_chunk=16, spec_k=3)
    MB = eng.max_blocks
    tables = np.zeros((2, MB), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]
    pos = np.zeros((2,), np.int32)
    tokens = np.zeros((2,), np.int32)
    for s, n in ((0, 11), (1, 5)):
        chunk = np.zeros((16,), np.int32)
        chunk[:n] = _prompt(n, 10 + s)
        tok = eng.prefill(s, chunk, 0, tables[s], last_idx=n - 1)
        assert _eager_prefill(twin, chunk, 0, tables[s], n - 1) == tok
        pos[s], tokens[s] = n, tok
    active = np.ones((2,), bool)
    for _ in range(4):
        toks, n_acc = eng.spec_step(tokens, pos, tables, active)
        dev_in = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (tokens, pos, tables, active)]
        with torch.no_grad():
            g, n, _ = twin._spec_forward(dev_in[0].long(), *dev_in[1:])
        np.testing.assert_array_equal(toks, g.to(torch.int32).cpu().numpy())
        np.testing.assert_array_equal(n_acc, n.to(torch.int32).cpu().numpy())
        for s in range(2):
            pos[s] += int(n_acc[s]) + 1
            tokens[s] = toks[s, int(n_acc[s])]
    torch.cuda.synchronize()
    _pools_close(eng.pools, twin.pools)
    _pools_close(eng.draft_pools, twin.draft_pools)
    assert eng.verify_compiles == 1 == len(eng._spec_graphs)
    assert eng.spec_replays == 4 and eng.decode_compiles == 1
    graph = next(iter(eng._spec_graphs.values()))
    # k + 1 draft steps (one layer each) and the verify forward (2).
    assert graph.captured["paged_decode_attention"] == 4 * 1 + 2


def test_engine_release_returns_graph_bytes(dev):
    def drive():
        eng = _engines(dev, capacity=2, num_blocks=24, block_len=8,
                       prefill_chunk=16, spec_k=3)[0]
        tables = np.zeros((2, eng.max_blocks), np.int32)
        tables[0, :3] = [1, 2, 3]
        chunk = _prompt(16, 1)
        tok = eng.prefill(0, chunk, 0, tables[0], last_idx=15)
        eng.prefill(1, chunk[:8], 0, tables[1], last_idx=7)
        eng.spec_step(np.array([tok, 0], np.int32),
                      np.array([16, 0], np.int32), tables,
                      np.array([True, False]))
        return eng

    drive().release()  # the kernels' run counter, libraries, workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    eng = drive()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) > base
    eng.release()
    torch.cuda.synchronize()
    # The engine's models stay referenced; their weights are what remains.
    weights = sum(p.numel() * p.element_size()
                  for m in (eng.model, eng.draft_model)
                  for p in m.parameters())
    assert torch.cuda.memory_allocated(dev) <= base + weights + (1 << 20)
    assert eng.released and not eng._prefill_graphs and not eng._spec_graphs


# ------------------------------------------------------------- train step
OPTIONS = {"plain": {}, "double_buffering": dict(double_buffering=True),
           "int8_ef": dict(grad_compression="int8_ef"),
           "ema": dict(ema_decay=0.9)}


def _mlp(dev, seed):
    return MLP(hidden=(64, 64), in_features=32, device=dev, seed=seed)


def _lm(dev, seed):
    return TransformerLM(vocab=256, n_layers=2, d_model=64, n_heads=2,
                         d_ff=128, max_len=128, dtype=torch.float32,
                         attention="flash", remat=True, device=dev,
                         seed=seed)


def _resnet(dev, seed, comm):
    return ResNetTiny(num_classes=10, width=8, dtype=torch.float32,
                      axis_name=comm.axis_name, device=dev, seed=seed)


def _batches(kind, dev, n=3, rows=8):
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for _ in range(n):
        if kind == "mlp":
            out.append((torch.randn((rows, 32), generator=g, device=dev),
                        torch.randint(0, 10, (rows,), generator=g,
                                      device=dev)))
        elif kind == "lm":
            t = torch.randint(0, 256, (rows, 64), generator=g, device=dev)
            out.append((t, t))
        else:
            out.append((torch.randn((rows, 32, 32, 3), generator=g,
                                    device=dev),
                        torch.randint(0, 10, (rows,), generator=g,
                                      device=dev)))
    return out


def _run(kind, dev, comm, opts, capture, tx=None):
    if kind == "mlp":
        model, tx = _mlp(dev, 0), sgd(0.05, momentum=0.9)
        loss, kw = classification_loss(model), dict(has_aux=True)
    elif kind == "lm":
        model = _lm(dev, 0)
        tx = tx or adamw(1e-3, eps=1e-6, weight_decay=0.01)
        loss, kw = lm_loss(model), dict(has_aux=True)
    else:
        model, tx = _resnet(dev, 0, comm), sgd(0.05, momentum=0.9)
        loss, kw = resnet_loss(model), dict(stateful=True)
    opt = create_multi_node_optimizer(tx, comm, **opts)
    state = opt.init(model)
    step = opt.make_train_step(loss, capture=capture, **kw)
    losses = []
    for b in _batches(kind, dev):
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    tensors = {f"p:{n}": p.detach().clone()
               for n, p in model.named_parameters()}
    tensors.update({f"b:{n}": b.clone() for n, b in model.named_buffers()})
    for name in ("pending_grads", "ef_residual", "ema_params"):
        for n, t in (getattr(state, name) or {}).items():
            tensors[f"{name}:{n}"] = t.clone()
    return losses, tensors, step


@pytest.fixture
def comm(dev):
    return create_communicator("xla", device=dev)


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, restored afterwards: the int8
    error feedback turns a last-bit difference between two runs of a
    convolution's fp32 sums into another int8 code, so the captured and
    the eager ResNet run must sum in one order."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("kind", ["mlp", "lm", "resnet"])
def test_captured_train_step_equals_eager(comm, kind, option,
                                          deterministic_cudnn):
    dev = comm.device
    lc, tc, step = _run(kind, dev, comm, OPTIONS[option], True)
    le, te, _ = _run(kind, dev, comm, OPTIONS[option], False)
    assert all(np.isfinite(lc))
    np.testing.assert_allclose(lc, le, rtol=LOSS_RTOL)
    assert sorted(tc) == sorted(te)
    for n in tc:
        err = (tc[n].float() - te[n].float()).abs().max().item()
        assert err <= PARAM_ATOL, f"{kind}/{option} {n}: {err}"
    assert step.program.compiles == 1 and len(step.graphs) == 1
    assert step.program.replays == 2
    graph = next(iter(step.graphs.values()))
    if kind == "lm":
        assert (graph.captured["flash_attention_fwd"],
                graph.captured["flash_attention_bwd_dkv"],
                graph.captured["flash_attention_bwd_dq"]) == (4, 2, 2)
    step.release()


def _scheduled(rule):
    """``rule`` under a ramp from 0 over 2 steps into cosine decay: each
    of three steps has another learning rate."""
    s = warmup_cosine_schedule(1e-2, 2, 6)
    return {"adamw": lambda: adamw(s, eps=1e-6, weight_decay=0.01),
            "sgd": lambda: sgd(s, momentum=0.9),
            "lars": lambda: lars(s), "lamb": lambda: lamb(s),
            "adafactor": lambda: adafactor(s)}[rule]()


@pytest.mark.parametrize("rule", ["adamw", "sgd", "lars", "lamb",
                                  "adafactor"])
def test_captured_schedule_equals_eager(comm, rule):
    """The schedule is evaluated inside the captured step: three captured
    steps of the small LM under each scheduled rule equal three eager ones
    (a rate baked in at the capture would differ from the third step
    on)."""
    dev = comm.device
    lc, tc, step = _run("lm", dev, comm, {}, True, tx=_scheduled(rule))
    le, te, _ = _run("lm", dev, comm, {}, False, tx=_scheduled(rule))
    assert all(np.isfinite(lc))
    np.testing.assert_allclose(lc, le, rtol=LOSS_RTOL)
    for n in tc:
        err = (tc[n].float() - te[n].float()).abs().max().item()
        assert err <= PARAM_ATOL, f"{rule} {n}: {err}"
    assert step.program.compiles == 1 and step.program.replays == 2
    step.release()


def test_one_capture_per_signature_uneven_last_batch(comm):
    dev = comm.device
    model = _mlp(dev, 0)
    opt = create_multi_node_optimizer(sgd(0.05, momentum=0.9), comm)
    state = opt.init(model)
    step = opt.make_train_step(classification_loss(model), has_aux=True)
    full = _batches("mlp", dev, n=4, rows=8)
    last = _batches("mlp", dev, n=1, rows=5)[0]
    for b in full[:3] + [last] + full[3:] + [last]:
        state, met = step(state, b)
        assert np.isfinite(float(met["loss"]))
    assert step.program.compiles == 2 == len(step.graphs)
    assert step.program.replays == 6 - 2
    rec = [r for r in odev.watch().records()
           if r["program"] == "train_step"][-1]
    assert rec["kind"] == "capture"
    diff = {d["arg"]: d for d in rec["diff"]}
    assert diff["batch[0]"]["axes"] == [0]
    assert diff["batch[1]"]["axes"] == [0]
    assert state.step == 6
    step.release()


def test_train_step_release_returns_graph_bytes(comm):
    dev = comm.device
    model = _lm(dev, 0)
    opt = create_multi_node_optimizer(adamw(1e-3), comm)
    state = opt.init(model)
    batches = _batches("lm", dev)

    def drive():
        nonlocal state
        step = opt.make_train_step(lm_loss(model), has_aux=True)
        for b in batches:
            state, met = step(state, b)
            del met
        torch.cuda.synchronize()
        return step

    # The first capture builds the optimizer's state and the libraries'
    # per-stream workspaces, which stay.
    drive().release()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    step = drive()
    assert torch.cuda.memory_allocated(dev) > base
    step.release()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) <= base
    assert not step.graphs and CAPTURE_WARMUP >= 1
