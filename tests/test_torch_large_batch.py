"""The port's update rules against optax, leaf by leaf: LARS (with and
without Nesterov), LAMB, Adafactor, and the scheduled SGD and AdamW, over
5 steps from the same parameters and gradients; the schedules and linear
LR scaling; the kernel mask and the Flax shapes, read off the weight
bridge, against the JAX package's on bridged models.

Leaves: a dense kernel and bias, a normalization scale, a conv kernel, a
zero-initialized kernel (LARS/LAMB's zero-norm guard), two leaves that
Adafactor factors (256 x 160 and a 130 x 130 tie), a 3-D one (4 x 130 x
200) and a small one it does not; a zero gradient on one leaf at step 3
(the zero update-norm guard).  float32 on the CPU.  Tolerance: every
parameter within 1e-6 of its optax value's largest magnitude, each step
(the same fp32 operations; optax fuses them under jit, so the last bit of
a sum may differ).  The scheduled AdamW is torch's AdamW, which forms the
bias corrections ``1 - b ** t`` in float64 where optax rounds them to
float32 (``1 - 0.999`` is off by 5e-5 relative there): against a float64
AdamW, over the 5 steps, the port stays within 2e-7 of each leaf's
largest magnitude and optax within 1.01e-5 (the zero-initialized
kernel), so the port is held within 2e-5 of it to optax and within 1e-6
of it to the float64 AdamW.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from chainermn_tpu.models import Seq2Seq as JaxLSTM
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import TransformerSeq2Seq as JaxS2S
from chainermn_tpu.models import ViT as JaxViT
from chainermn_tpu.optimizers import kernel_mask as jax_kernel_mask
from chainermn_tpu.optimizers import lamb as jax_lamb
from chainermn_tpu.optimizers import lars as jax_lars
from chainermn_tpu.optimizers import linear_scaled_lr as jax_linear_scaled_lr
from chainermn_tpu.optimizers import (
    warmup_cosine_schedule as jax_warmup_cosine,
)
from chainermn_tpu_torch.models import (
    Seq2Seq,
    TransformerLM,
    TransformerSeq2Seq,
    ViT,
)
from chainermn_tpu_torch.optimizers import (
    adafactor,
    adamw,
    kernel_mask,
    lamb,
    lars,
    linear_scaled_lr,
    sgd,
    warmup_cosine_schedule,
)
from chainermn_tpu_torch.utils import (
    flax_shapes,
    lstm_seq2seq_params_from_flax,
    lstm_seq2seq_params_to_flax,
    params_from_flax,
    params_to_flax,
    seq2seq_params_from_flax,
    seq2seq_params_to_flax,
    vit_params_from_flax,
    vit_params_to_flax,
)

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

REL = 1e-6
STEPS = 5
SHAPES = {"dense_kernel": (8, 4), "dense_bias": (4,), "bn_scale": (8,),
          "conv_kernel": (3, 3, 2, 4), "zero_kernel": (6, 5),
          "wide": (256, 160), "tie": (130, 130), "cube": (4, 130, 200)}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    out = {k: rng.normal(size=s).astype(np.float32)
           for k, s in SHAPES.items()}
    out["bn_scale"] = np.ones(SHAPES["bn_scale"], np.float32)
    out["zero_kernel"] = np.zeros(SHAPES["zero_kernel"], np.float32)
    return out


def _grads(step, seed=1):
    rng = np.random.RandomState(seed + step)
    out = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
           for k, s in SHAPES.items()}
    if step == 3:
        out["dense_kernel"] = np.zeros(SHAPES["dense_kernel"], np.float32)
    return out


def _run(jax_tx, port_factory, rel=REL):
    """Both optimizers from the same parameters through the same gradients;
    the parameters compared after every step, within ``rel`` of the optax
    value's largest magnitude."""
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    st = jax_tx.init(jp)
    upd = jax.jit(jax_tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v))
          for k, v in _params().items()}
    opt = port_factory(list(tp.values()))
    for i in range(STEPS):
        g = _grads(i)
        u, st = upd({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in SHAPES:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(
                tp[k].detach().numpy(), want, rtol=0,
                atol=rel * max(np.abs(want).max(), 1e-30),
                err_msg=f"{k} after step {i}")
    return tp


SCHED = dict(peak_lr=0.05, warmup_steps=2, total_steps=6)


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
@pytest.mark.parametrize("scheduled", [False, True], ids=["const", "sched"])
def test_lars_matches_optax(nesterov, scheduled):
    lr = jax_warmup_cosine(**SCHED) if scheduled else 0.05
    plr = warmup_cosine_schedule(**SCHED) if scheduled else 0.05
    _run(jax_lars(lr, nesterov=nesterov, trust_coefficient=0.01),
         lars(plr, nesterov=nesterov, trust_coefficient=0.01))


@pytest.mark.parametrize("scheduled", [False, True], ids=["const", "sched"])
def test_lamb_matches_optax(scheduled):
    lr = jax_warmup_cosine(**SCHED) if scheduled else 0.01
    plr = warmup_cosine_schedule(**SCHED) if scheduled else 0.01
    _run(jax_lamb(lr), lamb(plr))


@pytest.mark.parametrize("scheduled", [False, True], ids=["const", "sched"])
def test_adafactor_matches_optax(scheduled):
    """optax.adafactor at the JAX ``train_lm``'s defaults: factored
    statistics where the two largest axes are >= 128 (``wide``, the
    ``tie`` and ``cube``), a full one elsewhere."""
    lr = jax_warmup_cosine(**SCHED) if scheduled else 0.01
    plr = warmup_cosine_schedule(**SCHED) if scheduled else 0.01
    _run(optax.adafactor(lr), adafactor(plr))


def test_scheduled_sgd_and_adamw_match_optax():
    lr = jax_warmup_cosine(**SCHED)
    plr = warmup_cosine_schedule(**SCHED)
    _run(optax.sgd(lr, momentum=0.9, nesterov=True),
         sgd(plr, 0.9, nesterov=True))
    _run(optax.sgd(lr), sgd(plr))
    tp = _run(optax.adamw(lr, weight_decay=0.01),
              adamw(plr, weight_decay=0.01), rel=2e-5)
    # The float64 reference: optax.adamw's arithmetic, the schedule's
    # values as float64.
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    for k, p in _params().items():
        p, m, v = p.astype(np.float64), 0.0, 0.0
        for i in range(STEPS):
            g = _grads(i)[k].astype(np.float64)
            m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
            d = (m / (1 - b1 ** (i + 1))) / (
                np.sqrt(v / (1 - b2 ** (i + 1))) + eps)
            p = p - float(lr(i)) * (d + wd * p)
        np.testing.assert_allclose(tp[k].detach().numpy(), p, rtol=0,
                                   atol=REL * max(np.abs(p).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("args,kw", [
    ((0.1, 3, 10), {}), ((0.1, 3, 10), dict(warmup_factor=0.1, end_lr=0.01)),
    ((0.1, 0, 10), {}), ((0.1, 4, 4), {}), ((0.1, 0, 0), {})],
    ids=["warmup_cosine", "factor_end", "cosine", "ramp_only", "constant"])
def test_schedules_match_the_jax_package(args, kw):
    want = jax_warmup_cosine(*args, **kw)
    got = warmup_cosine_schedule(*args, **kw)
    for c in range(12):
        assert float(got(torch.tensor(float(c)))) == pytest.approx(
            float(want(c)), rel=1e-6, abs=1e-9)
    with pytest.raises(ValueError, match="total_steps"):
        warmup_cosine_schedule(0.1, 5, 3)


def test_linear_scaled_lr():
    for g, b in ((8192, 256), (256, 256), (512, 128)):
        assert linear_scaled_lr(0.1, g, b) == jax_linear_scaled_lr(0.1, g, b)
    with pytest.raises(ValueError):
        linear_scaled_lr(0.1, 0, 256)


def test_kernel_mask_matches_the_jax_package_on_vit():
    """The port's fused qkv bias is 1-D where the Flax one is (3, H, Dh):
    ``kernel_mask`` follows the JAX package's ranks, not the port's."""
    geom = dict(num_classes=5, patch=16, d_model=32, n_heads=2, d_ff=64,
                n_layers=2)
    jm = JaxViT(**geom, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
        ["params"])
    tm = ViT(**geom, image_size=32, dtype=torch.float32, device="cpu")
    tm.load_state_dict(vit_params_from_flax(params, device="cpu"))
    mask = kernel_mask(tm, functools.partial(vit_params_to_flax, n_heads=2))
    as_tensors = {n: torch.full_like(p, float(mask[p]))
                  for n, p in tm.named_parameters()}
    got = jax.tree_util.tree_leaves(vit_params_to_flax(as_tensors, 2))
    want = jax.tree_util.tree_leaves(jax_kernel_mask(params))
    assert [bool(np.all(g)) for g in got] == [bool(w) for w in want]
    assert all(np.all(g) or not np.any(g) for g in got)
    assert mask[tm.blocks[0].qkv.bias] and not mask[tm.blocks[0].proj.bias]


def test_adafactor_factors_the_jax_layout_of_the_lm():
    """On the LM's parameters (d_model 128, 4 heads of 32): the JAX qkv
    kernel (128, 3, 4, 32) keeps a full second moment (its second-largest
    axis is 32) where the port's (384, 128) weight would factor;
    ``flax_shapes`` makes the port compute on the Flax view.  Three steps
    from the same parameters and gradients, every leaf within 1e-6 of its
    optax value's largest magnitude."""
    kw = dict(vocab=160, n_layers=1, d_model=128, n_heads=4, d_ff=256,
              max_len=16)
    params = jax.tree_util.tree_map(np.asarray, JaxLM(
        **kw, dtype=jnp.float32, attention="xla").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = TransformerLM(**kw, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    shapes = flax_shapes(tm, functools.partial(params_to_flax, n_heads=4))
    assert shapes[tm.blocks[0].qkv.weight] == (128, 3, 4, 32)
    assert shapes[tm.blocks[0].proj.weight] == (4, 32, 128)
    tx = optax.adafactor(0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    opt = adafactor(0.01, shapes=shapes)(list(tm.parameters()))
    rng = np.random.RandomState(4)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32),
            params)
        u, st = jax.jit(tx.update)(g, st, jp)
        jp = optax.apply_updates(jp, u)
        tg = params_from_flax(g, device="cpu")
        for n, p in tm.named_parameters():
            p.grad = tg[n]
        opt.step()
    got = params_to_flax(dict(tm.named_parameters()), kw["n_heads"])
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(v)
                      for path, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(jp)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=REL * np.abs(want[k]).max(),
                                   err_msg=k)


def _bridged(kind):
    """``(JAX params as numpy, the port's model carrying them, its
    to_flax)`` for one model whose bridge this module's layouts come
    from."""
    if kind == "seq2seq":
        kw = dict(vocab_src=37, vocab_tgt=37, d_model=32, n_heads=4,
                  d_ff=64, n_enc=1, n_dec=1, max_len=16)
        z = jnp.zeros((1, 8), jnp.int32)
        params = JaxS2S(**kw, dtype=jnp.float32, attention="xla").init(
            jax.random.PRNGKey(0), z, z)["params"]
        tm = TransformerSeq2Seq(**kw, attention="xla", device="cpu")
        load, to_flax = seq2seq_params_from_flax, functools.partial(
            seq2seq_params_to_flax, n_heads=4)
    elif kind == "lstm":
        kw = dict(vocab_src=37, vocab_tgt=37, embed=8, hidden=16)
        z = jnp.ones((1, 6), jnp.int32)
        params = JaxLSTM(**kw).init(jax.random.PRNGKey(0), z, z)["params"]
        tm = Seq2Seq(**kw, device="cpu")
        load, to_flax = lstm_seq2seq_params_from_flax, \
            lstm_seq2seq_params_to_flax
    else:  # the LM with grouped-query attention: split q and kv
        kw = dict(vocab=64, n_layers=1, d_model=32, n_heads=4, d_ff=64,
                  max_len=16, n_kv_heads=2)
        params = JaxLM(**kw, dtype=jnp.float32, attention="xla").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        tm = TransformerLM(**kw, dtype=torch.float32, device="cpu")
        load, to_flax = params_from_flax, functools.partial(
            params_to_flax, n_heads=4, n_kv_heads=2)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict(load(params, device="cpu"))
    return params, tm, to_flax


@pytest.mark.parametrize("kind", ["seq2seq", "lstm", "lm_gqa"])
def test_kernel_mask_and_shapes_follow_the_bridge(kind):
    """The bridge's ``flax_shapes`` (zero-stride stand-ins) gives each
    parameter the shape of the Flax leaf it becomes (held against the
    mapping run on the parameters themselves), and ``kernel_mask`` is
    the JAX package's mask, leaf by leaf."""
    params, tm, to_flax = _bridged(kind)
    shapes = flax_shapes(tm, to_flax)
    named = dict(tm.named_parameters())
    tagged = to_flax({n: torch.full_like(p, float(i))
                      for i, (n, p) in enumerate(named.items())})
    byindex = list(named.values())
    for leaf in jax.tree_util.tree_leaves(tagged):
        assert shapes[byindex[int(leaf.flat[0])]] == leaf.shape
    assert set(shapes) == set(byindex)
    mask = kernel_mask(tm, to_flax)
    got = jax.tree_util.tree_leaves(to_flax(
        {n: torch.full_like(p, float(mask[p])) for n, p in named.items()}))
    want = jax.tree_util.tree_leaves(jax_kernel_mask(params))
    assert [bool(np.all(g)) for g in got] == [bool(w) for w in want]


def test_flax_shapes_refuses_a_split_without_the_transpose():
    """A mapping that splits an ``(out, in)`` weight's axes without
    transposing it (which the optimizers' Flax views would misread)
    raises; the bridge's transposing rule passes."""
    lin = torch.nn.Linear(6, 4)

    def transposed(sd):
        return {"kernel": sd["weight"].numpy().T.reshape(6, 2, 2),
                "bias": sd["bias"].numpy().reshape(2, 2)}

    def untransposed(sd):
        return {"kernel": sd["weight"].numpy().reshape(2, 2, 6),
                "bias": sd["bias"].numpy().reshape(2, 2)}

    assert flax_shapes(lin, transposed) == {lin.weight: (6, 2, 2),
                                            lin.bias: (2, 2)}
    with pytest.raises(ValueError, match="without transposing"):
        flax_shapes(lin, untransposed)


def test_scheduled_adamw_resumes_from_a_state_dict():
    """A scheduled AdamW restored from a ``state_dict`` (whose learning
    rate is a host copy of the card's tensor) continues the schedule from
    the saved step count: 2 + 2 steps equal 4 steps exactly."""
    import io

    sched = warmup_cosine_schedule(**SCHED)

    def fresh(p0):
        p = torch.nn.Parameter(p0.clone())
        return p, adamw(sched, weight_decay=0.01)([p])

    p0 = torch.from_numpy(_params()["wide"])
    p, opt = fresh(p0)
    for i in range(4):
        p.grad = torch.from_numpy(_grads(i)["wide"])
        opt.step()
    q, opt2 = fresh(p0)
    for i in range(2):
        q.grad = torch.from_numpy(_grads(i)["wide"])
        opt2.step()
    buf = io.BytesIO()
    torch.save(opt2.state_dict(), buf)
    buf.seek(0)
    r, opt3 = fresh(q.detach())
    lr = opt3.param_groups[0]["lr"]
    opt3.load_state_dict(torch.load(buf))
    for i in range(2, 4):
        r.grad = torch.from_numpy(_grads(i)["wide"])
        opt3.step()
    assert opt3.param_groups[0]["lr"] is lr
    assert float(lr) == pytest.approx(float(sched(3)), rel=1e-7)
    torch.testing.assert_close(r.detach(), p.detach(), rtol=0, atol=0)
