"""TransformerLM training in the port against the JAX package, on Flax
parameters carried across by ``params_from_flax``.

Loss and every gradient leaf (read back into the Flax layout by
``params_to_flax``) against ``lm_loss`` + ``jax.value_and_grad``; two
AdamW steps of the port's ``MultiNodeOptimizer`` against
``create_multi_node_optimizer(optax.adamw(...), create_communicator("xla"))``
on the conftest's 8-device CPU mesh; remat and gradient accumulation
against the plain step; the ``train_lm`` twin end to end.

Geometry: 2 layers, d_model 32, 4 heads, vocab 64, T 32, float32 on the
CPU.  The JAX model runs ``attention="xla"`` (one tiny case runs its
flash kernels in interpret mode).  Tolerances: loss 1e-5; gradients and
parameters atol 2e-5 + rtol 1e-4 (float32 through two blocks, sums in
another order; Adam's update divides by sqrt of the second moment, which
scales a tiny gradient difference up to at most ~lr times its relative
size).  The optimizer comparisons pass Adam ``eps = 1e-6`` to both sides:
the key-bias gradients are zero up to rounding (softmax ignores a shift
of every score), and at the default 1e-8 Adam's ``g / (|g| + eps)`` turns
that rounding noise of ~1e-9 into updates of ~lr/10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chainermn_tpu as cmn
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import lm_loss as jax_lm_loss
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.optimizers import (
    adafactor,
    adamw,
    create_multi_node_optimizer,
    lamb,
    lars,
    sgd,
    warmup_cosine_schedule,
)
from chainermn_tpu_torch.utils import params_from_flax, params_to_flax

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
EPS = 1e-6
BASE = dict(vocab=64, n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=32)
T = 32


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(**over):
    kw = {**BASE, **over}
    attention = kw.pop("attention", "xla")
    jm = JaxLM(**kw, dtype=jnp.float32, attention=attention)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = TransformerLM(**kw, dtype=torch.float32, attention=attention,
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


def _batch(B, packed=False, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, BASE["vocab"], size=(B, T)).astype(np.int32)
    targets = rng.randint(0, BASE["vocab"], size=(B, T)).astype(np.int32)
    if not packed:
        return tokens, targets
    seg = np.zeros((B, T), np.int32)
    for r in range(B):
        cut = [0, *sorted(rng.choice(np.arange(4, T - 4), 2, replace=False)),
               T - 3]
        for s, (a, b) in enumerate(zip(cut[:-1], cut[1:]), start=1):
            seg[r, a:b] = s
        targets[r, T - 3:] = -1  # padding tail: segment 0, ignored
        targets[r, np.asarray(cut[1:-1]) - 1] = -1  # documents' last tokens
    return tokens, targets, seg


def _torch_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    loss, aux = lm_loss(tm)(tm, batch)
    loss.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    return float(loss.detach()), grads, aux


CASES = {
    "learned_mha": dict(),
    "rope_gqa_window": dict(pos_enc="rope", n_kv_heads=2, window=6),
    "learned_packed": dict(packed=True),
    "rope_mqa_packed_window": dict(pos_enc="rope", n_kv_heads=1, window=9,
                                   packed=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name):
    over = dict(CASES[name])
    packed = over.pop("packed", False)
    jm, params, tm = _pair(**over)
    batch = _batch(4, packed=packed, seed=len(name))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jax_lm_loss(jm), has_aux=True))(
        params, tuple(jnp.asarray(x) for x in batch))
    tl, tg, taux = _torch_grads(tm, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ppl_log"]), float(jaux["ppl_log"]),
                               rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    got = _flat(params_to_flax(tg, BASE["n_heads"], over.get("n_kv_heads",
                                                             0)))
    assert sorted(got) == sorted(want)
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], err_msg=leaf,
                                   **GRAD_TOL)


def test_flash_model_grads_match_jax_flash_kernels():
    """One tiny case with ``attention="flash"`` on both sides: the JAX
    Pallas kernels in interpret mode, the port's flash path (its plain
    versions on the CPU)."""
    jm, params, tm = _pair(attention="flash", n_layers=1, pos_enc="rope",
                           n_kv_heads=2)
    tokens, targets, seg = _batch(2, packed=True, seed=3)
    batch = (tokens[:, :16], targets[:, :16], seg[:, :16])
    (jl, _), jg = jax.jit(jax.value_and_grad(jax_lm_loss(jm), has_aux=True))(
        params, tuple(jnp.asarray(x) for x in batch))
    tl, tg, _ = _torch_grads(tm, batch)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jg))
    got = _flat(params_to_flax(tg, BASE["n_heads"], 2))
    for leaf in want:
        np.testing.assert_allclose(got[leaf], want[leaf], err_msg=leaf,
                                   **GRAD_TOL)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_remat_gives_the_same_gradients(attention):
    batch = _batch(2, packed=True, seed=4)
    out = []
    for remat in (False, True):
        tm = TransformerLM(**BASE, dtype=torch.float32, attention=attention,
                           pos_enc="rope", remat=remat, device="cpu", seed=1)
        _, grads, _ = _torch_grads(tm, batch)
        out.append({n: g.clone() for n, g in grads.items()})
    for n in out[0]:
        torch.testing.assert_close(out[1][n], out[0][n], rtol=0, atol=0,
                                   msg=n)


def _jax_steps(jm, params, batches, lr, wd):
    comm = cmn.create_communicator("xla")
    opt = cmn.create_multi_node_optimizer(
        optax.adamw(lr, eps=EPS, weight_decay=wd), comm)
    state = opt.init(params)
    loss_fn = jax_lm_loss(jm)
    losses = []
    for b in batches:
        state, m = opt.update(state, b, loss_fn, has_aux=True)
        losses.append(float(m["loss"]))
    return losses, _flat(jax.tree_util.tree_map(np.asarray, state.params))


def _torch_steps(tm, batches, lr, wd, accum=1, comm_name="xla"):
    comm = create_communicator(comm_name, device="cpu")
    opt = create_multi_node_optimizer(adamw(lr, eps=EPS, weight_decay=wd),
                                      comm)
    state = opt.init(tm)
    step = opt.make_train_step(lm_loss(tm), has_aux=True, accum_steps=accum)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert state.step == len(batches)
    return losses, state


def test_two_adamw_steps_match_jax_optimizer():
    """Batch 8 over the 8-device mesh, no padding: the per-device token
    means average to the global mean the port's one rank computes."""
    lr, wd = 1e-3, 0.01
    jm, params, tm = _pair(pos_enc="rope", n_kv_heads=2)
    batches = [_batch(8, seed=10), _batch(8, seed=11)]
    jl, jp = _jax_steps(jm, params, batches, lr, wd)
    tl, state = _torch_steps(tm, batches, lr, wd)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = _flat(params_to_flax(state.params, BASE["n_heads"], 2))
    for leaf in jp:
        np.testing.assert_allclose(got[leaf], jp[leaf], err_msg=leaf,
                                   **GRAD_TOL)


def test_accum_steps_two_equals_one():
    batches = [_batch(8, seed=20), _batch(8, seed=21)]
    runs = []
    for accum in (1, 2):
        tm = TransformerLM(**BASE, dtype=torch.float32, device="cpu", seed=2)
        losses, state = _torch_steps(tm, batches, 1e-3, 0.01, accum=accum)
        runs.append((losses, {n: p.detach().clone()
                              for n, p in state.model.named_parameters()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for n in runs[0][1]:
        torch.testing.assert_close(runs[1][1][n], runs[0][1][n], msg=n,
                                   **GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible by accum_steps"):
        tm = TransformerLM(**BASE, dtype=torch.float32, device="cpu")
        _torch_steps(tm, [_batch(8)], 1e-3, 0.01, accum=3)


def test_unported_optimizer_options_raise():
    """The options of ROADMAP item 6 are ported (double buffering, int8
    error feedback, the EMA, augmentation; ``tests/
    test_torch_optimizer_options.py`` holds them against the JAX package)
    and build, and so do item 11's update rules (LARS, LAMB, Adafactor and
    the scheduled SGD/AdamW; ``tests/test_torch_large_batch.py``): the
    optax-arithmetic rules are capturable on any device, and torch's
    AdamW, capturable on a CUDA device only, keeps a schedule's learning
    rate as a tensor; item 8's ``grad_reduce`` takes a function of the
    model; item 12's health check still raises, naming its item."""
    comm = create_communicator("xla", device="cpu")
    for kw in (dict(double_buffering=True), dict(grad_compression="int8_ef"),
               dict(ema_decay=0.99)):
        create_multi_node_optimizer(adamw(1e-3), comm, **kw)
    sched = warmup_cosine_schedule(1e-3, 2, 10)
    for tx in (lars(1e-3), lamb(sched), adafactor(sched), adamw(sched),
               sgd(sched, 0.9)):
        model = TransformerLM(**BASE, dtype=torch.float32, device="cpu")
        opt = create_multi_node_optimizer(tx, comm)
        state = opt.init(model)
        if isinstance(state.optimizer, torch.optim.AdamW):
            assert torch.is_tensor(state.optimizer.param_groups[0]["lr"])
        else:
            assert state.optimizer.defaults["capturable"]
    # Since item 8 the grad_reduce seam takes a function of the model,
    # which the step calls in place of the communicator's mean.
    seen = []
    opt = create_multi_node_optimizer(adamw(1e-3), comm,
                                      grad_reduce=seen.append)
    model = TransformerLM(**BASE, dtype=torch.float32, device="cpu")
    step = opt.make_train_step(lambda m, b: m.embed.weight.sum())
    step(opt.init(model), np.zeros((2, 4), np.int32))
    assert seen == [model]
    with pytest.raises(TypeError, match="grad_reduce"):
        create_multi_node_optimizer(adamw(1e-3), comm, grad_reduce=1)
    with pytest.raises(ValueError, match="grad_compression"):
        create_multi_node_optimizer(adamw(1e-3), comm, grad_compression="fp8")
    opt = create_multi_node_optimizer(adamw(1e-3), comm)
    opt.make_train_step(lambda m, b: 0.0, augment=lambda g, b: b)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        opt.make_train_step(lambda m, b: 0.0, health_check=True)


def test_train_lm_twin_runs_on_cpu(capsys):
    from chainermn_tpu_torch.examples import train_lm

    loss = train_lm.main(["--device", "cpu", "--steps", "3", "--seq-len",
                          "32", "--batch-per-chip", "4", "--d-model", "32",
                          "--pack", "--rope", "--kv-heads", "2", "--remat"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 2"]
    assert all(np.isfinite(float(ln.split()[-1])) for ln in lines)
    assert np.isfinite(loss)
    # --eval (ROADMAP item 6) is ported: the held-out perplexity.
    train_lm.main(["--device", "cpu", "--steps", "1", "--seq-len", "32",
                   "--batch-per-chip", "4", "--d-model", "32", "--eval"])
    ppl = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("val_ppl ")]
    assert len(ppl) == 1 and np.isfinite(float(ppl[0].split()[1]))
    # --lora (item 9), --optimizer adafactor and --warmup (item 11) are
    # ported and run (tests/test_torch_lora.py and
    # tests/test_torch_large_batch.py hold them against the JAX package);
    # --zero still raises, naming its item.
    assert np.isfinite(train_lm.main([
        "--device", "cpu", "--steps", "2", "--seq-len", "32",
        "--batch-per-chip", "4", "--d-model", "32", "--lora", "2",
        "--optimizer", "adafactor", "--warmup", "5"]))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        train_lm.main(["--device", "cpu", "--zero"])
