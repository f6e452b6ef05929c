"""The port's 5-way-parallel ``ParallelLM`` against the JAX package's
(``tests/models_tests/test_parallel_transformer.py``) and its dryrun twin
against ``__graft_entry__.dryrun_multichip``.

One job of eight gloo ranks (``torch_rank_bodies.plm``) on a ``data 1 x
stage 2 x model 2 x seq 2`` grid runs the JAX test's configuration
(vocab 64, 2 stages, d_model 16, 4 heads, d_ff 32, 2 experts, top-2,
ample capacity, 2 microbatches, batch 4 x 16 tokens, ``RandomState(0)``)
with learned and RoPE positions, dense and GQA (2 kv heads) heads: each
rank's logits, the global loss and the reduced gradients of step 0
(gathered back with ``parallel_lm_unshard``), then three SGD steps at lr
0.5; the flash ring forward (the kernels' plain versions on the CPU);
then ``examples/dryrun_multichip.py``'s ``main``.  The JAX side: its
``ParallelLM`` on eight forced CPU devices (``check_vma=False``) for the
loss and the reduced gradients, ``dense_lm_reference`` for the logits and
for three optax SGD steps (the JAX test holds its program to that
oracle).  Tolerances: the JAX test's (logits atol 5e-5 + rtol 1e-3, loss
atol 1e-5 + rtol 1e-4, gradients atol 5e-4 + rtol 5e-3); the step losses
and the parameters after three steps atol 1e-5 + rtol 1e-4 and atol 1e-4
+ rtol 1e-3 (float32, three updates of lr 0.5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import chainermn_tpu as cmn
from chainermn_tpu.models.transformer import ParallelLM as JaxLM
from chainermn_tpu.models.transformer import ParallelLMConfig as JaxConfig
from chainermn_tpu.models.transformer import (
    dense_lm_reference,
    init_parallel_lm,
    parallel_lm_specs,
)

from chainermn_tpu_torch.models import ParallelLM, ParallelLMConfig
from chainermn_tpu_torch.models import init_parallel_lm as t_init
from chainermn_tpu_torch.models import parallel_lm_specs as t_specs
from chainermn_tpu_torch.utils import parallel_lm_unshard

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_rank_bodies import PLM, PLM_CASES, PLM_GRID, PLM_LR, plm_batch
from torch_ranks import run_ranks

pytestmark = pytest.mark.tier1

N = 8
TRAINED = [c for c in PLM_CASES if c != "flash"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("plm", tmp_path_factory.mktemp("plm"), N,
                     timeout_s=240.0)


@pytest.fixture(scope="module")
def mesh():
    return cmn.hybrid_mesh(PLM_GRID, devices=jax.devices()[:N])


def _cfg(case, cls=JaxConfig):
    return cls(**PLM)._replace(**PLM_CASES[case])


def _glue(ranks, case, key="logits"):
    """The global ``(B, T, ...)`` array from the ranks' blocks (every
    stage and model rank holds the same block)."""
    blocks = {}
    for r in ranks:
        c = r[case]["coords"]
        blocks[c["seq"]] = r[case][key]
    return np.concatenate([blocks[q] for q in sorted(blocks)], axis=1)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dense_loss(cfg):
    def loss(params, tokens, targets):
        logits = dense_lm_reference(params, cfg, tokens)
        mask = (targets >= 0).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, jnp.maximum(targets, 0)[..., None],
                                  axis=-1)[..., 0]
        return jnp.sum(ce * mask) / jnp.sum(mask)
    return loss


def test_init_is_the_jax_init_bit_for_bit():
    for case in PLM_CASES:
        want = _flat(init_parallel_lm(np.random.RandomState(0), _cfg(case)))
        got = _flat(t_init(np.random.RandomState(0),
                           _cfg(case, ParallelLMConfig)))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        specs = jax.tree_util.tree_map(
            tuple, parallel_lm_specs(_cfg(case)),
            is_leaf=lambda s: isinstance(s, P))
        assert t_specs(_cfg(case, ParallelLMConfig)) == specs


@pytest.mark.parametrize("case", list(PLM_CASES))
def test_parallel_forward_matches_dense(ranks, case):
    cfg = _cfg(case)
    params, tokens, _ = plm_batch(_cfg(case, ParallelLMConfig))
    ref = np.asarray(dense_lm_reference(params, cfg, tokens))
    np.testing.assert_allclose(_glue(ranks, case), ref, atol=5e-5,
                               rtol=1e-3)


@pytest.mark.parametrize("case", TRAINED)
def test_parallel_loss_and_grads_match_jax(ranks, mesh, case):
    """The global loss and every leaf's reduced gradient equal the JAX
    program's (``grad_reduce`` over its vma-free specs) and the dense
    oracle's."""
    cfg = _cfg(case)
    params, tokens, targets = plm_batch(_cfg(case, ParallelLMConfig))
    comm = cmn.XlaCommunicator(mesh)
    lm = JaxLM(cfg, comm.sub("stage"), n_microbatches=2)
    specs = parallel_lm_specs(cfg)

    def step(ps, batch):
        loss, grads = jax.value_and_grad(lm.loss)(ps, batch)
        return (jax.lax.psum(loss, ("data", "stage", "model", "seq")),
                lm.grad_reduce(grads))

    f = jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(specs, (P("data", "seq"),) * 2),
        out_specs=(P(), specs), check_vma=False))
    jloss, jgrads = f(params, (tokens, targets))
    dloss, dgrads = jax.value_and_grad(_dense_loss(cfg))(
        jax.tree_util.tree_map(jnp.asarray, params), tokens, targets)
    got = parallel_lm_unshard(
        [(r[case]["coords"], _unflatten(r[case]["grads"])) for r in ranks],
        _cfg(case, ParallelLMConfig))
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"][0], float(jloss),
                                   atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(jloss), float(dloss), atol=1e-5,
                               rtol=1e-4)
    got, want, dense = _flat(got), _flat(jgrads), _flat(dgrads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, rtol=5e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], dense[k], atol=5e-4, rtol=5e-3,
                                   err_msg=k)


def _unflatten(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("case", ["learned", "rope"])
def test_parallel_train_steps_match_dense(ranks, case):
    """Three SGD steps (lr 0.5, the JAX test's): the loss falls and is the
    same on every rank, the losses and the parameters after the steps are
    the dense oracle's, and the replicated leaves agree across ranks."""
    cfg = _cfg(case)
    params, tokens, targets = plm_batch(_cfg(case, ParallelLMConfig))
    tx = optax.sgd(PLM_LR)
    ps = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(ps)
    vg = jax.jit(jax.value_and_grad(_dense_loss(cfg)))
    losses = []
    for _ in range(3):
        value, g = vg(ps, tokens, targets)
        losses.append(float(value))
        upd, state = tx.update(g, state, ps)
        ps = optax.apply_updates(ps, upd)
    got = [r[case]["losses"] for r in ranks]
    assert got[0][-1] < got[0][0], got[0]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], losses, atol=1e-5, rtol=1e-4)
    after = _flat(parallel_lm_unshard(
        [(r[case]["coords"], _unflatten(r[case]["after"])) for r in ranks],
        _cfg(case, ParallelLMConfig)))
    for k, v in _flat(ps).items():
        np.testing.assert_allclose(after[k], v, atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    for leaf in ("embed", "lm_head"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[case]["after"][leaf],
                                          ranks[0][case]["after"][leaf])


def test_parallel_gqa_param_layout_and_validation(mesh):
    """GQA swaps ``wqkv`` for ``wq``/``wkv``; bad kv head counts and
    positional schemes fail at construction with the JAX messages."""
    tree = t_init(np.random.RandomState(0),
                  _cfg("learned-gqa", ParallelLMConfig))
    assert "wkv" in tree["stages"] and "wqkv" not in tree["stages"]
    comm = cmn.XlaCommunicator(mesh)
    bad = [{"n_kv_heads": n} for n in (3, -2, 8)] + [{"pos_enc": "alibi"}]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JaxLM(JaxConfig(**PLM)._replace(**kw), comm.sub("stage"), 2)
        with pytest.raises(ValueError) as got:
            ParallelLM(ParallelLMConfig(**PLM)._replace(**kw), None, 2)
        assert str(got.value) == str(want.value)


def test_dryrun_twin_matches_the_jax_entry(ranks):
    """The twin factors 8 ranks as the JAX entry factors 8 devices, and
    its step-0 global loss is the dense oracle's for the entry's tiny
    configuration and batch."""
    from chainermn_tpu_torch.examples.dryrun_multichip import grid_shape

    for n, want in ((8, (1, 2, 2, 2)), (16, (2, 2, 2, 2)),
                    (32, (2, 2, 4, 2))):
        assert tuple(grid_shape(n).values()) == want
    cfg = JaxConfig(vocab=32, n_stages=2, d_model=16, n_heads=4, d_ff=32,
                    max_len=16, n_experts=2, moe_k=1)
    rng = np.random.RandomState(0)
    params = init_parallel_lm(rng, cfg)
    tokens = rng.randint(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    want = float(_dense_loss(cfg)(params, tokens, targets))
    for r in ranks:
        d = r["dryrun"]
        assert d["grid"] == {"data": 1, "stage": 2, "model": 2, "seq": 2}
        np.testing.assert_allclose(d["loss"], want, atol=1e-5, rtol=1e-4)
        assert d["rope_logits_shape"] == (2, 8, 32)
