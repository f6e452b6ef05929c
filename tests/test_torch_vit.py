"""The port's ViT against the JAX package, on Flax parameters carried
across by ``vit_params_from_flax``.

Geometry: patch 16 on 32 px images (4 tokens), 2 layers, d_model 32, 2
heads, d_ff 64, 5 classes, float32 on the CPU; the eager ``"xla"`` path,
and the flash path (the port's plain K1-K3 against the JAX Pallas kernels
in interpret mode) on one layer.  Tolerances: logits, loss and every
gradient leaf within 1e-5 of the JAX leaf's largest magnitude (float32
through two blocks, sums in another order), accuracy exactly; remat
against the plain model exactly (the same ops recomputed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import ViT as JaxViT
from chainermn_tpu.models import vit_loss as jax_vit_loss
from chainermn_tpu_torch.models import ViT, vit_loss
from chainermn_tpu_torch.utils import vit_params_from_flax, vit_params_to_flax

pytestmark = pytest.mark.tier1

REL = 1e-5
GEOM = dict(num_classes=5, patch=16, d_model=32, n_heads=2, d_ff=64,
            n_layers=2)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _pair(attention="xla", **over):
    kw = {**GEOM, **over}
    jm = JaxViT(**kw, dtype=jnp.float32, attention=attention)
    x = np.zeros((1, 32, 32, 3), np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x)["params"])
    tm = ViT(**kw, image_size=32, dtype=torch.float32, attention=attention,
             device="cpu")
    tm.load_state_dict(vit_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _batch(seed=0, B=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 32, 32, 3).astype(np.float32),
            rng.randint(0, 5, B).astype(np.int32))


@pytest.mark.parametrize("attention,over", [("xla", {}),
                                            ("flash", dict(n_layers=1))],
                         ids=["xla", "flash"])
def test_logits_loss_and_grads_match_jax(attention, over):
    jm, params, tm = _pair(attention, **over)
    x, y = _batch()
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jax_vit_loss(jm),
                                                has_aux=True))(params, (x, y))
    loss, aux = vit_loss(tm)(tm, (x, y))
    loss.backward()
    _close(loss.detach(), jl)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    got = _flat(vit_params_to_flax(
        {n: p.grad for n, p in tm.named_parameters()}, GEOM["n_heads"]))
    want = _flat(jg)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    with torch.no_grad():
        _close(tm(x), jax.jit(jm.apply)({"params": params}, x))


def test_bridge_round_trip_remat_and_validation():
    _, params, tm = _pair()
    back = _flat(vit_params_to_flax(dict(tm.named_parameters()),
                                    GEOM["n_heads"]))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)
    x, y = _batch(1)
    rm = ViT(**GEOM, image_size=32, dtype=torch.float32, attention="xla",
             remat=True, device="cpu")
    rm.load_state_dict(tm.state_dict())
    for m in (tm, rm):
        vit_loss(m)(m, (x, y))[0].backward()
    for (n, p), q in zip(tm.named_parameters(), rm.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=0, atol=0, msg=n)
    with pytest.raises(ValueError, match="not divisible by patch"):
        tm(np.zeros((1, 40, 40, 3), np.float32))
    with pytest.raises(ValueError, match="patches"):
        tm(np.zeros((1, 48, 48, 3), np.float32))
    with pytest.raises(ValueError, match="attention="):
        ViT(**GEOM, image_size=32, attention="fast", device="cpu")
