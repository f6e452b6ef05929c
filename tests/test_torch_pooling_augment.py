"""The port's fused max-pool and its augmentation against the JAX
package's (``chainermn_tpu/ops/pooling.py``, ``ops/augment.py``).

``max_pool_fused``: forward equal to the JAX function and to
``nn.max_pool`` exactly (a max reads its inputs), backward within 1e-6
(fp32 sums of the same placements in the same order), on the ResNet stem's
configuration at a small size and the JAX tests' odd shapes; the
constructed tie of ``tests/ops_tests/test_pooling.py`` (a constant input,
where every window position ties: the first maximum in row-major window
order takes the whole cotangent) exactly; NaNs propagate; a window of more
than 256 offsets keeps an int32 residual.

Augmentation: PyTorch cannot draw JAX's PRNG streams, so the draw and the
apply are held apart.  Given the offsets and flags the JAX functions draw
for a key (the same ``jax.random`` calls they make), the port's ``crop``
and ``flip`` equal ``random_crop`` / ``random_flip`` / ``random_crop_flip``
exactly, for every padding mode.  The port's draw is checked for its
range and its determinism in ``(seed, step, rank)``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from chainermn_tpu.ops import max_pool_fused as jax_pool
from chainermn_tpu.ops import augment as jax_aug
from chainermn_tpu_torch.ops import augment, max_pool_fused
from chainermn_tpu_torch.optimizers import augment_generator

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

CONFIGS = [
    # (H, W, window, strides, padding): the ResNet stem's first.
    (28, 28, (3, 3), (2, 2), "SAME"),
    (17, 23, (3, 3), (2, 2), "SAME"),
    (16, 16, (2, 2), (2, 2), "VALID"),
    (15, 11, (3, 2), (1, 2), "SAME"),
    (9, 9, (3, 3), (3, 3), "VALID"),
]


def _port(x, window, strides, padding, ct):
    t = torch.from_numpy(x).requires_grad_(True)
    y = max_pool_fused(t, window, strides, padding)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), t.grad.numpy()


def _jax(fn, x, window, strides, padding, ct):
    def f(x):
        return jnp.sum(fn(x, window, strides, padding) * ct)

    return (np.asarray(fn(jnp.asarray(x), window, strides, padding)),
            np.asarray(jax.grad(f)(jnp.asarray(x))))


@pytest.mark.parametrize("H,W,window,strides,padding", CONFIGS)
def test_max_pool_matches_jax(H, W, window, strides, padding):
    rng = np.random.RandomState(0)
    x = rng.randn(2, H, W, 5).astype(np.float32)
    y_ref = np.asarray(nn.max_pool(jnp.asarray(x), window, strides=strides,
                                   padding=padding))
    ct = rng.randn(*y_ref.shape).astype(np.float32)
    y, g = _port(x, window, strides, padding, ct)
    y_jax, g_jax = _jax(jax_pool, x, window, strides, padding, ct)
    np.testing.assert_array_equal(y, y_jax)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(g, g_jax, rtol=1e-6, atol=1e-6)


def test_max_pool_tie_first_max_wins():
    x = np.ones((1, 6, 6, 1), np.float32)
    ct = np.random.RandomState(2).randn(1, 3, 3, 1).astype(np.float32)
    y, g = _port(x, (3, 3), (2, 2), "SAME", ct)
    y_jax, g_jax = _jax(jax_pool, x, (3, 3), (2, 2), "SAME", ct)
    _, g_xla = _jax(lambda x, w, s, p: nn.max_pool(x, w, strides=s,
                                                    padding=p),
                    x, (3, 3), (2, 2), "SAME", ct)
    np.testing.assert_array_equal(y, y_jax)
    np.testing.assert_array_equal(g, g_jax)
    np.testing.assert_array_equal(g, g_xla)


def test_max_pool_nan_propagates_and_wide_window_residual():
    x = np.random.RandomState(4).randn(1, 8, 8, 2).astype(np.float32)
    x[0, 3, 3, 1] = np.nan
    y = max_pool_fused(torch.from_numpy(x), (3, 3), (2, 2), "SAME").numpy()
    y_jax = np.asarray(jax_pool(jnp.asarray(x), (3, 3), (2, 2), "SAME"))
    np.testing.assert_array_equal(np.isnan(y), np.isnan(y_jax))
    assert np.isnan(y).any()
    # 17 x 17 = 289 window offsets: past a uint8's range, so the residual
    # is int32.  Held against nn.max_pool's forward and F.max_pool2d's
    # backward (no ties in random data; the JAX function unrolls 289
    # slices, too slow to trace here).
    x = np.random.RandomState(5).randn(1, 20, 20, 1).astype(np.float32)
    ct = np.random.RandomState(6).randn(1, 4, 4, 1).astype(np.float32)
    y, g = _port(x, (17, 17), (1, 1), "VALID", ct)
    np.testing.assert_array_equal(y, np.asarray(nn.max_pool(
        jnp.asarray(x), (17, 17), strides=(1, 1), padding="VALID")))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (torch.nn.functional.max_pool2d(t, 17, 1).permute(0, 2, 3, 1)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(g, t.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    from chainermn_tpu_torch.ops.pooling import _fwd_argmax

    _, arg = _fwd_argmax(torch.from_numpy(x), (17, 17), (1, 1),
                         ((0, 0), (0, 0)))
    assert arg.dtype == torch.int32 and int(arg.max()) > 255


def test_bf16_forward_and_grad_dtype():
    x = torch.randn(2, 14, 14, 8, generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16).requires_grad_(True)
    y = max_pool_fused(x, (3, 3), (2, 2), "SAME")
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
    want = np.asarray(jax_pool(jnp.asarray(x.detach().float().numpy(),
                                           jnp.bfloat16), (3, 3), (2, 2),
                               "SAME").astype(jnp.float32))
    np.testing.assert_array_equal(y.detach().float().numpy(), want)


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
def test_crop_and_flip_equal_jax_given_its_draws(mode):
    rng = np.random.RandomState(7)
    x = rng.randn(6, 10, 12, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    pad = 3
    # The draws the JAX functions make for this key.
    offs = np.array(jax.random.randint(key, (6, 2), 0, 2 * pad + 1))
    flags = np.array(jax.random.bernoulli(key, 0.5, (6,)))
    want_crop = np.asarray(jax_aug.random_crop(key, jnp.asarray(x), pad,
                                               mode=mode))
    want_flip = np.asarray(jax_aug.random_flip(key, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        augment.crop(xt, torch.from_numpy(offs), pad, mode).numpy(),
        want_crop)
    np.testing.assert_array_equal(
        augment.flip(xt, torch.from_numpy(flags)).numpy(), want_flip)
    # The composite: crop with the first split key, flip with the second.
    kc, kf = jax.random.split(key)
    offs = np.array(jax.random.randint(kc, (6, 2), 0, 2 * pad + 1))
    flags = np.array(jax.random.bernoulli(kf, 0.5, (6,)))
    labels = np.arange(6)
    want = jax_aug.random_crop_flip(pad, mode)(key, (jnp.asarray(x), labels))
    got = augment.flip(augment.crop(xt, torch.from_numpy(offs), pad, mode),
                       torch.from_numpy(flags))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]))
    assert want[1] is labels


def test_port_draws_are_deterministic_per_step_and_rank():
    x = torch.randn(16, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    aug = augment.random_crop_flip(padding=2)

    def run(seed, step, rank):
        return aug(augment_generator(seed, step, rank, "cpu"), (x, 0))[0]

    a = run(0, 5, 0)
    assert torch.equal(a, run(0, 5, 0))
    assert not torch.equal(a, run(0, 6, 0))
    assert not torch.equal(a, run(0, 5, 1))
    assert not torch.equal(a, run(1, 5, 0))
    offs = augment.draw_offsets(augment_generator(0, 0, 0, "cpu"), 4096, 2,
                                "cpu")
    assert offs.min() == 0 and offs.max() == 4
    flags = augment.draw_flags(augment_generator(0, 0, 0, "cpu"), 4096,
                               "cpu")
    assert 0.45 < flags.float().mean() < 0.55
