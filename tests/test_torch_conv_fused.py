"""The port's fused 1×1-conv + affine + ReLU (K6's plain version on the
CPU) against the JAX package's ``matmul_affine``, whose Pallas kernel runs
here in interpret mode (called directly, outside any ``shard_map``, so the
Pallas path -- not its XLA twin -- is what runs).

Tolerances: fp32 atol 1e-5 + rtol 1e-5 (float32 sums over at most 32 terms
taken in another order); bf16 inputs rtol 2^-7 + atol 1e-6 (each side
rounds its fp32 result to bf16 once, so the two may differ by one bf16
ulp of the value); gradients atol 1e-4 + rtol 1e-4 (fp32 through the
custom VJP's three products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from chainermn_tpu.ops import conv_fused as jcf
from chainermn_tpu_torch.ops import conv_fused as tcf

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

FP32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)

# N, Cin, Cout: the JAX tests' shape and ragged ones (N prime, channels not
# a multiple of any tile).
SHAPES = {"n64": (64, 32, 16), "ragged": (50, 24, 40), "k8": (37, 8, 16)}


def _data(N, K, C, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, K).astype(np.float32),
            (rng.randn(K, C) * 0.1).astype(np.float32),
            (rng.rand(C) + 0.5).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32))


def _jax(fn, arrays, *rest, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), *rest, **kw))


def test_the_jax_side_really_runs_the_pallas_kernel(monkeypatch):
    """Outside ``shard_map`` the JAX ``impl="pallas"`` path calls
    ``pallas_call`` (interpret mode on the CPU), not the XLA twin."""
    calls = []
    real = pl.pallas_call

    def spy(*a, **k):
        calls.append(k.get("interpret"))
        return real(*a, **k)

    monkeypatch.setattr(jcf.pl, "pallas_call", spy)
    x, w, s, b = _data(*SHAPES["n64"])
    _jax(jcf.matmul_affine, (x, w, s, b), True, "pallas")
    assert calls == [True]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_k6_matches_pallas_fp32(shape, relu):
    x, w, s, b = _data(*SHAPES[shape], seed=len(shape))
    want = _jax(jcf.matmul_affine, (x, w, s, b), relu, "pallas")
    got = tcf.matmul_affine_fwd(*map(torch.from_numpy, (x, w, s, b)), relu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    if relu:
        assert float(got.min()) >= 0.0


@pytest.mark.parametrize("relu", [True, False])
def test_plain_k6_matches_pallas_bf16(relu):
    x, w, s, b = _data(*SHAPES["ragged"], seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jcf.matmul_affine(xb, wb, jnp.asarray(s),
                                        jnp.asarray(b), relu, "pallas"
                                        ).astype(jnp.float32))
    got = tcf.matmul_affine_fwd(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(s), torch.from_numpy(b), relu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_strided_conv1x1_bn_relu_matches_jax(impl):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)  # odd width: ragged ::2
    _, w, s, b = _data(1, 8, 24, seed=8)
    for strides, relu in (((1, 1), True), ((2, 2), False)):
        want = _jax(jcf.conv1x1_bn_relu, (x, w, s, b), relu=relu,
                    strides=strides, impl=impl)
        # The port's callers hand it the NHWC view of a channels_last
        # tensor; a strided subsample of that view is not contiguous.
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        got = tcf.conv1x1_bn_relu(xt, *map(torch.from_numpy, (w, s, b)),
                                  relu=relu, strides=strides, impl=impl)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("relu", [True, False])
def test_gradients_match_jax_custom_vjp(impl, relu):
    x, w, s, b = _data(*SHAPES["ragged"], seed=11)
    g = np.random.RandomState(12).randn(50, 40).astype(np.float32)

    def jloss(x, w, s, b):
        return jnp.sum(jcf.matmul_affine(x, w, s, b, relu, impl) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, s, b)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, s, b)]
    (tcf.matmul_affine(*ts, relu, impl) * torch.from_numpy(g)).sum() \
        .backward()
    for name, t, j in zip(("dx", "dw", "dscale", "dbias"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=name, **GRAD)


def test_launch_counter_counts_only_kernel_launches():
    """On the CPU the wrapper runs the plain version: no launch."""
    x, w, s, b = map(torch.from_numpy, _data(*SHAPES["n64"]))
    before = tcf.matmul_affine_fwd.launches
    tcf.matmul_affine_fwd(x, w, s, b)
    tcf.matmul_affine(x, w, s, b, True, "xla")
    assert tcf.matmul_affine_fwd.launches == before


def test_wrapper_checks():
    x, w, s, b = map(torch.from_numpy, _data(*SHAPES["n64"]))
    with pytest.raises(ValueError, match="x2d"):
        tcf.matmul_affine_fwd(x, w[:8], s, b)
    with pytest.raises(ValueError, match="scale"):
        tcf.matmul_affine_fwd(x, w, s[:3], b)
    with pytest.raises(ValueError, match="unsupported device"):
        tcf.matmul_affine_fwd(x.to("meta"), w.to("meta"), s.to("meta"),
                              b.to("meta"))
    with pytest.raises(ValueError, match="on the CPU"):
        tcf.matmul_affine_fwd(x, w.to("meta"), s, b)
    with pytest.raises(ValueError, match="impl"):
        tcf.matmul_affine(x, w, s, b, True, "triton")
