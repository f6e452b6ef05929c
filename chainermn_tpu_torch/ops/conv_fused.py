"""Fused 1×1-conv + per-channel affine (+ ReLU): the frozen-BN ResNet arm's
1×1 convolutions.

The counterpart of ``chainermn_tpu/ops/conv_fused.py``.  A 1×1 conv over an
NHWC activation is a ``(B·H·W, Cin) @ (Cin, Cout)`` product, so the chain
conv → frozen BN → ReLU is one pass with an epilogue: fp32 accumulation,
``acc * scale + bias``, optional ReLU, one rounding to the compute dtype.

* :func:`matmul_affine_fwd` (K6) -- the forward, written by hand for Hopper
  in CUDA C++ (``chainermn_tpu_torch/csrc/conv_fused.cu``; its header says
  what bounds it and how the design answers that).  CPU tensors run the
  plain version; CUDA tensors launch the kernel or raise.  Launches are
  counted in ``matmul_affine_fwd.launches``, launches recorded into a CUDA
  graph under capture in ``.captured``.  The bf16 kernel reads and
  writes through TMA; :func:`_tma_operands` decides which inputs it takes
  as they are and which it gets as aligned copies.
* :func:`matmul_affine_reference` -- the plain version, the JAX package's
  XLA twin (``_matmul_affine_fwd_xla``): an fp32 product of the inputs'
  values, the affine, the ReLU, one cast.
* :class:`MatmulAffineFunction` -- the custom VJP shared by both (``_ma_bwd``):
  plain ``torch.matmul`` products, as the JAX package leaves them to XLA.

``matmul_affine(..., impl="pallas")`` runs K6, ``impl="xla"`` the plain twin
(an explicit choice, like ``attention="xla"``), with the same backward, so
an A/B between them isolates the forward.
"""

from __future__ import annotations

import ctypes

import torch

from chainermn_tpu_torch.ops import _kernels

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib_cache = {}


def _lib():
    lib = _lib_cache.get("lib")
    if lib is None:
        lib = _kernels.load("conv_fused")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cmn_matmul_affine.argtypes = (
            [ptr] * 5 + [i64, i32, i32, i64, i32, i32, ptr])
        lib.cmn_matmul_affine.restype = i32
        lib.cmn_conv_fused_error_string.argtypes = [i32]
        lib.cmn_conv_fused_error_string.restype = ctypes.c_char_p
        _lib_cache["lib"] = lib
    return lib


def _check_shapes(x2d, w, scale, bias):
    if x2d.dim() != 2 or w.dim() != 2 or x2d.shape[1] != w.shape[0]:
        raise ValueError(f"x2d (N, Cin) and w (Cin, Cout) expected, got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    C = w.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be ({C},), got {tuple(t.shape)}")


# ---------------------------------------------------------------- plain
def matmul_affine_reference(x2d, w, scale, bias, relu: bool = True):
    """Plain version of K6: ``relu?((x2d @ w) * scale + bias)`` with the
    product taken in fp32 from the inputs' values, cast once to ``x2d``'s
    dtype."""
    acc = torch.matmul(x2d.float(), w.float())
    y = acc * scale.float()[None] + bias.float()[None]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype)


# ------------------------------------------------------ kernel operands
def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _tma_operands(x2d, w, scale, bias):
    """The bf16 kernel's operands and its output's width.

    The kernel reads ``x2d`` and ``w`` and writes its output through TMA
    tensor maps, which take a base and row strides that are multiples of 16
    bytes (8 bf16), and reads ``scale`` and ``bias`` in pairs from 16-byte
    aligned bases.  What meets that passes as it is -- every main-path
    shape, whose Cin and Cout are multiples of 64.  Otherwise: ``x2d`` is
    copied into zero-padded rows of a multiple of 8 columns (its Cin
    columns are read, the padding is not); where Cout is not a multiple of
    8, ``w``, ``scale`` and ``bias`` are zero-padded to the next one and
    the output is that wide (the caller keeps its first Cout columns).
    Returns ``(x2d, w, scale, bias, width)``."""
    N, K = x2d.shape
    C = w.shape[1]
    if (x2d.stride(1) != 1 or x2d.stride(0) < K or x2d.stride(0) % 8
            or not _aligned(x2d)):
        xp = x2d.new_zeros((N, _round8(K)))
        xp[:, :K] = x2d
        x2d = xp[:, :K]
    width = _round8(C)
    if width != C or w.stride() != (C, 1) or not _aligned(w):
        wp = w.new_zeros((K, width))
        wp[:, :C] = w
        w = wp
    vecs = []
    for v in (scale, bias):
        if width != C or v.stride(0) != 1 or not _aligned(v):
            vp = v.new_zeros((width,))
            vp[:C] = v
            v = vp
        vecs.append(v)
    return (x2d, w, *vecs, width)


# -------------------------------------------------------------- wrapper
def matmul_affine_fwd(x2d, w, scale, bias, relu: bool = True):
    """K6: ``relu?((x2d @ w) * scale + bias)``, ``x2d`` (N, Cin) and ``w``
    (Cin, Cout) in one dtype (bf16 or fp32), ``scale``/``bias`` (Cout,)
    fp32; returns (N, Cout) in the inputs' dtype.  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    _kernels.refuse_export("matmul_affine_fwd")
    _check_shapes(x2d, w, scale, bias)
    if x2d.device.type == "cpu":
        for name, t in (("w", w), ("scale", scale), ("bias", bias)):
            if t.device.type != "cpu":
                raise ValueError(f"x2d is on the CPU but {name} is on "
                                 f"{t.device}")
        return matmul_affine_reference(x2d, w, scale, bias, relu)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    dev = x2d.device
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x2d on {dev}: all "
                             "inputs must be on one device")
    if x2d.dtype not in _CODES:
        raise TypeError(f"x2d dtype {x2d.dtype} not supported by the CUDA "
                        f"kernel (one of {list(_CODES)})")
    if w.dtype != x2d.dtype:
        raise TypeError(f"w dtype {w.dtype} differs from x2d's {x2d.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    N, K = x2d.shape
    C = w.shape[1]
    if x2d.dtype == torch.bfloat16:
        if K == 0:
            raise ValueError("the bf16 kernel needs Cin > 0")
        x2d, w, scale, bias, width = _tma_operands(x2d, w, scale, bias)
    else:
        # The fp32 kernel reads x2d through its row stride; anything else
        # is copied into the layout it reads.
        if x2d.stride(1) != 1 or x2d.stride(0) < K:
            x2d = x2d.contiguous()
        w, scale, bias = w.contiguous(), scale.contiguous(), \
            bias.contiguous()
        width = C
    out = torch.empty((N, width), dtype=x2d.dtype, device=dev)
    rc = _lib().cmn_matmul_affine(
        x2d.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), N, K, width, x2d.stride(0), int(bool(relu)),
        _CODES[x2d.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        msg = _lib().cmn_conv_fused_error_string(rc).decode()
        raise RuntimeError(f"matmul_affine kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    if torch.cuda.is_current_stream_capturing():
        matmul_affine_fwd.captured += 1
    else:
        matmul_affine_fwd.launches += 1
    return out if width == C else out[:, :C].contiguous()


matmul_affine_fwd.launches = 0
matmul_affine_fwd.captured = 0


# ------------------------------------------------------------- autograd
class MatmulAffineFunction(torch.autograd.Function):
    """The JAX package's custom VJP (``conv_fused.py:108-129``), shared by
    both forwards: the ReLU mask from the stored output, ``dacc = g *
    scale`` rounded to the input dtype, ``dx = dacc wᵀ``, ``dw = xᵀ dacc``,
    the fp32 accumulator recomputed for ``dscale`` rather than saved, and
    ``dbias = Σ g``."""

    @staticmethod
    def forward(ctx, x2d, w, scale, bias, relu, impl):
        fwd = matmul_affine_fwd if impl == "pallas" \
            else matmul_affine_reference
        out = fwd(x2d, w, scale, bias, relu)
        ctx.save_for_backward(x2d, w, scale, out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, w, scale, out = ctx.saved_tensors
        g = g.float()
        if ctx.relu:
            g = g * (out > 0)
        dacc = (g * scale[None]).to(x2d.dtype)
        dx = torch.matmul(dacc, w.t())
        dw = torch.matmul(x2d.t(), dacc).to(w.dtype)
        acc = torch.matmul(x2d.float(), w.float())
        dscale = (g * acc).sum(dim=0)
        dbias = g.sum(dim=0)
        return dx, dw, dscale, dbias, None, None


def matmul_affine(x2d, w, scale, bias, relu: bool = True,
                  impl: str = "pallas"):
    """``relu?((x2d @ w) * scale + bias)`` with fp32 accumulation,
    differentiable in all four inputs.  ``impl``: ``"pallas"`` (K6, one
    fused pass) or ``"xla"`` (the plain twin: identical math and
    backward)."""
    if impl not in ("pallas", "xla"):
        raise ValueError(f"impl={impl!r}: expected 'pallas' or 'xla'")
    return MatmulAffineFunction.apply(x2d, w, scale, bias, bool(relu), impl)


def conv1x1_bn_relu(x, w, scale, bias, *, relu: bool = True,
                    strides=(1, 1), impl: str = "pallas"):
    """NHWC 1×1 conv + frozen-BN affine (+ ReLU) as one fused pass.

    ``x`` (B, H, W, Cin) -- any strides, e.g. the NHWC view of an NCHW
    tensor in ``torch.channels_last`` memory; ``w`` (Cin, Cout);
    ``scale``/``bias`` (Cout,).  A strided 1×1 conv reads only the kept
    pixels, so ``strides`` is a subsample before the product, materialized
    as the JAX package materializes it.  Returns (B, H', W', Cout),
    contiguous."""
    if tuple(strides) != (1, 1):
        x = x[:, ::strides[0], ::strides[1], :]
    B, H, W, Cin = x.shape
    # A free view where the pixels are rows of Cin contiguous channels (the
    # channels_last layout); a copy otherwise (the strided subsample).
    x2d = x.reshape(B * H * W, Cin)
    out = matmul_affine(x2d, w, scale, bias, relu, impl)
    return out.view(B, H, W, -1)
