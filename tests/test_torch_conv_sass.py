"""The CPU side of the fused 1x1-conv kernel (K6): the SASS census and ptxas
serialization report behind ``chip_smoke.py``'s ``conv_sass`` line (K6 on
wgmma and TMA), and the wrapper's decision which bf16 operands go to the
TMA-fed kernel as they are and which as aligned, zero-padded copies."""

import pytest
import torch

import chip_smoke
from chainermn_tpu_torch.ops import _kernels
from chainermn_tpu_torch.ops import conv_fused as tcf

K6 = {bn: ("_ZN42_GLOBAL__N__1b2c3d4e_13_conv_fused_cu_5a6b7c8d18"
           f"matmul_affine_bf16ILi{bn}EEEv14CUtensorMap_stS1_S1_NS_6ParamsE")
      for bn in (64, 128)}
F32 = ("_ZN42_GLOBAL__N__1b2c3d4e_13_conv_fused_cu_5a6b7c8d17"
       "matmul_affine_f32ENS_6ParamsE")

WGMMA = """
        /*0000*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0010*/              @!P0 UTMALDG.2D [UR16], [UR4] ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0030*/                   UTMASTG.2D [UR4], [UR8] ;
"""
MMA = """
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""
# wgmma fed without TMA (cp.async), and wgmma beside a leftover mma.sync.
NO_TMA = """
        /*0000*/                   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64] ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
"""
MIXED = WGMMA + MMA


def _listing(bodies):
    """A ``cuobjdump -sass`` listing of the conv library: each bf16
    instance with the body given for its column tile, then the fp32
    kernel."""
    return "".join(f"\t\tFunction : {K6[bn]}{bodies[bn]}" for bn in K6) + \
        f"\t\tFunction : {F32}\n        /*0000*/ FFMA R4, R2, R3, R4 ;\n"


def _log(serialized=()):
    out = ""
    for bn, name in K6.items():
        out += f"ptxas info    : Compiling entry function '{name}'\n"
        if bn in serialized:
            out += ("ptxas info    : (C7518) Potential Performance Loss: "
                    "wgmma.mma_async instructions are serialized due to "
                    "program dependence on compiler-inserted WG.DP in "
                    f"divergent path in the function '{name}'\n")
        out += "ptxas info    : Used 168 registers, used 1 barriers\n"
    return out


def test_conv_sass_rows_name_the_bf16_kernel_by_column_tile():
    rows = chip_smoke.conv_sass_rows(_kernels.sass_counts(
        _listing({64: WGMMA, 128: MMA})))
    assert rows == {
        "matmul_affine_bf16<64>": {"HGMMA": 1, "HMMA": 0, "UTMALDG": 2,
                                   "UBLKCP": 0, "LDGSTS": 0},
        "matmul_affine_bf16<128>": {"HGMMA": 0, "HMMA": 1, "UTMALDG": 0,
                                    "UBLKCP": 0, "LDGSTS": 0}}


class _Kernels:
    """``_kernels`` as ``phase_conv_sass`` sees it, over a canned listing
    and build log."""

    sass_counts = staticmethod(_kernels.sass_counts)
    serialized_wgmma = staticmethod(_kernels.serialized_wgmma)

    def __init__(self, listing, log):
        self.listing, self.log = listing, log

    def sass(self, name):
        assert name == "conv_fused"
        return self.listing

    def build_log(self, name):
        assert name == "conv_fused"
        return self.log


@pytest.mark.parametrize("bodies,log,passes", [
    ({64: WGMMA, 128: WGMMA}, _log(), True),
    ({64: WGMMA, 128: WGMMA}, _log(serialized=(128,)), False),
    ({64: WGMMA, 128: WGMMA}, None, False),
    ({64: WGMMA, 128: MMA}, _log(), False),
    ({64: WGMMA}, _log(), False),
    ({64: NO_TMA, 128: WGMMA}, _log(), False),
    ({64: WGMMA, 128: MIXED}, _log(), False),
], ids=["clean", "serialized", "no_log", "on_mma_sync", "missing_tile",
        "wgmma_without_tma", "wgmma_beside_mma_sync"])
def test_conv_sass_fails_unless_every_instance_is_wgmma_and_tma(bodies, log,
                                                               passes):
    listing = "".join(f"\t\tFunction : {K6[bn]}{b}"
                      for bn, b in bodies.items())
    if passes:
        chip_smoke.phase_conv_sass(_Kernels(listing, log))
    else:
        with pytest.raises(AssertionError):
            chip_smoke.phase_conv_sass(_Kernels(listing, log))


def test_conv_source_keys_on_the_hopper_header():
    names = [p.name for p in _kernels.sources_of("conv_fused")]
    assert names == ["conv_fused.cu", "hopper.cuh"]


def _operands(N, K, C, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(N + K + C)
    return (torch.randn((N, K), generator=g).to(dtype),
            torch.randn((K, C), generator=g).to(dtype),
            torch.rand((C,), generator=g) + 0.5,
            torch.randn((C,), generator=g))


@pytest.mark.parametrize("shape", sorted(chip_smoke.k6_shapes()),
                         ids=lambda s: "x".join(map(str, s)))
def test_main_path_operands_pass_as_they_are(shape):
    """Every (Cin, Cout) of the ResNet-50 step goes to the kernel with no
    copy (the row count plays no part in the decision, so it is cut to
    16)."""
    _, K, C = shape
    ops = _operands(16, K, C)
    got = tcf._tma_operands(*ops)
    assert [t.data_ptr() for t in got[:4]] == [t.data_ptr() for t in ops]
    assert got[4] == C


def test_the_nhwc_view_of_a_channels_last_activation_passes():
    """``conv1x1_bn_relu``'s ``x.reshape(B*H*W, Cin)`` of a channels-last
    activation is a view, and the kernel takes it as it is."""
    x = torch.randn((2, 64, 7, 9)).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    x2d = x.reshape(-1, 64)
    assert x2d.data_ptr() == x.data_ptr()
    _, w, s, b = _operands(1, 64, 128)
    assert tcf._tma_operands(x2d, w, s, b)[0].data_ptr() == x2d.data_ptr()


def test_a_wide_row_stride_that_tma_takes_passes():
    """A column slice of a wider matrix, its row stride a multiple of 8,
    is read in place."""
    wide = torch.zeros((300, 64), dtype=torch.bfloat16)
    _, w, s, b = _operands(1, 48, 40)
    got = tcf._tma_operands(wide[:, :48], w, s, b)
    assert got[0].data_ptr() == wide.data_ptr() and got[0].stride() == (64, 1)
    assert got[4] == 40


def test_unaligned_x_is_copied_into_padded_rows():
    """Cin 20 (40-byte rows), an odd row stride, a base 2 bytes off, and a
    transposed view: each becomes rows of a multiple of 8 columns, zeros
    past Cin, with x's values."""
    _, w, s, b = _operands(1, 20, 16)
    base = torch.randn((64, 20)).to(torch.bfloat16)
    odd = torch.zeros((64, 27), dtype=torch.bfloat16)[:, :20]
    odd.copy_(base)
    flat = torch.zeros(64 * 20 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(64, 20)
    shifted.copy_(base)
    for x in (base, odd, shifted, base.t().contiguous().t()):
        got = tcf._tma_operands(x, w, s, b)[0]
        assert got.data_ptr() != x.data_ptr()
        assert got.data_ptr() % 16 == 0 and got.stride() == (24, 1)
        assert got.shape == (64, 20) and torch.equal(got, base)
        assert bool((got.as_strided((64, 24), (24, 1))[:, 20:] == 0).all())


def test_cout_off_a_multiple_of_eight_pads_w_scale_and_bias():
    x, w, s, b = _operands(32, 24, 13)
    gx, gw, gs, gb, width = tcf._tma_operands(x, w, s, b)
    assert gx.data_ptr() == x.data_ptr()  # Cin 24: 48-byte rows pass
    assert width == 16
    assert gw.shape == (24, 16) and torch.equal(gw[:, :13], w)
    assert bool((gw[:, 13:] == 0).all())
    for got, want in ((gs, s), (gb, b)):
        assert got.shape == (16,) and torch.equal(got[:13], want)
        assert bool((got[13:] == 0).all())


def test_unaligned_scale_is_copied_alone():
    x, w, s, b = _operands(32, 64, 64)
    shifted = torch.zeros(65)[1:]
    shifted.copy_(s)
    gx, gw, gs, gb, width = tcf._tma_operands(x, w, shifted, b)
    assert (gx.data_ptr(), gw.data_ptr(), gb.data_ptr()) == (
        x.data_ptr(), w.data_ptr(), b.data_ptr())
    assert gs.data_ptr() % 16 == 0 and torch.equal(gs, s) and width == 64
