"""The CPU side of the port's kernel build: the SASS census and the ptxas
serialization report that show the flash kernels' design (``chip_smoke.py``'s
``flash_sass`` line: K1, K2 and K3 on wgmma and TMA), the build key that
follows a source's headers, and the stride rule under which the flash
wrappers hand tensors to the TMA-fed kernels without a copy."""

import importlib

import pytest
import torch

import chip_smoke
from chainermn_tpu_torch.ops import _kernels

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

FWD = ("_ZN51_GLOBAL__N__9ef439e9_18_flash_attention_cu_78bff2d614"
       "flash_fwd_bf16ILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE")
# dQ as the earlier design built it: mma.sync, no tensor maps.
DQ = ("_ZN51_GLOBAL__N__9ef439e9_18_flash_attention_cu_78bff2d617"
      "flash_bwd_dq_bf16ILi128EEEvNS_6ParamsE")
F32 = ("_ZN51_GLOBAL__N__9ef439e9_18_flash_attention_cu_78bff2d616"
       "flash_fwd_kernelILi32EEEvNS_6ParamsE")

# An excerpt in the shape of ``cuobjdump -sass`` output.
LISTING = f"""
\tcode for sm_90a
\t\tFunction : {FWD}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 UTMALDG.4D [UR8], [UR4] ;  /* 0x0000000804007db4 */
        /*0020*/                   UTMALDG.4D [UR16], [UR4] ; /* 0x0000001004007db4 */
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0040*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
        /*0050*/              @UP0 HGMMA.64x64x16.F32.BF16 R88, R156, gdesc[UR12], R88 ;
        /*0060*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\t..........
\t\tFunction : {DQ}
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0020*/              @!P1 HMMA.16816.F32.BF16 R8, R4, R14, R8 ;
\t\tFunction : {F32}
        /*0000*/                   FFMA R4, R2, R3, R4 ;
"""


def test_sass_counts_each_function_apart():
    counts = _kernels.sass_counts(LISTING)
    assert list(counts) == [FWD, DQ, F32]
    assert counts[FWD] == {"HGMMA": 3, "HMMA": 0, "UTMALDG": 2,
                            "UBLKCP": 0, "LDGSTS": 0}
    assert counts[DQ] == {"HGMMA": 0, "HMMA": 2, "UTMALDG": 0,
                           "UBLKCP": 0, "LDGSTS": 0}
    assert counts[F32] == {"HGMMA": 0, "HMMA": 0, "UTMALDG": 0,
                            "UBLKCP": 0, "LDGSTS": 0}


def test_flash_sass_rows_name_the_bf16_kernels_by_head_dim():
    rows = chip_smoke.flash_sass_rows(_kernels.sass_counts(LISTING))
    assert rows == {"flash_fwd_bf16<64>": {"HGMMA": 3, "HMMA": 0,
                                           "UTMALDG": 2, "UBLKCP": 0,
                                           "LDGSTS": 0},
                    "flash_bwd_dq_bf16<128>": {"HGMMA": 0, "HMMA": 2,
                                               "UTMALDG": 0, "UBLKCP": 0,
                                               "LDGSTS": 0}}


# ptxas's report, in the shape ``nvcc -Xptxas -v`` prints it, of a build in
# which the forward kernel's wgmmas were serialized.
PTXAS_LOG = f"""ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to program dependence on compiler-inserted \
WG.DP in divergent path in the function '{FWD}'
ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async \
instructions are serialized due to non wgmma instructions reading \
accumulator registers of  a wgmma between start and end of the pipeline \
stage in the function '{FWD}'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Used 232 registers, used 1 barriers
"""


def test_serialized_wgmma_names_each_warned_function_once():
    assert _kernels.serialized_wgmma(PTXAS_LOG) == [FWD]
    assert _kernels.serialized_wgmma(PTXAS_LOG.replace("C75", "C00")) == []
    rows = chip_smoke.flash_sass_rows(
        dict.fromkeys(_kernels.serialized_wgmma(PTXAS_LOG), 0))
    assert sorted(rows) == ["flash_fwd_bf16<64>"]


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    assert [p.name for p in _kernels.sources_of("k")] == ["k.cu", "a.cuh",
                                                         "b.cuh"]
    before = _kernels._target("k")
    assert _kernels._target("k") == before
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    assert _kernels._target("k") != before


def test_build_key_follows_the_watchdog_flag(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv(_kernels.WATCHDOG_ENV, raising=False)
    production = _kernels._target("k")
    assert "-DCMN_KERNEL_WATCHDOG" not in _kernels.nvcc_flags()
    monkeypatch.setenv(_kernels.WATCHDOG_ENV, "1")
    assert "-DCMN_KERNEL_WATCHDOG" in _kernels.nvcc_flags()
    assert _kernels._target("k") != production


def test_build_log_is_read_back_from_beside_the_library(tmp_path,
                                                        monkeypatch):
    """A library built by an earlier process still has its ptxas report,
    so ``flash_sass`` can check for serialized wgmmas."""
    (tmp_path / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_kernels, "build_logs", {})
    assert _kernels.build_log("k") is None
    (tmp_path / "_build").mkdir()
    _kernels._target("k").with_suffix(".log").write_text(PTXAS_LOG)
    assert _kernels.serialized_wgmma(_kernels.build_log("k")) == [FWD]
    _kernels.build_logs["k"] = "this process's build"
    assert _kernels.build_log("k") == "this process's build"


WGMMA_BODY = LISTING.split(f"Function : {FWD}")[1].split("\t\tFunction")[0]
MMA_BODY = LISTING.split(f"Function : {DQ}")[1].split("\t\tFunction")[0]


def _library_listing(on_mma=()):
    """A listing of all nine bf16 flash functions on wgmma and TMA, but
    the kernels named in ``on_mma`` on mma.sync."""
    return "".join(
        f"\t\tFunction : _ZN2ns{len(k)}{k}ILi{d}EEEvNS_6ParamsE"
        f"{MMA_BODY if k in on_mma else WGMMA_BODY}"
        for d in (32, 64, 128)
        for k in ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"))


class _Kernels:
    """``_kernels`` as ``phase_flash_sass`` sees it, over a canned listing
    and build log."""

    sass_counts = staticmethod(_kernels.sass_counts)
    serialized_wgmma = staticmethod(_kernels.serialized_wgmma)

    def __init__(self, log, listing=None):
        self.log = log
        self.listing = _library_listing() if listing is None else listing

    def sass(self, name):
        return self.listing

    def build_log(self, name):
        return self.log


CLEAN_LOG = PTXAS_LOG.replace("C75", "C00")


@pytest.mark.parametrize("log,listing,passes", [
    (CLEAN_LOG, None, True),
    (PTXAS_LOG, None, False),
    (None, None, False),
    (CLEAN_LOG, _library_listing(on_mma=("flash_bwd_dq_bf16",)), False),
    (CLEAN_LOG, _library_listing().split("\t\tFunction")[0], False),
], ids=["clean", "serialized", "no_log", "dq_on_mma_sync", "missing_kernels"])
def test_flash_sass_fails_on_serialized_wgmma_or_a_missing_log(log, listing,
                                                               passes):
    """Every one of the nine bf16 flash functions -- K3's too -- must be
    there, on wgmma and TMA, with no serialized wgmma and a log to tell."""
    if passes:
        chip_smoke.phase_flash_sass(_Kernels(log, listing))
    else:
        with pytest.raises(AssertionError):
            chip_smoke.phase_flash_sass(_Kernels(log, listing))


def test_flash_source_keys_on_the_hopper_header():
    names = [p.name for p in _kernels.sources_of("flash_attention")]
    assert names == ["flash_attention.cu", "hopper.cuh"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_view_keeps_what_tma_takes_and_copies_the_rest(dtype):
    qkv = torch.zeros((2, 64, 3, 4, 64), dtype=dtype)
    for t in qkv.unbind(2):  # the model's fused projection: no copy
        assert tfa._kernel_view(t).data_ptr() == t.data_ptr()
    x = torch.zeros((2, 64, 4, 64), dtype=dtype)
    expanded = x[:, :, :1].expand(2, 64, 4, 64)  # a head stride of 0
    assert tfa._kernel_view(expanded).stride() == x.stride()
    odd = torch.zeros((2, 64, 4, 65), dtype=dtype)[..., :64]  # 130-byte rows
    assert tfa._kernel_view(odd).is_contiguous()
    shifted = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=dtype)[1:].view(
        2, 64, 4, 64)  # base off 16 bytes
    view = tfa._kernel_view(shifted)
    assert view.data_ptr() % 16 == 0 and view.is_contiguous()
