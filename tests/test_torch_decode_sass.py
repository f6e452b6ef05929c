"""The CPU side of the decode kernels' build census (``chip_smoke.py``'s
``decode_sass`` line): the bf16-cache functions of K4 and K5 copy K/V with
asynchronous bulk copies and ptxas reports no spills for them."""

import pytest

import chip_smoke
from chainermn_tpu_torch.ops import _kernels

pytestmark = pytest.mark.tier1

NS = "_ZN51_GLOBAL__N__2c6f1a7e_19_decode_attention_cu_5b7f7d1a"


def _mangled(name):
    return f"{NS}{len(name)}{name}ENS_6ParamsE"


COPY = """
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 UBLKCP.S.G [UR8], [UR4], R2 ;
        /*0020*/                   UBLKCP.S.G [UR12], [UR6], R2 ;
"""
NO_COPY = """
        /*0000*/                   LDG.E.128 R4, [R2.64] ;
"""


def _listing(bodies):
    return "".join(f"\t\tFunction : {_mangled(n)}{b}"
                   for n, b in bodies.items())


def _log(names, spills=()):
    out = ""
    for n in names:
        fn = _mangled(n)
        out += (f"ptxas info    : Compiling entry function '{fn}' for "
                f"'sm_90a'\nptxas info    : Function properties for {fn}\n"
                f"    0 bytes stack frame, {8 if n in spills else 0} bytes "
                "spill stores, 0 bytes spill loads\n"
                "ptxas info    : Used 72 registers, used 1 barriers\n")
    return out


def test_ptxas_resources_per_entry_function():
    log = _log(["decode_paged_qbf16_kvbf16_rb1"],
               spills=["decode_paged_qbf16_kvbf16_rb1"])
    log += "ptxas info    : Compiling entry function 'bare' for 'sm_90a'\n"
    res = _kernels.ptxas_resources(log)
    assert res[_mangled("decode_paged_qbf16_kvbf16_rb1")] == {
        "registers": 72, "stack_bytes": 0, "spill_stores": 8,
        "spill_loads": 0}
    assert res["bare"] == {"registers": None, "stack_bytes": None,
                           "spill_stores": None, "spill_loads": None}


def test_decode_sass_rows_name_each_instantiation():
    names = ["decode_fused_qf32_kvi8_rb4", "decode_paged_qbf16_kvbf16_rb1"]
    rows = chip_smoke.decode_sass_rows(
        _kernels.sass_counts(_listing({names[0]: NO_COPY, names[1]: COPY})),
        _kernels.ptxas_resources(_log(names[1:])))
    assert rows[names[1]]["UBLKCP"] == 2
    assert rows[names[1]]["spill_stores"] == 0
    assert rows[names[0]]["UBLKCP"] == 0 and "spill_stores" not in rows[
        names[0]]


class _Kernels:
    """``_kernels`` as ``phase_decode_sass`` sees it, over a canned listing
    and build log."""

    sass_counts = staticmethod(_kernels.sass_counts)
    ptxas_resources = staticmethod(_kernels.ptxas_resources)

    def __init__(self, listing, log):
        self.listing, self.log = listing, log

    def sass(self, name):
        assert name == "decode_attention"
        return self.listing

    def build_log(self, name):
        assert name == "decode_attention"
        return self.log


BF16 = chip_smoke.DECODE_BF16


@pytest.mark.parametrize("bodies,log,passes", [
    ({n: COPY for n in BF16}, _log(BF16), True),
    ({**{n: COPY for n in BF16}, "decode_paged_qf32_kvf32_rb4": NO_COPY},
     _log(BF16), True),
    ({n: COPY for n in BF16}, _log(BF16, spills=BF16[:1]), False),
    ({n: COPY for n in BF16}, None, False),
    ({n: COPY for n in BF16[1:]}, _log(BF16), False),
    ({**{n: COPY for n in BF16}, BF16[-1]: NO_COPY}, _log(BF16), False),
    ({n: COPY for n in BF16}, _log(BF16[1:]), False),
], ids=["clean", "fp32_cache_not_held", "spills", "no_log",
        "missing_function", "no_async_copy", "no_ptxas_line"])
def test_decode_sass_fails_unless_bf16_functions_copy_and_do_not_spill(
        bodies, log, passes):
    kernels = _Kernels(_listing(bodies), log)
    if passes:
        chip_smoke.phase_decode_sass(kernels)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.phase_decode_sass(kernels)


def test_decode_source_keys_on_the_hopper_header():
    names = [p.name for p in _kernels.sources_of("decode_attention")]
    assert names == ["decode_attention.cu", "hopper.cuh"]
