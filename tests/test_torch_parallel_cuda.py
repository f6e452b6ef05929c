"""The flash kernels on the sequence-parallel paths, on a card: the ring,
zigzag and Ulysses attentions of 4 ranks sharing card 0 (gloo, each
message staged through host memory), each held against the same function
run on CPU copies of its inputs, where every kernel call runs its plain
version.  Shapes: ``chip_smoke.py``'s ``sequence_parallel`` (one row of
8192 positions, 2048 per rank, 12 heads, Dh 64, bf16, causal; GQA with 4
kv heads; packed rows whose segments leave rows dead in whole visiting
blocks).  Tolerances (``chip_smoke.py``'s ``SP_TOL``): the output in
``excess`` (max over elements of (|err| - rtol |ref|) over the RMS of the
reference's row) <= 3e-2 with rtol 2^-7 (one bf16 rounding each side);
each gradient by its relative Frobenius error <= 2^-6 (a rank's dQ, dK
and dV are sums of up to 4 partial blocks, each rounded to bf16 and
added in bf16, on both sides, and a partial's rounding is relative to the
partial, not to the sum).  Each rank must also have launched K1-K3 as
predicted: ``r + 1`` blocks of a causal ring of 4 on rank ``r``,
``2S + 1 = 9`` zigzag quadrants, one Ulysses call.

Marker ``cuda``; no JAX.  Runs on a card machine with
``python -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_parallel_cuda.py``.
"""

import os

import pytest
import torch

from torch_process_state import restore_process_state  # noqa: E402,F401
from torch_ranks import run_ranks

pytestmark = pytest.mark.cuda

S = 4
ATOL = 3e-2
GRAD_FRO = 2 ** -6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only there")
    return run_ranks("seqpar_cuda", tmp_path_factory.mktemp("seqpar_cuda"),
                     S, timeout_s=600.0, env={"CUDA_VISIBLE_DEVICES":
                                               os.environ.get(
                                                   "CUDA_VISIBLE_DEVICES",
                                                   "0")})


def _predicted(name, r):
    if name.startswith("zigzag"):
        return 2 * S + 1
    if name.startswith("ulysses"):
        return 1
    return r + 1


CASES = ["ring_flash", "ring_flash_packed", "ring_flash_gqa",
         "zigzag_flash", "zigzag_flash_packed", "ulysses_flash"]


@pytest.mark.parametrize("name", CASES)
def test_kernels_match_their_plain_versions(ranks, name):
    seen = [(r, res[name]["finite"], res[name]["excess"]["o"],
             {k: res[name]["fro"][k] for k in ("dq", "dk", "dv")})
            for r, res in enumerate(ranks)]
    for r, finite, o, fro in seen:
        assert finite, (name, seen)
        assert o <= ATOL, (name, seen)
        assert max(fro.values()) <= GRAD_FRO, (name, seen)


@pytest.mark.parametrize("name", CASES)
def test_each_rank_launches_the_predicted_kernels(ranks, name):
    for r, res in enumerate(ranks):
        want = _predicted(name, r)
        assert res[name]["launches"] == {
            "flash_attention_fwd": want, "flash_attention_bwd_dkv": want,
            "flash_attention_bwd_dq": want}, (name, r)
