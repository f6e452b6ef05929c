"""The port's sequence data and corpus BLEU against the JAX package.

Data (``datasets/seq.py``, ``pack_pairs``): the same inputs give equal
arrays, exactly (both are numpy from the same draws).  BLEU: the cases of
``tests/extensions_tests/test_bleu.py`` (its Counter oracle and corpora,
loaded from that file): per-sentence statistics equal to the JAX
``bleu_stats`` exactly (integer counts in fp32), corpus BLEU within rtol
1e-6 of the oracle, and the port's evaluator over batches with a short
tail equal to the one-shot oracle.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from chainermn_tpu.datasets import pack_pairs as jax_pack_pairs
from chainermn_tpu.datasets import seq as jax_seq
from chainermn_tpu.extensions import bleu_stats as jax_bleu_stats
from chainermn_tpu_torch.comm import create_communicator
from chainermn_tpu_torch.datasets import pack_pairs
from chainermn_tpu_torch.datasets import seq
from chainermn_tpu_torch.extensions import (
    Evaluator,
    bleu_finalize,
    bleu_from_stats,
    bleu_stats,
    create_multi_node_evaluator,
)

from torch_process_state import restore_process_state  # noqa: E402,F401

pytestmark = pytest.mark.tier1


def _load_bleu_cases():
    path = os.path.join(os.path.dirname(__file__), "extensions_tests",
                        "test_bleu.py")
    spec = importlib.util.spec_from_file_location("jax_bleu_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = _load_bleu_cases()


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_sentinels_and_pad_to():
    assert (seq.PAD, seq.BOS, seq.EOS) == (jax_seq.PAD, jax_seq.BOS,
                                           jax_seq.EOS)
    np.testing.assert_array_equal(seq.pad_to([4, 5], 5),
                                  jax_seq.pad_to([4, 5], 5))


@pytest.mark.parametrize("kw", [
    dict(), dict(bucket_width=4, drop_incomplete=False),
    dict(bucket_width=4, keep_tail=True, max_len=10, seed=3)],
    ids=["default", "wrap_fill", "keep_tail_truncate"])
def test_bucket_batches_equal_jax(kw):
    pairs = seq.make_synthetic_translation(300, vocab=30, min_len=3,
                                           max_len=14, seed=1)
    assert pairs == jax_seq.make_synthetic_translation(300, vocab=30,
                                                       min_len=3, max_len=14,
                                                       seed=1)
    _equal_batches(seq.bucket_batches(pairs, 16, **kw),
                   jax_seq.bucket_batches(pairs, 16, **kw))


def test_pack_pairs_equal_jax():
    rng = np.random.RandomState(0)
    pairs = [(rng.randint(3, 50, size=ls), rng.randint(3, 50, size=lt))
             for ls, lt in rng.randint(1, 20, size=(40, 2))]
    pairs.append((np.arange(3, 40), np.arange(3, 6)))  # overlong: dropped
    _equal_batches([pack_pairs(pairs, 24, 20)],
                   [jax_pack_pairs(pairs, 24, 20)])


def test_translation_npz_round_trip_both_ways(tmp_path):
    pairs = seq.make_synthetic_translation(20, vocab=40, seed=2)
    seq.save_translation_npz(tmp_path / "port.npz", pairs)
    jax_seq.save_translation_npz(tmp_path / "jax.npz", pairs)
    assert seq.load_translation_npz(tmp_path / "jax.npz") == pairs
    assert jax_seq.load_translation_npz(tmp_path / "port.npz") == pairs
    seq.save_translation_npz(tmp_path / "empty.npz", [])
    assert seq.load_translation_npz(tmp_path / "empty.npz") == []


def _sums(stats):
    return {k: float(torch.as_tensor(v).sum()) for k, v in stats.items()}


def test_bleu_stats_equal_jax_and_the_oracle():
    cands, refs = CASES._corpus()
    T = 14
    pred = CASES._pad_ids(cands, T)
    ref = CASES._pad_ids(refs, T, eos=False)
    got = bleu_stats(torch.from_numpy(pred), torch.from_numpy(ref))
    want = jax_bleu_stats(pred, ref)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].dtype == torch.float32
    sums = _sums(got)
    m, t, _, _ = CASES.oracle_stats(cands, refs)
    for n in range(1, 5):
        assert sums[f"bleu_match_{n}"] == pytest.approx(m[n], abs=1e-4)
        assert sums[f"bleu_total_{n}"] == pytest.approx(t[n], abs=1e-4)
    assert bleu_from_stats(sums) == pytest.approx(
        CASES.oracle_corpus_bleu(cands, refs), rel=1e-6)


def test_bleu_perfect_disjoint_and_shape_check():
    refs = [[3, 4, 5, 6, 7], [8, 9, 10, 11]]
    perfect = bleu_stats(CASES._pad_ids(refs, 8),
                         CASES._pad_ids(refs, 8, eos=False))
    assert bleu_from_stats(_sums(perfect)) == pytest.approx(100.0, abs=1e-6)
    disjoint = bleu_stats(CASES._pad_ids([[3, 4, 5, 6]], 6),
                          CASES._pad_ids([[10, 11, 12, 13]], 6, eos=False))
    assert bleu_from_stats(_sums(disjoint)) < 1e-6
    with pytest.raises(ValueError, match="same shape"):
        bleu_stats(np.zeros((2, 5), np.int32), np.zeros((2, 6), np.int32))


def test_evaluator_aggregates_corpus_bleu_exactly():
    """Batches with a short tail through the multi-node evaluator == the
    one-shot oracle over the whole corpus (sum, then finalize)."""
    cands, refs = CASES._corpus(n=53, seed=7)
    T = 14
    pred, ref = CASES._pad_ids(cands, T), CASES._pad_ids(refs, T, eos=False)
    comm = create_communicator("xla", device="cpu")

    def batches():
        for i in range(0, len(cands), 16):
            yield pred[i:i + 16], ref[i:i + 16]

    ev = create_multi_node_evaluator(
        Evaluator(batches, lambda m, b: bleu_stats(*b), comm,
                  finalize=bleu_finalize), comm)
    scores = ev.evaluate(None)
    assert scores["bleu"] == pytest.approx(
        CASES.oracle_corpus_bleu(cands, refs), rel=1e-6)
    assert scores["n_sentences"] == len(cands)
