"""The port's seq2seq family against the JAX package, on Flax parameters
carried across by the seq2seq bridges.

Models: ``TransformerSeq2Seq`` (2 + 2 layers, d_model 32, 4 heads, d_ff
64, vocab 37) unpacked and packed on the eager ``"xla"`` path; one
encoder and one decoder layer (d_model 32, 2 heads) on the flash path,
the port's plain K1-K3 against the JAX Pallas kernels in interpret mode;
the LSTM ``Seq2Seq`` (embed 8, hidden 16).  float32 on the CPU.

Tolerances: logits, losses and every gradient leaf within 1e-5 of the
JAX leaf's largest magnitude (float32 through a few layers, sums in
another order; the readings are 1e-7-1e-6 of it); token accuracy exactly
(the same argmax picks); decoded tokens token for token; the packed-pair
oracle (the port alone) 2e-5 absolute, as the JAX package's own test
holds it at 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import Seq2Seq as JaxLSTM
from chainermn_tpu.models import TransformerSeq2Seq as JaxS2S
from chainermn_tpu.models import beam_decode as jax_beam
from chainermn_tpu.models import greedy_decode as jax_greedy
from chainermn_tpu.models import seq2seq_loss as jax_loss
from chainermn_tpu_torch.datasets import pack_pairs
from chainermn_tpu_torch.datasets.seq import BOS, EOS, PAD
from chainermn_tpu_torch.models import (
    Seq2Seq,
    TransformerSeq2Seq,
    beam_decode,
    greedy_decode,
    seq2seq_loss,
)
from chainermn_tpu_torch.models.seq2seq import _pow2_block, _use_flash
from chainermn_tpu_torch.utils import (
    lstm_seq2seq_params_from_flax,
    lstm_seq2seq_params_to_flax,
    seq2seq_params_from_flax,
    seq2seq_params_to_flax,
)

pytestmark = pytest.mark.tier1

REL = 1e-5
V = 37
S2S = dict(vocab_src=V, vocab_tgt=V, d_model=32, n_heads=4, d_ff=64,
           n_enc=2, n_dec=2, max_len=24)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _leaves_close(got_tree, want_tree, rel=REL):
    got, want = _flat(got_tree), _flat(want_tree)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], rel)


def _batch(seed=0, B=3, Ts=12, Tt=10):
    """PAD-tailed source and target rows of several lengths."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, V, (B, Ts)).astype(np.int32)
    tgt = rng.randint(3, V, (B, Tt)).astype(np.int32)
    for r, (ls, lt) in enumerate(((8, Tt), (Ts, 6), (5, 4))[:B]):
        src[r, ls:] = PAD
        tgt[r, lt:] = PAD
    return src, tgt


def _pairs(seed=0, n=5, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [(rng.randint(3, V, size=ls).astype(np.int32),
             rng.randint(3, V, size=lt).astype(np.int32))
            for ls, lt in rng.randint(lo, hi, size=(n, 2))]


_PARAMS = {}


def _transformer(attention="xla", **over):
    """A JAX model with Flax params and the port's model carrying them."""
    kw = {**S2S, **over}
    jm = JaxS2S(**kw, dtype=jnp.float32, attention=attention)
    key = tuple(sorted(over.items()))
    if key not in _PARAMS:
        p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                    jnp.zeros((1, 8), jnp.int32))["params"]
        _PARAMS[key] = jax.tree_util.tree_map(np.asarray, p)
    params = _PARAMS[key]
    tm = TransformerSeq2Seq(**kw, attention=attention, device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(params, device="cpu"))
    return jm, params, tm


def _grads(tm):
    return {n: p.grad for n, p in tm.named_parameters()}


def _jax_grad(jm, params, batch):
    """``((loss, aux), grads)`` of the JAX loss, jitted."""
    return jax.jit(jax.value_and_grad(jax_loss(jm), has_aux=True))(
        params, tuple(jnp.asarray(a) for a in batch))


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_transformer_logits_loss_and_grads_match_jax(packed):
    jm, params, tm = _transformer()
    if packed:
        batch = pack_pairs(_pairs(), 16, 16)
        assert batch[0].shape[0] >= 2
    else:
        batch = _batch()
    (jl, jaux), jg = _jax_grad(jm, params, batch)
    loss, aux = seq2seq_loss(tm)(tm, batch)
    loss.backward()
    _close(loss.detach(), jl)
    assert float(aux["token_accuracy"]) == float(jaux["token_accuracy"])
    _leaves_close(seq2seq_params_to_flax(_grads(tm), S2S["n_heads"]), jg)
    with torch.no_grad():
        _close(tm(*batch), jax.jit(jm.apply)({"params": params}, *batch))


def test_bridge_round_trips_every_leaf():
    _, params, tm = _transformer()
    back = seq2seq_params_to_flax(dict(tm.named_parameters()),
                                  S2S["n_heads"])
    got, want = _flat(back), _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_flash_path_matches_jax_flash_interpret():
    """One encoder and one decoder layer, ``attention="flash"``: the port's
    plain K1-K3 (CPU) against the JAX Pallas kernels in interpret mode,
    on packed rows (segment masks on all three paths, pad queries of a
    row with no source pad tail that match no key)."""
    small = dict(d_model=32, n_heads=2, n_enc=1, n_dec=1)
    jm, params, tm = _transformer("flash", **small)
    src, tgt, sseg, tseg = pack_pairs(_pairs(n=4), 16, 16)
    # A row whose source is full and whose target has a pad tail: its pad
    # queries match no key (the dead-row contract).
    src[0] = np.arange(16) % (V - 3) + 3
    sseg[0] = 1
    batch = (src, tgt, sseg, tseg)
    assert (tseg[0] == 0).any() and not (sseg[0] == 0).any()
    (jl, _), jg = _jax_grad(jm, params, batch)
    loss, _ = seq2seq_loss(tm)(tm, batch)
    loss.backward()
    _close(loss.detach(), jl)
    _leaves_close(seq2seq_params_to_flax(_grads(tm), 2), jg)


def test_attention_path_choice_follows_jax():
    """``_use_flash``: an explicit "flash" needs a power-of-two block of
    at least 8 on every length; "auto" is the eager path on the CPU."""
    assert _pow2_block(512) == 128 and _pow2_block(20) == 4
    assert _use_flash("flash", 16, 24) and not _use_flash("flash", 16, 20)
    assert not _use_flash("xla", 512)
    assert not _use_flash("auto", 512, device="cpu")
    assert _use_flash("auto", 512, 512, device="cuda")
    assert not _use_flash("auto", 64, device="cuda")


def test_enc_attention_override_and_validation():
    _, _, base = _transformer()
    src, tgt = _batch()
    mixed = TransformerSeq2Seq(**S2S, attention="xla", enc_attention="flash",
                               device="cpu")
    mixed.load_state_dict(base.state_dict())
    with torch.no_grad():
        _close(mixed(src, tgt), base(src, tgt).numpy())
    for kw, match in ((dict(attention="fast"), "attention="),
                      (dict(enc_attention="x"), "enc_attention="),
                      (dict(n_heads=5), "divisible")):
        with pytest.raises(ValueError, match=match):
            TransformerSeq2Seq(**{**S2S, **kw}, device="cpu")
    with pytest.raises(ValueError, match="BOTH"):
        base(src, tgt, src_seg=(src != 0))
    with pytest.raises(ValueError, match="max_len"):
        base(np.ones((1, 30), np.int32), tgt[:1])


def test_lstm_seq2seq_matches_jax():
    jm = JaxLSTM(vocab_src=V, vocab_tgt=V, embed=8, hidden=16)
    src, tgt = _batch()
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), src, tgt)["params"])
    tm = Seq2Seq(vocab_src=V, vocab_tgt=V, embed=8, hidden=16, device="cpu")
    tm.load_state_dict(lstm_seq2seq_params_from_flax(params, device="cpu"))
    (jl, jaux), jg = _jax_grad(jm, params, (src, tgt))
    loss, aux = seq2seq_loss(tm)(tm, (src, tgt))
    loss.backward()
    _close(loss.detach(), jl)
    assert float(aux["token_accuracy"]) == float(jaux["token_accuracy"])
    _leaves_close(lstm_seq2seq_params_to_flax(_grads(tm)), jg)
    back = _flat(lstm_seq2seq_params_to_flax(dict(tm.named_parameters())))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)
    # The encoder runs over the PAD tail: the decoder sees a carry that
    # depends on it, as the JAX scan's does.
    src2 = src.copy()
    src2[0, -1] = 5
    with torch.no_grad():
        assert not torch.equal(tm(src, tgt), tm(src2, tgt))


def test_greedy_and_beam_decode_token_for_token():
    jm, params, tm = _transformer()
    src, _ = _batch(seed=3)
    n = 8
    got = greedy_decode(tm, src, max_len=n)
    want = np.asarray(jax.jit(lambda p, s: jax_greedy(jm, p, s, max_len=n))(
        params, jnp.asarray(src)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(beam_decode(tm, src, max_len=n, beam=1),
                                  got)
    for kw in (dict(beam=3), dict(beam=3, eos_id=EOS, length_penalty=0.6)):
        want = jax.jit(lambda p, s: jax_beam(jm, p, s, max_len=n, **kw))(
            params, jnp.asarray(src))
        np.testing.assert_array_equal(
            beam_decode(tm, src, max_len=n, **kw).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="beam"):
        beam_decode(tm, src, beam=0)


def test_packed_pair_computes_what_it_computes_alone():
    _, _, tm = _transformer()
    src, tgt, sseg, tseg = pack_pairs(_pairs(n=4), 16, 16)
    shifted = np.concatenate([np.full((len(tgt), 1), BOS, np.int32),
                              tgt[:, :-1]], 1)
    start = np.concatenate([np.ones((len(tgt), 1), bool),
                            tseg[:, 1:] != tseg[:, :-1]], 1)
    tgt_in = np.where(start, BOS, shifted).astype(np.int32)
    with torch.no_grad():
        packed = tm(src, tgt_in, sseg, tseg).numpy()
        seen = 0
        for r in range(len(src)):
            for j in range(1, sseg[r].max() + 1):
                s_tok, t_tok = src[r][sseg[r] == j], tgt[r][tseg[r] == j]
                s_row = np.full((1, 16), PAD, np.int32)
                s_row[0, :len(s_tok)] = s_tok
                t_row = np.full((1, 16), PAD, np.int32)
                t_row[0, 0] = BOS
                t_row[0, 1:len(t_tok)] = t_tok[:-1]
                alone = tm(s_row, t_row).numpy()[0, :len(t_tok)]
                np.testing.assert_allclose(packed[r][tseg[r] == j], alone,
                                           atol=2e-5, rtol=0)
                seen += 1
    assert seen == 4


def test_seq2seq_twin_runs_on_cpu(tmp_path, capsys):
    """The example twin on an on-disk corpus, each arch, bucketed and
    packed, with BLEU from the evaluator."""
    from chainermn_tpu_torch.datasets.seq import (
        make_synthetic_translation,
        save_translation_npz,
    )
    from chainermn_tpu_torch.examples import seq2seq as twin

    npz = tmp_path / "pairs.npz"
    save_translation_npz(npz, make_synthetic_translation(
        128, vocab=20, min_len=4, max_len=8, seed=5))
    small = ["--device", "cpu", "--epoch", "2", "--batchsize", "8",
             "--vocab", "20", "--embed", "32", "--hidden", "32",
             "--data-npz", str(npz)]
    for flags in (["--arch", "lstm"], ["--arch", "transformer"],
                  ["--arch", "transformer", "--packed", "--pack-len", "24"]):
        scores = twin.main(small + flags)
        assert 0.0 <= scores["bleu"] <= 100.0
        assert scores["n_sentences"] > 0
    out = capsys.readouterr().out
    assert out.count("corpus BLEU") == 3 and "packing efficiency" in out
    with pytest.raises(SystemExit):
        twin.main(["--device", "cpu", "--arch", "lstm", "--packed"])
