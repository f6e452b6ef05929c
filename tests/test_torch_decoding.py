"""Beam search, speculative generation and the rolling ring cache of the
port against the JAX package, on Flax parameters carried across by
``params_from_flax``.

Geometry: 2-layer models (1-layer drafts), d_model 32, 2 heads, vocab 40
(4 where rows must accept differently), float32 on the CPU.  Beam and
speculative cases run both cache layouts: on ``decode_attention="fused"``
the JAX side's single-token steps run the fused decode kernel in Pallas
interpret mode, the port's its plain version.  Tolerances: tokens and
target-forward counts exactly; beam scores 1e-5, and 1e-4 over 32 steps
(fp32 sums of log-probabilities in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import lm_beam_search as jax_beam
from chainermn_tpu.models import lm_generate as jax_generate
from chainermn_tpu.models import lm_speculative_generate as jax_spec
from chainermn_tpu_torch.models import (
    TransformerLM,
    lm_beam_search,
    lm_generate,
    lm_speculative_generate,
)
from chainermn_tpu_torch.models.decoding import speculative_accept
from chainermn_tpu_torch.utils import params_from_flax

import torch_threads  # noqa: E402,F401  (one torch pool per xdist worker)

pytestmark = pytest.mark.tier1

BASE = dict(vocab=40, n_layers=2, d_model=32, n_heads=2, d_ff=64,
            max_len=64)

_PARAMS = {}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(seed=0, **over):
    """A JAX model with Flax params (made once per parameter shapes and
    seed) and the port's model carrying the same weights."""
    kw = {**BASE, **over}
    jm = JaxLM(**kw, dtype=jnp.float32, attention="xla")
    key = (seed, kw["vocab"], kw["n_layers"], kw["max_len"],
           kw.get("pos_enc", "learned"))
    if key not in _PARAMS:
        p = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 8), jnp.int32))
        _PARAMS[key] = jax.tree_util.tree_map(np.asarray, p["params"])
    params = _PARAMS[key]
    tm = TransformerLM(**kw, dtype=torch.float32, attention="xla",
                       device="cpu")
    tm.load_state_dict(params_from_flax(params, device="cpu"))
    return jm, params, tm


def _tokens(B, T, seed=0, vocab=40):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)) \
        .astype(np.int32)


def _jax_beam(jm, params, prompt, n_new, **kw):
    toks, scores = jax.jit(lambda p, x: jax_beam(jm, p, x, n_new, **kw))(
        params, jnp.asarray(prompt))
    return np.asarray(toks), np.asarray(scores)


# ------------------------------------------------------------------ beam
@pytest.mark.parametrize("beam,layout", [(1, "einsum"), (2, "fused"),
                                         (4, "einsum"), (4, "fused")])
def test_beam_search_matches_jax(beam, layout):
    jm, params, tm = _pair(decode_attention=layout)
    prompt = _tokens(3, 6, seed=beam)
    want, want_s = _jax_beam(jm, params, prompt, 7, beam=beam)
    got, got_s = lm_beam_search(tm, torch.from_numpy(prompt), 7, beam=beam)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-5, rtol=0)
    assert got.dtype == torch.int32 and got_s.dtype == torch.float32
    if beam == 1:  # greedy, token for token
        np.testing.assert_array_equal(
            got.numpy(), lm_generate(tm, torch.from_numpy(prompt), 7).numpy())


@pytest.mark.parametrize("case", ["eos_penalty", "beam_over_vocab"])
def test_beam_search_eos_penalty_and_wide_beams(case):
    """An EOS that freezes beams (padded after it) under a length
    penalty; a beam wider than a vocab of 5 (the surplus seeded at
    -1e30)."""
    if case == "eos_penalty":
        jm, params, tm = _pair()
        prompt = _tokens(2, 4, seed=3)
        kw = dict(beam=4, eos_id=3, pad_id=0, length_penalty=0.6)
        n_new = 10
    else:
        jm, params, tm = _pair(vocab=5)
        prompt = _tokens(2, 4, seed=4, vocab=5)
        kw = dict(beam=8)
        n_new = 4
    want, want_s = _jax_beam(jm, params, prompt, n_new, **kw)
    got, got_s = lm_beam_search(tm, torch.from_numpy(prompt), n_new, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-5, rtol=0)
    if case == "eos_penalty":
        hit = False
        for row in got.numpy():
            at = np.where(row == 3)[0]
            if at.size:
                hit = True
                assert (row[at[0] + 1:] == 0).all()
        assert hit  # the case exercises a frozen beam


def test_beam_search_can_score_below_greedy():
    """Beam search does not bound its best score from below by greedy's:
    at 32 steps over a vocab of 256 the JAX package's beam 4 scores below
    the greedy sequence's summed log-probability on some row (the greedy
    prefix fell out of the beam), and the port returns the same tokens
    and scores."""
    jm, params, tm = _pair(vocab=256)
    prompt = _tokens(8, 8, seed=0, vocab=256)
    want, want_s = _jax_beam(jm, params, prompt, 32, beam=4)
    got, got_s = lm_beam_search(tm, torch.from_numpy(prompt), 32, beam=4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-4, rtol=0)
    greedy = lm_generate(tm, torch.from_numpy(prompt), 32)
    logp = torch.log_softmax(tm(torch.cat([torch.from_numpy(prompt).long(),
                                           greedy.long()], 1))[:, 7:39], -1)
    greedy_lp = logp.gather(-1, greedy.long()[..., None])[..., 0].sum(1)
    assert bool((got_s < greedy_lp - 1e-3).any())


def test_beam_search_validation():
    _, _, tm = _pair()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="beam must be >= 1"):
        lm_beam_search(tm, prompt, 2, beam=0)
    with pytest.raises(ValueError, match="max_len"):
        lm_beam_search(tm, prompt, 70, beam=2)
    toks, scores = lm_beam_search(tm, prompt, 0)
    assert tuple(toks.shape) == (1, 0) and tuple(scores.shape) == (1,)


# ------------------------------------------------------------ speculative
def _jax_spec(jm, params, dm, dparams, prompt, n_new, k):
    toks, fwd = jax.jit(lambda p, q, x: jax_spec(jm, p, dm, q, x, n_new,
                                                 k=k))(
        params, dparams, jnp.asarray(prompt))
    return np.asarray(toks), int(fwd)


@pytest.mark.parametrize("k,layout", [(1, "einsum"), (2, "fused"),
                                      (4, "einsum")])
def test_speculative_matches_jax_and_greedy(k, layout):
    """A 1-layer draft of other weights proposes: the tokens and the
    target forwards equal the JAX run's, and the tokens equal the
    target's greedy generation."""
    jm, params, tm = _pair(decode_attention=layout)
    dm, dparams, dtm = _pair(seed=1, n_layers=1, decode_attention=layout)
    prompt = _tokens(2, 8, seed=k)
    want, want_f = _jax_spec(jm, params, dm, dparams, prompt, 13, k)
    got, got_f = lm_speculative_generate(tm, dtm, torch.from_numpy(prompt),
                                         13, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_f == want_f
    np.testing.assert_array_equal(
        got.numpy(), lm_generate(tm, torch.from_numpy(prompt), 13).numpy())


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_perfect_draft_acceptance(k):
    """Draft = target: each round accepts ~k + 1 tokens, the same number
    of target forwards as the JAX run, within one round of the ideal.
    Without the backfill of the last proposal's K/V the draft attends a
    zero row after every all-accept round and acceptance falls (the JAX
    docstring: 27 forwards against 21 at k = 1)."""
    jm, params, tm = _pair()
    prompt = _tokens(1, 6, seed=8)
    want, want_f = _jax_spec(jm, params, jm, params, prompt, 25, k)
    got, got_f = lm_speculative_generate(tm, tm, torch.from_numpy(prompt),
                                         25, k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_f == want_f
    ideal = 1 + -(-24 // (k + 1))
    assert ideal <= got_f <= ideal + 1, (got_f, ideal)


def test_speculative_per_row_acceptance():
    """Vocab 4, so that a random draft agrees often enough for rows to
    accept differently: the batched run equals JAX's (tokens and
    forwards) and takes no more rounds than its slowest row alone, plus
    one for a near-tie flip between batch sizes."""
    jm, params, tm = _pair(vocab=4)
    dm, dparams, dtm = _pair(seed=1, vocab=4, n_layers=1)
    prompt = _tokens(4, 8, seed=5, vocab=4)
    want, want_f = _jax_spec(jm, params, dm, dparams, prompt, 21, 3)
    got, fwd = lm_speculative_generate(tm, dtm, torch.from_numpy(prompt),
                                       21, k=3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert fwd == want_f
    alone = [lm_speculative_generate(tm, dtm, torch.from_numpy(prompt[r:r + 1]),
                                     21, k=3)[1] for r in range(4)]
    assert fwd <= max(alone) + 1 and len(set(alone)) > 1, (fwd, alone)


def test_speculative_learned_position_headroom():
    """The verify chunk reaches P + n_new + k - 1: past max_len the port
    raises the JAX package's error before any forward.  At the bound
    itself finished rows run on past the table, which the port clamps as
    the JAX gather does: the run completes and equals JAX's."""
    jm, params, tm = _pair(max_len=28)
    prompt = _tokens(2, 8, seed=6)
    with pytest.raises(ValueError, match="verify needs"):
        lm_speculative_generate(tm, tm, torch.from_numpy(prompt), 17, k=5)
    want, want_f = _jax_spec(jm, params, jm, params, prompt, 17, 4)
    got, got_f = lm_speculative_generate(tm, tm, torch.from_numpy(prompt),
                                         17, k=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_f == want_f
    with pytest.raises(ValueError, match="k must be >= 1"):
        lm_speculative_generate(tm, tm, torch.from_numpy(prompt), 4, k=0)


def test_speculative_sampling_is_seeded_and_in_range():
    _, _, tm = _pair()
    _, _, dtm = _pair(seed=1, n_layers=1)
    prompt = torch.from_numpy(_tokens(2, 8, seed=7))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return lm_speculative_generate(tm, dtm, prompt, 15, k=3,
                                       temperature=0.8, generator=g)

    (a, fa), (b, fb) = run(3), run(3)
    assert torch.equal(a, b) and fa == fb
    assert tuple(a.shape) == (2, 15) and bool(((a >= 0) & (a < 40)).all())
    with pytest.raises(ValueError, match="requires generator"):
        lm_speculative_generate(tm, dtm, prompt, 4, k=2, temperature=0.5)


def test_speculative_accept_statistical_oracle():
    """Leviathan et al.'s theorem: the emitted token at each position is
    p-distributed whatever the draft q.  20k independent rounds with a
    deliberately skewed draft; the first position's histogram is p.  And
    a draft equal to the target is always accepted."""
    V, k, N = 4, 2, 20000
    p_row = torch.tensor([0.45, 0.30, 0.20, 0.05])
    q_row = torch.tensor([0.10, 0.20, 0.30, 0.40])
    g = torch.Generator().manual_seed(0)
    drafts = torch.multinomial(q_row.expand(N * k, V), 1, replacement=True,
                               generator=g).view(N, k)
    tokens, _ = speculative_accept(p_row.log().expand(N, k + 1, V),
                                   q_row.log().expand(N, k, V), drafts, g)
    hist = torch.bincount(tokens[:, 0], minlength=V).float() / N
    np.testing.assert_allclose(hist.numpy(), p_row.numpy(), atol=0.015)
    logits = torch.from_numpy(np.random.RandomState(0).randn(2, k + 1, V)
                              .astype(np.float32))
    _, n_accept = speculative_accept(logits, logits[:, :k],
                                     torch.tensor([[1, 2], [3, 0]]), g)
    assert n_accept.tolist() == [k, k]


# ---------------------------------------------------------------- rolling
def _window_pair(window=8, **over):
    return _pair(window=window, **over)


@pytest.mark.parametrize("P", [4, 8, 20])  # < window, == window, > window
def test_rolling_matches_jax_and_full_cache(P):
    jm, params, tm = _window_pair()
    prompt = _tokens(2, P, seed=P)
    want = np.asarray(jax.jit(lambda p, x: jax_generate(
        jm, p, x, 24, rolling=True))(params, jnp.asarray(prompt)))
    got = lm_generate(tm, torch.from_numpy(prompt), 24, rolling=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), lm_generate(tm, torch.from_numpy(prompt), 24).numpy())


def test_rolling_rope_streams_past_max_len_with_a_window_sized_cache():
    """rope + rolling: 48 tokens past a 16-row max_len through 8 slots,
    the same tokens as the full rope cache; stepping the model directly,
    the ring never grows."""
    _, _, tm = _window_pair(pos_enc="rope", max_len=16)
    prompt = torch.from_numpy(_tokens(2, 6, seed=0))
    out = lm_generate(tm, prompt, 48, rolling=True)
    assert tuple(out.shape) == (2, 48)
    assert torch.equal(out, lm_generate(tm, prompt, 48))
    cache = tm.init_cache(2, 8)
    tok = torch.zeros((2, 1), dtype=torch.long)
    for pos in range(12):
        _, cache = tm(tok, cache=cache, decode_pos=pos, rolling=True)
        assert all(tuple(c["k"].shape) == (2, 8, 2, 16) for c in cache)


def test_rolling_validation():
    """Each check raises the JAX package's ValueError."""
    _, _, no_window = _pair()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="sliding-window"):
        lm_generate(no_window, prompt, 4, rolling=True)
    _, _, tm = _window_pair()
    with pytest.raises(ValueError, match="ragged"):
        lm_generate(tm, prompt, 4, rolling=True,
                    prompt_lengths=torch.tensor([2]))
    with pytest.raises(ValueError, match="window-sized"):
        tm(torch.zeros((1, 1), dtype=torch.long), cache=tm.init_cache(1, 16),
           decode_pos=0, rolling=True)
    with pytest.raises(ValueError, match="single-token"):
        tm(torch.zeros((1, 2), dtype=torch.long), cache=tm.init_cache(1, 8),
           decode_pos=0, rolling=True)
    _, _, fused = _window_pair(decode_attention="fused")
    with pytest.raises(ValueError, match="requires decode_attention='einsum'"):
        lm_generate(fused, prompt, 4, rolling=True)
    with pytest.raises(ValueError, match="non-paged"):
        fused(torch.zeros((1, 1), dtype=torch.long),
              cache=fused.init_cache(1, 8), decode_pos=0, rolling=True)
