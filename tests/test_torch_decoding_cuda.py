"""Beam search and speculative generation on the card, over the fused
decode kernel (K5) at the shapes these searches give it.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_decoding_cuda.py

In fp32, TF32 off:

* K5 against its plain version at a beam search's shape (batch 8 x beam 4
  = 32 rows, one valid length) and at a speculative draft step's (8 rows
  whose valid lengths differ row by row), atol 1e-4 (sums in another
  order);
* ``lm_beam_search(beam=1)`` equal to ``lm_generate`` token for token,
  with K5 launched once per layer per step on ``B`` rows, and the scores
  of beams 1 and 4 equal to a full forward's summed log-probability of
  their tokens (|err| <= 1e-5 |ref| + 1e-4);
* ``lm_speculative_generate`` equal to the target's greedy generation,
  with K5 launched ``draft layers x (k + 1)`` times per round (the
  ``+ 1`` is the backfill forward) and never by the target.
"""

import pytest
import torch

from chainermn_tpu_torch.models import (
    TransformerLM,
    lm_beam_search,
    lm_generate,
    lm_speculative_generate,
)
from chainermn_tpu_torch.ops import decode_attention as tda

pytestmark = pytest.mark.cuda

SMALL = dict(vocab=512, n_layers=2, d_model=128, n_heads=4, d_ff=256,
             max_len=96, decode_attention="fused", dtype=torch.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused decode kernel runs "
                    "only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,L,valid", [
    (32, 192, [192] * 32),                     # beam: 8 x 4 rows, one length
    (8, 197, [129, 130, 131, 132, 133, 129, 131, 133]),  # draft steps
], ids=["beam", "draft"])
def test_fused_kernel_at_search_shapes(dev, rows, L, valid):
    g = torch.Generator().manual_seed(rows)
    H, Dh = 12, 64
    q = torch.randn((rows, H, Dh), generator=g).to(dev)
    kc = torch.randn((rows, H, L, Dh), generator=g).to(dev)
    vc = torch.randn((rows, H, L, Dh), generator=g).to(dev)
    vl = torch.tensor(valid, dtype=torch.int32, device=dev)
    got = tda.fused_decode_attention(q, kc, vc, vl)
    want = tda.fused_decode_attention_reference(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def test_beam_one_is_greedy_on_the_card(dev):
    model = TransformerLM(**SMALL, device=dev, seed=0)
    prompt = torch.randint(0, 512, (4, 16),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    tda.fused_decode_attention.launches = 0
    toks, scores = lm_beam_search(model, prompt, 12, beam=1)
    assert tda.fused_decode_attention.launches == 11 * SMALL["n_layers"]
    assert torch.equal(toks, lm_generate(model, prompt, 12))
    wide, wide_scores = lm_beam_search(model, prompt, 12, beam=4)
    # Each search's score is its tokens' summed log-probability, taken
    # here from one full forward (fp32 sums of 12 terms in another order).
    for toks_, scores_ in ((toks, scores), (wide, wide_scores)):
        with torch.no_grad():
            logits = model(torch.cat([prompt, toks_.long()], dim=1))
        logp = torch.log_softmax(logits[:, 15:27], dim=-1)
        ref = logp.gather(-1, toks_.long()[..., None])[..., 0].sum(dim=1)
        assert bool(((scores_ - ref).abs() <= 1e-5 * ref.abs() + 1e-4).all())


def test_speculative_is_greedy_on_the_card(dev):
    target = TransformerLM(**SMALL, device=dev, seed=0)
    draft = TransformerLM(**{**SMALL, "n_layers": 1}, device=dev, seed=0)
    # The distilled draft of the decode benchmark: the target's second
    # block writes nothing back (proj and ff2 zeroed), and the draft is
    # its first block with the embeddings, ln_f and head.
    with torch.no_grad():
        for lin in (target.blocks[1].proj, target.blocks[1].ff2):
            lin.weight.zero_()
            lin.bias.zero_()
    draft.load_state_dict({k: v for k, v in target.state_dict().items()
                           if not k.startswith("blocks.1.")})
    prompt = torch.randint(0, 512, (4, 16),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    k = 3
    tda.fused_decode_attention.launches = 0
    toks, fwd = lm_speculative_generate(target, draft, prompt, 24, k=k)
    rounds = fwd - 1
    assert tda.fused_decode_attention.launches == (k + 1) * rounds
    assert torch.equal(toks, lm_generate(target, prompt, 24))
    assert rounds <= 23 // 2  # most proposals were accepted
