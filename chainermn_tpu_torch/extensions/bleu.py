"""Corpus BLEU from exactly-summable per-sentence statistics: the port of
``chainermn_tpu/extensions/bleu.py``.

BLEU is a corpus-level metric: clipped n-gram match counts, n-gram
totals and candidate/reference lengths are summed over the whole corpus
and only then combined through the nonlinear formula.  So:

* :func:`bleu_stats` -- on the batch's device, over tensors: per-sentence
  statistic vectors, vectorized (window comparisons, no Python loop over
  tokens), which the :class:`~chainermn_tpu_torch.extensions.Evaluator`
  sums mask-exactly over batches and ranks;
* :func:`bleu_from_stats` / :func:`bleu_finalize` -- host-side finalize on
  the summed statistics (the evaluator's ``finalize`` hook).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from chainermn_tpu_torch.datasets.seq import BOS, EOS, PAD

MAX_N = 4


def _clipped_ngram_counts(cand, cand_mask, ref, ref_mask, n):
    """For every valid candidate window i with gram g_i, its contribution
    is ``min(c_i, r_i) / c_i``, c_i / r_i counting g_i among the valid
    candidate / reference windows: summed over the c_i instances of a gram
    this is the clipped count ``min(c, r)``.  Returns the per-sentence
    clipped matches and valid-window totals, fp32 ``(B,)``."""
    B, T = cand.shape
    W = T - n + 1
    if W <= 0:
        z = torch.zeros((B,), dtype=torch.float32, device=cand.device)
        return z, z.clone()
    idx = (torch.arange(W, device=cand.device)[:, None]
           + torch.arange(n, device=cand.device)[None, :])
    cg, rg = cand[:, idx], ref[:, idx]  # (B, W, n)
    cm = cand_mask[:, idx].amin(-1)  # (B, W): window inside the sentence
    rm = ref_mask[:, idx].amin(-1)
    eq_cr = (cg[:, :, None, :] == rg[:, None, :, :]).all(-1).float()
    eq_cc = (cg[:, :, None, :] == cg[:, None, :, :]).all(-1).float()
    r_i = (eq_cr * rm[:, None, :]).sum(-1)
    c_i = (eq_cc * cm[:, None, :]).sum(-1)
    contrib = torch.where(cm > 0,
                          torch.minimum(c_i, r_i) / c_i.clamp_min(1.0),
                          torch.zeros_like(c_i))
    return contrib.sum(-1), cm.sum(-1)


def bleu_stats(pred, ref) -> Dict[str, torch.Tensor]:
    """Per-sentence BLEU statistics, each a float32 ``(B,)`` tensor on
    ``pred``'s device.

    ``pred``: decoded token ids (B, T); the candidate runs until its first
    EOS/PAD/BOS.  ``ref``: PAD-padded reference ids (B, T); its EOS and
    BOS are not content.  Keys: ``bleu_match_n`` / ``bleu_total_n`` for
    n = 1..4, ``bleu_cand_len``, ``bleu_ref_len``."""
    pred = torch.as_tensor(pred)
    ref = torch.as_tensor(ref, device=pred.device)
    if pred.shape != ref.shape:
        raise ValueError(
            f"pred {tuple(pred.shape)} and ref {tuple(ref.shape)} must be "
            "padded to the same shape")
    pred = pred.to(torch.int32)
    ref = ref.to(torch.int32)
    stop = (pred == EOS) | (pred == PAD) | (pred == BOS)
    cand_mask = torch.cumprod(1.0 - stop.float(), dim=1)
    ref_mask = ((ref != PAD) & (ref != EOS) & (ref != BOS)).float()
    out = {"bleu_cand_len": cand_mask.sum(-1),
           "bleu_ref_len": ref_mask.sum(-1)}
    for n in range(1, MAX_N + 1):
        m, t = _clipped_ngram_counts(pred, cand_mask, ref, ref_mask, n)
        out[f"bleu_match_{n}"] = m
        out[f"bleu_total_{n}"] = t
    return out


def bleu_from_stats(sums: Dict[str, float], smooth: float = 1e-9) -> float:
    """Corpus BLEU (0..100) from summed statistics: the geometric mean of
    the clipped n-gram precisions with the brevity penalty."""
    logs = []
    for n in range(1, MAX_N + 1):
        match = float(sums[f"bleu_match_{n}"])
        total = float(sums[f"bleu_total_{n}"])
        if total <= 0:
            continue
        logs.append(np.log(max(match, smooth) / total))
    if not logs:
        return 0.0
    cand = max(float(sums["bleu_cand_len"]), smooth)
    ref = float(sums["bleu_ref_len"])
    bp = min(1.0, np.exp(1.0 - ref / cand))
    return float(100.0 * bp * np.exp(np.mean(logs)))


def bleu_finalize(sums: Dict[str, float], count: float) -> Dict[str, float]:
    """``Evaluator.finalize`` hook: corpus BLEU plus the corpus sizes."""
    return {
        "bleu": bleu_from_stats(sums),
        "bleu_cand_len": float(sums["bleu_cand_len"]),
        "bleu_ref_len": float(sums["bleu_ref_len"]),
        "n_sentences": float(count),
    }
