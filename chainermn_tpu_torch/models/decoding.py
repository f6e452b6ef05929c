"""Beam search and speculative generation for
:class:`~chainermn_tpu_torch.models.TransformerLM`, the counterparts of
``chainermn_tpu/models/decoding.py``.

The JAX package runs each search as one ``lax.scan`` or ``while_loop``;
here they are Python loops over forwards on the model's device:

* beam search prefills the prompt once at batch ``B``, repeats every cache
  entry to ``B·beam`` rows, and after each step reorders every entry by
  parent beam (an index with a tensor: a copy, never an alias of the cache
  the model then writes in place);
* speculative generation proposes ``k`` tokens with a draft model, checks
  them with one ``k + 1``-position forward of the target, and accepts per
  row; the loop's test is one host sync per round.

Under ``decode_attention="fused"`` every single-token step (beam steps,
draft proposals, the draft's backfill) runs the fused decode kernel; the
target's ``k + 1``-token verify chunk takes the layout-matched plain
attention, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from chainermn_tpu_torch.models.transformer import (
    TransformerLM,
    check_generation_length,
)

NEG = -1e30


def _top(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def penalized_scores(scores, lengths, length_penalty: float):
    """Length-penalized hypothesis score (the GNMT convention):
    ``sum_logprob / length**length_penalty``; ``0`` = the plain sum."""
    if length_penalty == 0.0:
        return scores
    return scores / lengths.clamp_min(1).to(torch.float32) ** length_penalty


def beam_step(scores, alive, lengths, logp, length_penalty: float,
              eos_id: Optional[int], pad_id: int):
    """One beam-search ranking step.

    ``scores``/``alive``/``lengths``: ``(B, K)`` running state; ``logp``
    ``(B, K, V)`` next-token log-probabilities.  With ``eos_id`` set,
    finished beams are forced to ``pad_id`` at log-probability 0 (score
    and length stop growing); ranking uses the length-penalized candidate
    score.  Returns ``(parent, nxt, scores, alive, lengths)`` with
    ``parent``/``nxt`` ``(B, K)``: the caller reorders its per-beam state
    by ``parent``.
    """
    B, K, V = logp.shape
    if eos_id is not None:
        frozen = torch.full((V,), NEG, device=logp.device)
        frozen[pad_id] = 0.0
        logp = torch.where(alive[..., None], logp, frozen)
    cand = scores[..., None] + logp  # (B, K, V)
    cand_len = lengths[..., None] + alive[..., None].to(lengths.dtype)
    rank = penalized_scores(cand, cand_len, length_penalty)
    _, idx = _top(rank.reshape(B, K * V), K)
    parent = idx // V
    nxt = idx % V
    scores = cand.reshape(B, K * V).gather(1, idx)
    lengths = cand_len[..., 0].gather(1, parent)
    alive = alive.gather(1, parent)
    if eos_id is not None:
        alive = alive & (nxt != eos_id)
    return parent, nxt.to(torch.int32), scores, alive, lengths


@torch.no_grad()
def lm_beam_search(model: TransformerLM, prompt, n_new: int, beam: int = 4,
                   eos_id: Optional[int] = None, length_penalty: float = 0.0,
                   pad_id: int = 0):
    """Beam-search ``n_new`` tokens after ``prompt`` (``(B, P)``,
    full-length rows).

    Scoring: the sum of token log-probabilities divided by
    ``length**length_penalty`` (0 = the plain sum).  Without ``eos_id``
    every hypothesis has length ``n_new`` and the penalty cancels in the
    ranking.  With ``eos_id`` a beam that emits it freezes: its later
    slots hold ``pad_id`` at log-probability 0, and its length counts the
    EOS.  The first step seeds the beams with each row's ``beam`` best
    distinct tokens; a beam wider than the vocabulary seeds the surplus at
    ``-1e30``, so their candidates always lose.

    Returns ``(tokens, scores)``: ``(B, n_new)`` int32 best-beam tokens and
    ``(B,)`` fp32 penalized scores, on the model's device.  ``beam=1`` is
    greedy :func:`~chainermn_tpu_torch.models.lm_generate`.
    """
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.long)
    B, P = prompt.shape
    if beam < 1:
        raise ValueError(f"beam must be >= 1, got {beam}")
    if n_new < 1:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                torch.zeros((B,), device=dev))
    total = check_generation_length(model, P, n_new)
    K = beam
    cache = model.init_cache(B, total)
    logits, cache = model(prompt, cache=cache, decode_pos=0)
    # Beam b·K + k continues row b: repeat every entry (int8 scales too).
    cache = [{n: c[n].repeat_interleave(K, dim=0) for n in c} for c in cache]
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)  # (B, V)
    V = logp0.shape[-1]
    k_seed = min(K, V)
    scores, tok = _top(logp0, k_seed)
    if k_seed < K:
        scores = torch.cat([scores, torch.full((B, K - k_seed), NEG,
                                               device=dev)], dim=1)
        tok = torch.cat([tok, torch.zeros((B, K - k_seed), dtype=tok.dtype,
                                          device=dev)], dim=1)
    tok = tok.to(torch.int32)
    alive = torch.ones((B, K), dtype=torch.bool, device=dev)
    if eos_id is not None:
        alive = tok != eos_id
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    toks_hist: List[torch.Tensor] = [tok]
    parents_hist: List[torch.Tensor] = []
    rows = torch.arange(B, device=dev)[:, None]
    for i in range(n_new - 1):
        logits, cache = model(tok.reshape(B * K, 1), cache=cache,
                              decode_pos=P + i)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1) \
            .reshape(B, K, V)
        parent, tok, scores, alive, lengths = beam_step(
            scores, alive, lengths, logp, length_penalty, eos_id, pad_id)
        flat_parent = (rows * K + parent).reshape(B * K)
        cache = reorder_cache(cache, flat_parent)
        toks_hist.append(tok)
        parents_hist.append(parent)
    final = penalized_scores(scores, lengths, length_penalty)
    best = final.argmax(dim=-1)  # the first maximum, as jnp.argmax
    ar = torch.arange(B, device=dev)
    # Backtrack the best beam per row through the parent pointers: the
    # token chosen at step t + 1, then that beam's step-t parent.
    beam_idx = best
    rev = []
    for t in range(n_new - 2, -1, -1):
        rev.append(toks_hist[t + 1][ar, beam_idx])
        beam_idx = parents_hist[t][ar, beam_idx]
    out = torch.stack([toks_hist[0][ar, beam_idx]] + rev[::-1], dim=1)
    if eos_id is not None:
        # Pad everything after the first EOS (the backtracked path holds
        # the EOS itself).
        hit = (out == eos_id).to(torch.int32)
        after = (hit.cumsum(dim=1) - hit) > 0
        out = torch.where(after, torch.full_like(out, pad_id), out)
    return out, final[ar, best]


def reorder_cache(cache, flat_parent: torch.Tensor):
    """Every entry of every layer's cache (``k``, ``v`` and, for an int8
    cache, their scales) gathered along the batch axis by
    ``flat_parent``: new tensors, so the model's in-place writes to the
    result never reach a parent's rows."""
    return [{n: c[n].index_select(0, flat_parent) for n in c} for c in cache]


def _sample(logits: torch.Tensor, generator: torch.Generator):
    """One categorical draw per row of ``(B, V)`` logits."""
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def lm_speculative_generate(model: TransformerLM, draft_model: TransformerLM,
                            prompt, n_new: int, k: int = 4,
                            temperature: float = 0.0,
                            generator: Optional[torch.Generator] = None):
    """Speculative decoding: the ``draft_model`` proposes ``k`` tokens one
    at a time, the target ``model`` scores them all in one ``k + 1``-position
    forward, and each row accepts its longest agreeing prefix plus the
    target's own token at the first disagreement (or the bonus token when
    all ``k`` agree).

    Greedy output is exactly the target's greedy generation in exact
    arithmetic; under finite precision the ``k + 1``-token verify chunk
    and the one-token step sum in different orders, so a near-tie in the
    target's argmax can resolve differently.  ``temperature > 0`` (needs
    ``generator``, a :class:`torch.Generator` on the model's device)
    samples the drafts and accepts each with probability ``min(1, p/q)``,
    resampling at the first rejection (:func:`speculative_accept`).

    Acceptance is per row: each row advances by its own accepted prefix
    through per-row cache positions; rounds run in lockstep until the
    slowest row is done, and finished rows compute on harmlessly into
    their cache headroom, masked out of the output.  Stale cache rows of
    rejected drafts are harmless: every position at or past the next
    round's start is rewritten before attention reads it.  The last
    proposal's K/V is the one row that rule misses (an all-accept round
    moves past it), so each round backfills it with one more draft
    forward; without it the draft attends a zero row and acceptance
    falls.

    Returns ``(tokens, target_forwards)``: ``(B, n_new)`` int32 tokens on
    the model's device and the number of sequential target forwards (the
    prefill and one verify per round; plain greedy costs ``n_new``).
    """
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).to(torch.long)
    B, P = prompt.shape
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) requires generator")
    if n_new < 1:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev), 0
    # The verify chunk reaches position P + n_new - 2 + k: a learned
    # position table needs k - 1 rows past the plain generation bound.
    for m, label in ((model, "model"), (draft_model, "draft_model")):
        if m.pos_enc == "learned" and P + n_new + k - 1 > m.max_len:
            raise ValueError(
                f"{label}: speculative verify needs P + n_new + k - 1 "
                f"(= {P + n_new + k - 1}) <= max_len ({m.max_len}); "
                "raise max_len, lower k, or use pos_enc='rope'"
            )
        check_generation_length(m, P, n_new)
    # Headroom: the last round may write k + 1 positions from
    # P + n_new - 2 on.
    cap = P + n_new + k + 1
    cache = model.init_cache(B, cap)
    dcache = draft_model.init_cache(B, cap)
    logits, cache = model(prompt, cache=cache, decode_pos=0)
    _, dcache = draft_model(prompt, cache=dcache, decode_pos=0)
    if sampling:
        tok0 = _sample(logits[:, -1].float() / temperature, generator)
    else:
        tok0 = logits[:, -1].argmax(dim=-1)
    # Padded by k + 1 so that no row's window write crosses the end.
    out = torch.zeros((B, n_new + k + 1), dtype=torch.long, device=dev)
    out[:, 0] = tok0
    filled = torch.ones((B,), dtype=torch.long, device=dev)
    last = tok0
    rounds = 0
    ar = torch.arange(k + 1, device=dev)
    while bool((filled < n_new).any()):  # one host sync per round
        pos = P + filled  # (B,) each row's next slot
        tok, drafts, dlogs = last, [], []
        for i in range(k):
            dlogits, dcache = draft_model(tok[:, None], cache=dcache,
                                          decode_pos=pos - 1 + i)
            dl = dlogits[:, 0].float()
            if sampling:
                dl = dl / temperature
                tok = _sample(dl, generator)
                dlogs.append(dl)
            else:
                tok = dl.argmax(dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # (B, k)
        # Backfill the last proposal's K/V at pos + k - 1 (logits unread).
        draft_model(drafts[:, -1:], cache=dcache, decode_pos=pos - 1 + k)
        chunk = torch.cat([last[:, None], drafts], dim=1)
        tlogits, cache = model(chunk, cache=cache, decode_pos=pos - 1)
        tlog = tlogits.float()
        if sampling:
            tokens, n_accept = speculative_accept(
                tlog / temperature, torch.stack(dlogs, dim=1), drafts,
                generator)
        else:
            tokens = tlog.argmax(dim=-1)  # (B, k + 1)
            agree = (tokens[:, :k] == drafts).to(torch.long)
            n_accept = agree.cumprod(dim=1).sum(dim=1)
        accepted = torch.minimum(n_accept + 1, n_new - filled)  # (B,) >= 0
        cols = filled[:, None] + ar
        keep = ar[None] < accepted[:, None]
        out.scatter_(1, cols, torch.where(keep, tokens, out.gather(1, cols)))
        last = tokens.gather(1, (accepted - 1).clamp_min(0)[:, None])[:, 0]
        filled = filled + accepted
        rounds += 1
    return out[:, :n_new].to(torch.int32), rounds + 1


def speculative_accept(p_logits: torch.Tensor, q_logits: torch.Tensor,
                       drafts: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
    """One round of the speculative-sampling accept rule (Leviathan et
    al. 2023).

    ``p_logits`` ``(B, k+1, V)``: target logits (temperature applied) for
    positions 0..k; ``q_logits`` ``(B, k, V)``: draft logits; ``drafts``
    ``(B, k)``: the draft's tokens, sampled from ``softmax(q)``.  Position
    ``i`` keeps its draft with probability ``min(1, p_i(x)/q_i(x))``; at
    the first rejection the token is resampled from
    ``normalize(max(p_i - q_i, 0))``; if all are kept the bonus token is
    sampled from ``p_k``.  Each emitted token is then exactly
    ``p``-distributed.

    Returns ``(tokens, n_accept)``: ``tokens`` ``(B, k+1)`` holds the kept
    drafts with each row's correction at index ``n_accept[row]`` (later
    positions are meaningless); ``n_accept`` ``(B,)`` in ``0..k``.
    """
    B, K1, V = p_logits.shape
    k = K1 - 1
    dev = p_logits.device
    p = torch.softmax(p_logits, dim=-1)
    q = torch.softmax(q_logits, dim=-1)
    u = torch.rand((B, k), generator=generator, device=dev)
    d = drafts.to(torch.long)[..., None]
    px = p[:, :k].gather(-1, d)[..., 0]
    qx = q.gather(-1, d)[..., 0]
    accept = u < torch.clamp(px / qx.clamp_min(1e-20), max=1.0)
    n_accept = accept.to(torch.long).cumprod(dim=1).sum(dim=1)
    # The residual at each row's first rejection (clamped for all-accept
    # rows, whose correction is the bonus token).
    rows = torch.arange(B, device=dev)
    ridx = n_accept.clamp_max(k - 1)
    pr, qr = p[rows, ridx], q[rows, ridx]
    resid = (pr - qr).clamp_min(0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    # p == q leaves no residual mass; fall back to p itself.
    resid = torch.where(rsum > 1e-12, resid / rsum.clamp_min(1e-20), pr)
    resample = torch.multinomial(resid, 1, generator=generator)[:, 0]
    bonus = _sample(p_logits[:, k], generator)
    correction = torch.where(n_accept == k, bonus, resample)
    tokens = torch.cat([drafts.to(torch.long), bonus[:, None]], dim=1)
    tokens[rows, n_accept] = correction
    return tokens, n_accept
