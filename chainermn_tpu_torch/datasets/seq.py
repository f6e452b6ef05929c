"""Sequence data for the seq2seq family: bucketing and padding to static
shapes, the on-disk translation corpus and the synthetic one.

A numpy copy of ``chainermn_tpu/datasets/seq.py`` with the same draws,
buckets and order, so both packages build identical batches from one
seed.  Each bucket shape is one batch signature: the captured train step
captures once per bucket, as the JAX package compiles once per bucket.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# Token sentinels (the seq2seq models and BLEU import these).
PAD = 0
BOS = 1
EOS = 2


def pad_to(arr: Sequence[int], length: int) -> np.ndarray:
    out = np.full(length, PAD, np.int32)
    out[: len(arr)] = arr
    return out


def bucket_batches(
    pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
    batch_size: int,
    bucket_width: int = 8,
    max_len: int = 64,
    seed: int = 0,
    drop_incomplete: bool = True,
    keep_tail: bool = False,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Group (src, tgt) token-id pairs into length buckets; return a list of
    ``(src_batch, tgt_batch)`` int32 arrays, each padded to its bucket
    ceiling.  Pairs longer than ``max_len`` are truncated (a target's
    trailing EOS kept).

    Tail policy for a bucket's final short chunk: drop it
    (``drop_incomplete=True``), wrap-fill with duplicates
    (``drop_incomplete=False``), or emit it short (``keep_tail=True``,
    overrides both) for evaluation that must see each sentence once."""
    rng = np.random.RandomState(seed)
    buckets: dict = {}
    for s, t in pairs:
        if len(s) > max_len or len(t) > max_len:
            trunc_t = list(t[:max_len])
            if len(t) > max_len and t[-1] == EOS:
                trunc_t[-1] = EOS
            s, t = s[:max_len], trunc_t
        key = (
            -(-max(len(s), 1) // bucket_width) * bucket_width,
            -(-max(len(t), 1) // bucket_width) * bucket_width,
        )
        buckets.setdefault(key, []).append((s, t))
    batches = []
    for (ls, lt), items in sorted(buckets.items()):
        order = rng.permutation(len(items))
        for i in range(0, len(items), batch_size):
            chunk = [items[j] for j in order[i : i + batch_size]]
            if len(chunk) < batch_size and not keep_tail:
                if drop_incomplete:
                    continue
                pool = [items[j] for j in order]
                need = batch_size - len(chunk)
                chunk += [pool[j % len(pool)] for j in range(need)]
            src = np.stack([pad_to(s, ls) for s, _ in chunk])
            tgt = np.stack([pad_to(t, lt) for _, t in chunk])
            batches.append((src, tgt))
    rng.shuffle(batches)
    return batches


def save_translation_npz(path, pairs) -> None:
    """Persist ragged (src, tgt) token-id pairs as a flat offsets-format
    ``.npz``: ``{src,tgt}_tokens`` concatenated int32 and
    ``{src,tgt}_offsets`` int64 prefix bounds."""
    src_tok = np.concatenate(
        [np.asarray(s, np.int32) for s, _ in pairs]
    ) if pairs else np.zeros(0, np.int32)
    tgt_tok = np.concatenate(
        [np.asarray(t, np.int32) for _, t in pairs]
    ) if pairs else np.zeros(0, np.int32)
    src_off = np.cumsum([0] + [len(s) for s, _ in pairs]).astype(np.int64)
    tgt_off = np.cumsum([0] + [len(t) for _, t in pairs]).astype(np.int64)
    np.savez(path, src_tokens=src_tok, src_offsets=src_off,
             tgt_tokens=tgt_tok, tgt_offsets=tgt_off)


def load_translation_npz(path) -> List[Tuple[List[int], List[int]]]:
    """Inverse of :func:`save_translation_npz`: the list of ``(src,
    tgt)`` token-id pairs."""
    with np.load(path) as d:
        st, so = d["src_tokens"], d["src_offsets"]
        tt, to = d["tgt_tokens"], d["tgt_offsets"]
    if len(so) != len(to):
        raise ValueError(
            f"src/tgt pair counts disagree: {len(so) - 1} vs {len(to) - 1}"
        )
    return [
        (st[so[i]:so[i + 1]].tolist(), tt[to[i]:to[i + 1]].tolist())
        for i in range(len(so) - 1)
    ]


def make_synthetic_translation(
    n: int = 2048,
    vocab: int = 50,
    min_len: int = 3,
    max_len: int = 24,
    seed: int = 0,
) -> List[Tuple[List[int], List[int]]]:
    """Deterministic learnable "translation": target = reversed source with
    a +1 shift inside the non-reserved vocab (PAD/BOS/EOS reserved),
    terminated with EOS so the decoder learns to stop."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        L = rng.randint(min_len, max_len + 1)
        src = rng.randint(3, vocab, size=L).tolist()
        tgt = [((w - 3 + 1) % (vocab - 3)) + 3 for w in reversed(src)] + [EOS]
        pairs.append((src, tgt))
    return pairs
