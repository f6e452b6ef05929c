"""Sequence packing for fixed-shape LM training: several documents per
row, attention kept within each document by the flash kernels'
``segment_ids`` masking and positions restarting per document
(:class:`~chainermn_tpu_torch.models.TransformerLM` does this when given
``segment_ids``).  A numpy copy of ``chainermn_tpu/datasets/packing.py``
with the same layout, so both packages pack a corpus identically.

Layout per row: documents placed best-fit decreasing into ``seq_len``
slots, segment ids ``1, 2, ...`` per document, ``0`` for the padding
tail; targets are next-token within each document (a document's last
token and all padding get ``-1`` = ignore, ``lm_loss``'s contract).
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

import numpy as np


def pack_sequences(docs: Sequence[np.ndarray], seq_len: int,
                   drop_overlong: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack token documents into ``(tokens, targets, segment_ids)``, each
    ``(N, seq_len)`` int32.  Documents longer than ``seq_len`` are split
    into ``seq_len`` pieces (each its own segment, the true next-token
    target kept at the split) or, with ``drop_overlong``, dropped."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    pieces: List[Tuple[np.ndarray, np.ndarray]] = []
    for d in docs:
        d = np.asarray(d, np.int32).reshape(-1)
        if len(d) == 0:
            continue
        tgt = np.concatenate([d[1:], np.array([-1], np.int32)])
        if len(d) > seq_len:
            if drop_overlong:
                continue
            pieces.extend((d[i:i + seq_len], tgt[i:i + seq_len])
                          for i in range(0, len(d), seq_len))
        else:
            pieces.append((d, tgt))
    pieces.sort(key=lambda p: len(p[0]), reverse=True)
    rows: List[List[Tuple[np.ndarray, np.ndarray]]] = []
    free: List[Tuple[int, int]] = []  # sorted (free_space, row) pairs
    for p in pieces:
        L = len(p[0])
        j = bisect.bisect_left(free, (L, -1))
        if j < len(free):
            space, r = free.pop(j)
            rows[r].append(p)
            if space > L:
                bisect.insort(free, (space - L, r))
        else:
            rows.append([p])
            if seq_len > L:
                bisect.insort(free, (seq_len - L, len(rows) - 1))
    n = len(rows)
    tokens = np.zeros((n, seq_len), np.int32)
    targets = np.full((n, seq_len), -1, np.int32)
    seg = np.zeros((n, seq_len), np.int32)
    for r, row_docs in enumerate(rows):
        at = 0
        for s, (d, tg) in enumerate(row_docs, start=1):
            L = len(d)
            tokens[r, at:at + L] = d
            targets[r, at:at + L] = tg
            seg[r, at:at + L] = s
            at += L
    return tokens, targets, seg


def pack_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    src_len: int,
    tgt_len: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack (src, tgt) sentence pairs into fixed-shape rows for seq2seq.

    Pair *j* of a row gets the same segment id on both sides, so encoder
    self-attention isolates source sentences, decoder self-attention
    isolates target sentences, and cross-attention matches each target to
    exactly its own source (``TransformerSeq2Seq(..., src_seg, tgt_seg)``).
    A pair is placed only where both sides fit (best-fit decreasing on the
    combined length); pairs overlong on either side are dropped.

    Returns ``(src, tgt, src_seg, tgt_seg)``, each ``(N, {src,tgt}_len)``
    int32; padding is token 0 with segment id 0.
    """
    usable = []
    for s, t in pairs:
        s = np.asarray(s, np.int32).reshape(-1)
        t = np.asarray(t, np.int32).reshape(-1)
        if 0 < len(s) <= src_len and 0 < len(t) <= tgt_len:
            usable.append((s, t))
    usable.sort(key=lambda p: len(p[0]) + len(p[1]), reverse=True)
    rows: List[List[Tuple[np.ndarray, np.ndarray]]] = []
    space: List[Tuple[int, int]] = []  # per-row (src_free, tgt_free)
    for s, t in usable:
        best, best_slack = None, None
        for r, (fs, ft) in enumerate(space):
            if len(s) <= fs and len(t) <= ft:
                slack = (fs - len(s)) + (ft - len(t))
                if best is None or slack < best_slack:
                    best, best_slack = r, slack
        if best is None:
            rows.append([(s, t)])
            space.append((src_len - len(s), tgt_len - len(t)))
        else:
            rows[best].append((s, t))
            fs, ft = space[best]
            space[best] = (fs - len(s), ft - len(t))

    n = len(rows)
    src = np.zeros((n, src_len), np.int32)
    tgt = np.zeros((n, tgt_len), np.int32)
    sseg = np.zeros((n, src_len), np.int32)
    tseg = np.zeros((n, tgt_len), np.int32)
    for r, row_pairs in enumerate(rows):
        at_s = at_t = 0
        for j, (s, t) in enumerate(row_pairs, start=1):
            src[r, at_s:at_s + len(s)] = s
            sseg[r, at_s:at_s + len(s)] = j
            at_s += len(s)
            tgt[r, at_t:at_t + len(t)] = t
            tseg[r, at_t:at_t + len(t)] = j
            at_t += len(t)
    return src, tgt, sseg, tseg


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of non-padding slots (segment id != 0)."""
    seg = np.asarray(segment_ids)
    return float((seg != 0).mean()) if seg.size else 0.0
