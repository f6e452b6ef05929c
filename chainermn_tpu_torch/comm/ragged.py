"""Ragged (variable-length) point to point and reductions of the port
(``chainermn_tpu/comm/ragged.py``).

The reference's eager MPI ``send``/``recv`` took an array of another
length on every call.  The JAX package pads to a bucket, so the compiled
programs are bounded by the buckets touched, and sends the true lengths as
an int32 sideband.  The port keeps the contract: every rank pads its row
to the bucket of the longest row (``round_up_to_bucket``), so the buffers
on the wire, and a captured step's static shapes, take one shape per
bucket, and the receiver cuts the padding off exactly.

Each rank passes its own row (the JAX functions take every rank's row):
``ragged_permute(comm, row, perm)`` returns the row this rank received
(length 0 without an incoming edge), ``ragged_send`` one edge, and
``ragged_allreduce`` the elementwise sum of rows of different lengths,
each read as zeros past its end (the "variable-length all-reduce" that
BASELINE.json names for its seq2seq configuration; the JAX package has
no such function and its seq2seq example no such traffic).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

def round_up_to_bucket(n: int, bucket_width: int) -> int:
    """Smallest positive multiple of ``bucket_width`` >= ``n`` (a length-0
    row still occupies one bucket)."""
    if bucket_width < 1:
        raise ValueError(f"bucket_width must be >= 1, got {bucket_width}")
    return bucket_width * max(1, -(-n // bucket_width))


def _as_row(row: Any, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(row) if not isinstance(row, torch.Tensor)
                        else row)
    if t.dim() < 1:
        raise ValueError("a ragged row needs a (ragged) leading axis")
    return t.to(device)


def _padded(comm, row: torch.Tensor, bucket_width: int) -> Tuple[
        torch.Tensor, int]:
    """``row`` padded to the bucket of the longest row over the ranks,
    after checking that every rank's trailing shape and dtype agree."""
    sig = (tuple(row.shape[1:]), str(row.dtype))
    sigs = comm.allgather_obj((int(row.shape[0]), sig))
    for r, (_, s) in enumerate(sigs):
        if s != sig:
            raise ValueError(
                f"rank {r}'s row has trailing shape {s[0]} / dtype {s[1]}; "
                f"this rank's is {sig[0]} / {sig[1]} (only axis 0 may be "
                "ragged)")
    longest = max(n for n, _ in sigs)
    L = round_up_to_bucket(longest, bucket_width)
    out = row.new_zeros((L,) + tuple(row.shape[1:]))
    out[:row.shape[0]] = row
    return out, longest


def ragged_permute(comm, row: Any, perm: Sequence[Tuple[int, int]],
                   bucket_width: int = 128) -> torch.Tensor:
    """Move this rank's ``row`` (ragged in axis 0) along ``perm``
    (``[(src, dst), ...]``, each dst at most once); returns the row this
    rank received, exactly unpadded, or a length-0 row without an
    incoming edge.  One bucket-shaped permute carries the payload and one
    the length."""
    row = _as_row(row, comm.device)
    padded, _ = _padded(comm, row, bucket_width)
    lengths = torch.tensor([row.shape[0]], dtype=torch.int64,
                           device=comm.device)
    out = comm.permute(padded, perm)
    n = int(comm.permute(lengths, perm)[0])
    return out[:n]


def ragged_send(comm, row: Any, dest: int, source: int,
                bucket_width: int = 128) -> torch.Tensor:
    """One ragged edge ``source -> dest`` (the reference's eager
    ``send``/``recv`` pair).  Every rank calls it; ``row`` is read on
    ``source`` (pass a length-0 row of the same trailing shape
    elsewhere), and the result is the payload on ``dest``, a length-0 row
    elsewhere."""
    return ragged_permute(comm, row, [(source, dest)],
                          bucket_width=bucket_width)


def ragged_allreduce(comm, row: Any,
                     bucket_width: int = 128) -> torch.Tensor:
    """Elementwise sum over the ranks' rows of different lengths, each
    read as zeros past its end; the result is as long as the longest
    row, on every rank."""
    row = _as_row(row, comm.device)
    padded, longest = _padded(comm, row, bucket_width)
    return comm.allreduce(padded)[:longest]
