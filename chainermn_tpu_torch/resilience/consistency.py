"""Cross-rank consistency voting of the port
(``chainermn_tpu/resilience/consistency.py``): catch fail-silent
divergence.

Data parallelism rests on one invariant: after every step, every rank's
parameters are bit-identical.  A bad core, silent memory corruption or a
non-deterministic kernel on one host breaks it without a crash.  At a
configurable cadence every rank here digests its state
(:func:`tree_digest`), the digests cross the object plane in one
``allgather_obj`` (:func:`exchange_digests`), and a majority vote
(:func:`majority_vote`) names the ranks that disagree with the majority
in a :class:`RankDivergedError` (a :class:`PeerFailedError` of
``kind="diverged"``).  Without a strict majority (two ranks, an even
split) the vote cannot say who is wrong (``VoteResult.no_majority``).

The digest covers replicated state only (the
:class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` tier): ZeRO's
shards differ per rank by design.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from chainermn_tpu_torch.resilience.detector import PeerFailedError


class RankDivergedError(PeerFailedError):
    """A replica's digest disagrees with the majority's.

    ``peer`` is the lowest divergent rank (all of them in ``divergent``),
    ``op`` the protocol step, ``kind="diverged"``.  When the vote could
    not localize the fault, ``peer`` is -1 and ``no_majority`` is True:
    every replica is a suspect."""

    def __init__(self, divergent: Sequence[int], step: int,
                 rank: Optional[int] = None, no_majority: bool = False,
                 op: str = "consistency_vote"):
        self.divergent = sorted(int(r) for r in divergent)
        self.step = int(step)
        self.no_majority = bool(no_majority)
        peer = self.divergent[0] if (self.divergent and not no_majority) \
            else -1
        reason = (f"no majority at step {step}: replicas split with no "
                  "quorum" if no_majority else
                  f"rank(s) {self.divergent} diverged from the majority "
                  f"digest at step {step}")
        super().__init__(peer, op=op, rank=rank, reason=reason,
                         kind="diverged")


# --------------------------------------------------------------------- digest
def _leaves(tree: Any):
    """``(name, array)`` of every leaf of ``tree``, in order: a module's
    ``named_parameters()``, a dict's items (nested dicts flattened with
    dotted names), a sequence's entries by index, or one array."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            for n, leaf in _leaves(v):
                yield (f"{k}.{n}" if n else str(k)), leaf
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for n, leaf in _leaves(v):
                yield (f"{i}.{n}" if n else str(i)), leaf
    elif tree is not None:
        yield "", tree


def _host_array(leaf):
    """``(dtype name, host array)`` of a leaf: numpy's name (a tensor and
    the equal array digest alike), ``bfloat16``'s raw 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            return "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return a.dtype.str, a


def tree_digest(tree: Any, algo: str = "blake2b",
                digest_size: int = 16) -> str:
    """A content digest of ``tree`` (a module, whose parameters are
    taken in ``named_parameters()`` order, or a dict or sequence of
    tensors and arrays): blake2b over each leaf's name, dtype and shape,
    then its raw bytes.  Equal state gives an equal digest on every rank;
    one flipped bit anywhere changes it.  One host read of the state."""
    h = hashlib.new(algo, digest_size=digest_size)
    for i, (name, leaf) in enumerate(_leaves(tree)):
        dtype, a = _host_array(leaf)
        h.update(f"[{i}]{name}:{dtype}{tuple(a.shape)}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ----------------------------------------------------------------------- vote
@dataclass
class VoteResult:
    """The outcome of one consistency vote over ``size`` ranks."""

    step: int
    #: digest -> the ranks that reported it (sorted).
    groups: Dict[str, List[int]]
    #: the quorum digest, or None without a strict majority.
    majority: Optional[str] = None
    #: ranks whose digest differs from the majority's.
    divergent: List[int] = field(default_factory=list)
    #: True when no digest reached a strict majority: the fault cannot
    #: be localized.
    no_majority: bool = False

    @property
    def clean(self) -> bool:
        return not self.divergent and not self.no_majority

    def raise_if_diverged(self, rank: Optional[int] = None) -> None:
        """Raise an attributed :class:`RankDivergedError` on a dirty
        vote."""
        if self.clean:
            return
        raise RankDivergedError(self.divergent, self.step, rank=rank,
                                no_majority=self.no_majority)

    def describe(self) -> str:
        if self.clean:
            return (f"vote@{self.step}: clean "
                    f"({len(self.groups[self.majority])} ranks agree)")
        if self.no_majority:
            sizes = {d[:8]: rs for d, rs in self.groups.items()}
            return f"vote@{self.step}: NO MAJORITY, split {sizes}"
        total = sum(len(r) for r in self.groups.values())
        return (f"vote@{self.step}: rank(s) {self.divergent} diverged from "
                f"majority ({len(self.groups[self.majority])}/{total})")


def majority_vote(digests: Sequence[str], step: int = 0) -> VoteResult:
    """The majority vote over per-rank digests (index = rank): a digest
    held by more than half the ranks wins and every other rank is
    divergent; without one (two ranks that disagree, an even split) the
    result is ``no_majority`` and every rank a suspect."""
    groups: Dict[str, List[int]] = {}
    for r, d in enumerate(digests):
        groups.setdefault(d, []).append(r)
    size = len(digests)
    if not size:
        raise ValueError("majority_vote needs at least one digest")
    best = max(groups, key=lambda d: len(groups[d]))
    if len(groups[best]) * 2 > size:
        divergent = sorted(r for d, rs in groups.items() if d != best
                           for r in rs)
        return VoteResult(step=step, groups=groups, majority=best,
                          divergent=divergent)
    if len(groups) == 1:
        return VoteResult(step=step, groups=groups, majority=best)
    return VoteResult(step=step, groups=groups, majority=None,
                      divergent=sorted(range(size)), no_majority=True)


# ------------------------------------------------------------------- exchange
def exchange_digests(comm, digest: str, step: int) -> List[str]:
    """``allgather_obj`` of ``(step, digest)`` over ``comm`` (a
    communicator or a :class:`~chainermn_tpu_torch.hostcomm.HostComm`);
    returns the digests by rank.  Ranks voting at different steps is a
    protocol error and raises."""
    pairs = comm.allgather_obj((int(step), digest))
    steps = {int(s) for s, _ in pairs}
    if len(steps) != 1:
        raise RuntimeError(
            f"consistency vote desynchronized: ranks voted at steps "
            f"{sorted(steps)} (vote cadence must be identical on every "
            "rank)")
    return [d for _, d in pairs]


def exchange_and_vote(comm, tree: Any, step: int) -> VoteResult:
    """Digest ``tree``, exchange the digests and vote: one
    ``allgather_obj`` of a few dozen bytes per rank."""
    local = tree_digest(tree)
    if comm is None or getattr(comm, "size", 1) <= 1:
        return VoteResult(step=step, groups={local: [0]}, majority=local)
    return majority_vote(exchange_digests(comm, local, step), step=step)
