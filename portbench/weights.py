"""Seeds, weights and the half-way sizes every family shares.

Weights are made on the card from the run's seed in a few large calls:
one normal draw for every tensor that is initialised from a normal
distribution, scaled in place once per distinct standard deviation, and
ones or zeros for the rest.  The same seed on the same device gives the
same weights, so the reference makes its own copy again after the
window, from the seed, instead of taking anything from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: one spec of a weight: ``(name, shape, kind, std)``; kind is
#: ``normal``, ``ones`` or ``zeros`` (std unused for the last two).
Spec = Tuple[str, Tuple[int, ...], str, float]

STREAMS = {"weights": 1, "inputs": 2, "traffic": 3, "sample": 4}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of one stream (weights, inputs, traffic, sample) of
    a run, from ``--seed`` (any whole number)."""
    words = np.random.SeedSequence(
        [int(seed) & ((1 << 64) - 1), STREAMS[stream]]).generate_state(
        2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)


def numel(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


def make_weights(specs: List[Spec], seed: int, device, torch
                 ) -> Dict[str, "torch.Tensor"]:
    """``{name: fp32 tensor}`` on ``device`` for ``specs``, from the
    weights stream of ``seed``.  Normal tensors are views of one draw."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights"))
    normal = sorted((s for s in specs if s[2] == "normal"),
                    key=lambda s: s[3])
    total = sum(numel(s[1]) for s in normal)
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    out, at, std_at = {}, 0, {}
    for name, shape, _, std in normal:
        n = numel(shape)
        lo, _ = std_at.setdefault(std, [at, at])
        std_at[std] = [lo, at + n]
        out[name] = flat[at:at + n].view(shape)
        at += n
    for std, (lo, hi) in std_at.items():
        flat[lo:hi].mul_(std)
    for name, shape, kind, _ in specs:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind != "normal":
            raise ValueError(f"weight {name}: unknown init {kind!r}")
    return {name: out[name] for name, *_ in specs}
