"""The one traffic generator: requests from a traffic file and a seed.

Sizes do not depend on the seed.  The requests come in rounds of
``round`` requests, and every round holds the same sizes: prompt lengths
and output lengths at the lognormal distributions' quantiles ``(j + 0.5)
/ round`` (the published ``median`` times the file's ``scale``, ``sigma``
of the natural log, at least ``min``), paired by a fixed permutation,
each prompt cut so that prompt and output fit ``max_total`` positions.
The seed orders each round and draws every prompt's token ids, so every
seed sends the same work, round by round, in another order.  A run's
requests are ``requests`` long; request ``k`` is number ``k mod
requests``.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

from portbench.weights import sub_seed


def quantiles(n: int, spec: dict, scale: float) -> np.ndarray:
    z = NormalDist()
    vals = [math.exp(math.log(spec["median"] * scale)
                     + spec["sigma"] * z.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    return np.maximum(np.rint(vals), spec["min"]).astype(np.int64)


def sizes(traffic: dict) -> List[Tuple[int, int]]:
    """``(prompt length, output length)`` of the requests of one round,
    the same for every seed."""
    n, scale = traffic["round"], traffic["scale"]
    prompts = quantiles(n, traffic["prompt"], scale)
    outputs = quantiles(n, traffic["output"], scale)[
        np.random.RandomState(0).permutation(n)]
    cap = traffic["max_total"]
    return [(int(min(p, cap - o)), int(o)) for p, o in zip(prompts, outputs)]


class Requests:
    """The requests of one run: ``request(k) -> (prompt ids, output
    length)``."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        rng = np.random.RandomState(sub_seed(seed, "traffic") % (1 << 32))
        one = sizes(traffic)
        self.order = [one[i] for _ in range(traffic["requests"] // len(one))
                      for i in rng.permutation(len(one))]
        ids = rng.randint(0, vocab, size=sum(p for p, _ in self.order))
        ends = np.cumsum([p for p, _ in self.order])
        self.prompts = np.split(ids.astype(np.int64), ends[:-1])

    def request(self, k: int) -> Tuple[List[int], int]:
        i = k % len(self.order)
        return self.prompts[i].tolist(), self.order[i][1]
