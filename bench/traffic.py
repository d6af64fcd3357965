"""The one generator of traffic: a mix file's parameters and the seed give
the requests, the same for the same seed.

Prompt and answer lengths each follow a distribution that the mix names:
a log-normal with the ``mean`` and ``sigma`` of a published trace,
conditioned on the cell's ``range`` of lengths.  The draw is stratified,
as a variance aid: requests come in blocks of ``block``, prompt ``j`` of a
block lies at the midpoint of the ``j``-th of ``block`` equal slices of
the distribution's probability, paired with answer ``3 j mod block`` of
the answers' slices, and the seed draws the order of the pairs in each
block.  So every seed sends the same set of sizes in another order, and
any window of a few blocks holds the same work.  Token ids are uniform
over the vocabulary, drawn from the seed and the request's index.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int


def strata(spec: dict, n: int) -> np.ndarray:
    """The ``n`` lengths of a block: the midpoints, by probability, of
    ``n`` equal slices of a log-normal of mean ``spec["mean"]`` and shape
    ``spec["sigma"]`` (of the logarithm) conditioned on ``spec["range"]``."""
    lo, hi = spec["range"]
    sigma = spec["sigma"]
    dist = NormalDist(math.log(spec["mean"]) - sigma**2 / 2, sigma)
    a, b = dist.cdf(math.log(lo)), dist.cdf(math.log(hi))
    return np.array([round(math.exp(dist.inv_cdf(a + (b - a) * (j + 0.5) / n))) for j in range(n)], dtype=np.int64)


class Sessions:
    """Request ``i`` of a closed-loop mix.  The mix gives ``block``, and
    ``prompt`` and ``output`` (new tokens) each as ``{"mean", "sigma",
    "range"}``."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.block = int(mix["block"])
        if self.block % 3 == 0:
            raise ValueError("block must be prime to 3, so that the answers' pairing is a permutation")
        n = self.block
        self._prompts = strata(mix["prompt"], n)
        self._outs = strata(mix["output"], n)[[(3 * j) % n for j in range(n)]]
        self._blocks: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _block(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        if b not in self._blocks:
            order = np.random.default_rng([self.seed, b, 1]).permutation(self.block)
            self._blocks[b] = (self._prompts[order], self._outs[order])
        return self._blocks[b]

    def lengths(self, i: int) -> tuple[int, int]:
        prompts, outs = self._block(i // self.block)
        return int(prompts[i % self.block]), int(outs[i % self.block])

    def __getitem__(self, i: int) -> Request:
        s, out = self.lengths(i)
        rng = np.random.default_rng([self.seed, i, 2])
        return Request(i, rng.integers(0, self.vocab, size=s, dtype=np.int32), out)
