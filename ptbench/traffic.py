"""The one traffic generator: a mix file (`traffic/<mix>.json`) of
lengths, concurrency and engine sizing in, a stream of requests out.

Every seed serves the same work in another order.  A mix names a
`block` of requests; the block's prompt and output lengths are the
quantiles (i + 0.5) / block of their distributions, paired by a fixed
permutation, so that every block of consecutive requests holds the same
lengths.  The seed shuffles each block and draws the token ids (and the
shared prefix's, where the mix has one), so that two seeds give
different prompts and orders of the same sizes, and one seed the same
requests every time.

Length distributions (`"dist"`): ``lognormal`` (median, sigma, clipped
to [min, max]) and ``uniform`` (min to max).

A closed loop starts in its steady state (`Stream.first`): the first
`concurrency` requests are cut to the remaining outputs that
requests in flight have in steady state (the residual life of the
block's output lengths, P(r) proportional to the outputs of at least r
tokens, at its quantiles, in an order drawn from the seed), so that
completions come at the steady rate from the first step and the warm-up
need not wait a whole request's life.
"""
from __future__ import annotations

import json
import math
from statistics import NormalDist

import numpy as np

from . import HERE

PAIRING_SEED = 20240603     # fixes how prompt and output quantiles pair


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def quantile_lengths(spec: dict, n: int) -> list[int]:
    """The n lengths at quantiles (i + 0.5) / n of a length distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    us = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        z = [NormalDist().inv_cdf(u) for u in us]
        xs = [spec["median"] * math.exp(spec["sigma"] * zi) for zi in z]
    elif spec["dist"] == "uniform":
        xs = [lo + (hi - lo) * u for u in us]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(x)))) for x in xs]


def block_lengths(mix: dict) -> list[tuple[int, int]]:
    """The (prompt, output) lengths of one block, in the fixed pairing."""
    n = int(mix["block"])
    prompts = quantile_lengths(mix["prompt"], n)
    outs = quantile_lengths(mix["output"], n)
    perm = np.random.default_rng(PAIRING_SEED).permutation(n)
    return [(prompts[i], outs[j]) for i, j in enumerate(perm)]


def seed_bits(seed: int) -> int:
    """A run's seed as the non-negative 63-bit number both numpy and
    `torch.Generator.manual_seed` take."""
    return int(seed) % (1 << 63)


def residual_lengths(outs: list[int], n: int) -> list[int]:
    """The n quantiles (i + 0.5) / n of the residual output a request in
    flight still has in a closed loop's steady state: P(r) proportional to
    the number of outputs of at least r tokens, r = 1..max."""
    weight = np.array([sum(1 for o in outs if o >= r)
                       for r in range(1, max(outs) + 1)], float)
    cdf = np.cumsum(weight) / weight.sum()
    return [int(np.searchsorted(cdf, (i + 0.5) / n) + 1) for i in range(n)]


class Stream:
    """An endless stream of (prompt token ids int64, output length): block
    after block, each a fresh shuffle of `block_lengths`."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.pairs = block_lengths(mix)
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(seed_bits(seed))
        n_prefix = int(mix.get("shared_prefix", 0))
        self.prefix = self.rng.integers(0, self.vocab, n_prefix,
                                        dtype=np.int64)
        self._order: list[int] = []

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, int]:
        if not self._order:
            self._order = list(self.rng.permutation(len(self.pairs)))
        lp, lo = self.pairs[self._order.pop(0)]
        own = self.rng.integers(0, self.vocab, lp - len(self.prefix),
                                dtype=np.int64)
        return np.concatenate([self.prefix, own]), lo

    def first(self, n: int) -> list:
        """The n requests a closed loop of n clients starts with."""
        reqs = [next(self) for _ in range(n)]
        rest = residual_lengths([lo for _, lo in self.pairs], n)
        order = self.rng.permutation(n)
        return [(p, rest[order[i]]) for i, (p, _) in enumerate(reqs)]
