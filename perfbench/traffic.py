"""The general generator of the traffic mixes (``perfbench/traffic/*.json``).

Every draw comes from ``--seed``. Where a size or a gap shapes the work
(prompt and answer lengths, arrival gaps, which shared prompt a request
takes), every seed gets the same multiset of values in another order, so
that two seeds do the same amount of work: lengths are spread evenly over
their range, arrival gaps are the quantiles of the exponential
distribution of the mix's rate (a Poisson process's gaps), and shared
prompts are taken equally often. Token and pixel contents are drawn
freely.
"""
from __future__ import annotations

import math

import numpy as np

# one stream per use, so that adding a use does not move the others
STREAMS = {"arrivals": 1, "lengths": 2, "tokens": 3, "choice": 4,
           "sample": 5, "answers": 6, "markov": 7}


def rng(seed: int, use: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, STREAMS[use]])


def spread_ints(n: int, lo: int, hi: int, gen: np.random.Generator
                ) -> np.ndarray:
    """``n`` integers spread evenly over [lo, hi], in a seeded order."""
    vals = np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n)
    return gen.permutation(np.minimum(vals, hi).astype(np.int64))


def balanced(n: int, k: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` picks among ``k`` choices, each as often as ``n`` allows, in
    a seeded order."""
    return gen.permutation(np.arange(n) % k)


def poisson_arrivals(rate: float, seconds: float, gen: np.random.Generator
                     ) -> np.ndarray:
    """Due times in [0, seconds) of a Poisson process of ``rate`` a
    second: ``floor(rate·seconds)`` gaps, the quantiles of the exponential
    distribution, in a seeded order. The same gaps for every seed, so
    every seed offers the same load; only their order differs."""
    n = int(math.floor(rate * seconds))
    if n < 1:
        return np.zeros(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(gen.permutation(gaps))
    return due[due < seconds]


def tokens(gen: np.random.Generator, n: int, vocab: int) -> list[int]:
    return [int(t) for t in gen.integers(0, vocab, size=n)]


def markov_rows(gen: np.random.Generator, n: int, seq: int,
                vocab: int) -> np.ndarray:
    """Order-2 Markov rows: t⁺ = (3·t + 5·t⁻ + e) mod vocab with e in
    {0, 1, 2} at p = (.7, .2, .1); copied from the port's
    ``utils/lm_bench.py:_markov_corpus``, driven by the seed."""
    out = np.zeros((n, seq), np.int64)
    out[:, 0] = gen.integers(0, vocab, size=n)
    out[:, 1] = gen.integers(0, vocab, size=n)
    noise = gen.choice(3, size=(n, seq), p=[0.7, 0.2, 0.1])
    for i in range(2, seq):
        out[:, i] = (3 * out[:, i - 1] + 5 * out[:, i - 2]
                     + noise[:, i]) % vocab
    return out


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q ≤ 100); ``inf`` values
    (requests never served) rank last."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
