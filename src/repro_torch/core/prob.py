"""Seeded pseudorandom distributions (paper §6.1, ``prob.py``).

All nondeterminism in the simulation flows through one :class:`PRNG`, so a
(seed, params) pair reproduces the identical event sequence.
"""

from __future__ import annotations

import math
import random
from typing import Sequence


class PRNG:
    def __init__(self, seed: int) -> None:
        self._r = random.Random(seed)

    def fork(self, salt: int) -> "PRNG":
        """Derive an independent stream (per node / per subsystem)."""
        return PRNG(self._r.randrange(2**63) ^ (salt * 0x9E3779B97F4A7C15) % 2**63)

    def uniform(self, lo: float, hi: float) -> float:
        return self._r.uniform(lo, hi)

    def randint(self, lo: int, hi: int) -> int:
        return self._r.randint(lo, hi)

    def choice(self, xs: Sequence):
        return self._r.choice(xs)

    def shuffle(self, xs: list) -> None:
        self._r.shuffle(xs)

    def random(self) -> float:
        return self._r.random()

    def exponential(self, mean: float) -> float:
        """Interarrival times of a Poisson process with the given mean gap."""
        return self._r.expovariate(1.0 / mean) if mean > 0 else 0.0

    def lognormvariate(self, mu: float, sigma: float) -> float:
        """Raw lognormal draw from precomputed underlying-normal params —
        the hot-path twin of :meth:`lognormal_mean_var` (same stream)."""
        return self._r.lognormvariate(mu, sigma)

    def lognormal_mean_var(self, mean: float, variance: float) -> float:
        """Lognormal sample parameterized by its own mean/variance.

        The paper (§6.4) uses lognormal network latencies "with variance equal
        to the mean"; we convert (mean, var) to the underlying normal's
        (mu, sigma).
        """
        if mean <= 0:
            return 0.0
        sigma2 = math.log(1.0 + variance / (mean * mean))
        mu = math.log(mean) - sigma2 / 2.0
        return self._r.lognormvariate(mu, math.sqrt(sigma2))


class Zipf:
    """Zipf(a) over {0..n-1} via inverse-CDF table (paper §6.6, a in [0, 2])."""

    def __init__(self, n: int, a: float) -> None:
        weights = [1.0 / (k + 1) ** a for k in range(n)]
        total = sum(weights)
        self.cdf: list[float] = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self.cdf.append(acc)
        self.cdf[-1] = 1.0

    def sample(self, prng: PRNG) -> int:
        u = prng.random()
        # binary search
        lo, hi = 0, len(self.cdf) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.cdf[mid] < u:
                lo = mid + 1
            else:
                hi = mid
        return lo
