"""Bounded-uncertainty clocks (paper §2.2) and drift-bounded timers (§5.3).

``intervalNow()`` returns ``[earliest, latest]`` guaranteed to contain true
time for at least one moment during the call. The simulation knows true time
(the event loop clock) and perturbs it by per-call bounded errors, modeling
AWS TimeSync / clock-bound style interval clocks (<= ``max_clock_error``).

The two LeaseGuard age checks (paper §4.3):

* a node **knows** ``t1`` is *more than Δ old* iff
  ``t1.latest + Δ < intervalNow().earliest``    (commit gate — aggressive side)
* a lease holder may read only while its entry is **not possibly** more than
  Δ old: ``intervalNow().latest <= t1.latest + Δ``  (read gate — conservative
  side)

At any true moment at most one of the two can hold (earliest <= T <= latest),
which is exactly the disjointness the Case-2 proof needs.
"""

from __future__ import annotations

from dataclasses import dataclass

from .prob import PRNG
from .simulate import EventLoop


@dataclass(frozen=True, slots=True)
class TimeInterval:
    earliest: float
    latest: float

    def __post_init__(self) -> None:
        assert self.earliest <= self.latest


class BoundedClock:
    """Per-node interval clock with bounded, randomized uncertainty.

    Two distinct fault models (both driven by ``repro.faults``):

    * **honest skew/drift** (``set_skew``): the oscillator runs fast or
      slow, but the clock daemon *knows* it (as AWS TimeSync / clock-bound
      do) and widens the reported interval so it still contains true time.
      Safety is preserved by construction; the cost is availability — wider
      intervals make both LeaseGuard age checks more conservative.
    * **lying clock** (``faulty``/``fault_skew``): the *claimed* bounds are
      wrong — true time escapes the interval. This is the paper's §4.3
      caveat (linearizability is forfeit) and is used by adversarial tests
      to prove the checker catches the resulting stale reads.
    """

    __slots__ = ("loop", "prng", "max_error", "faulty", "fault_skew",
                 "skew", "drift_rate", "_drift_ref")

    def __init__(self, loop: EventLoop, prng: PRNG, max_error: float,
                 faulty: bool = False, fault_skew: float = 0.0) -> None:
        self.loop = loop
        self.prng = prng
        self.max_error = max_error
        self.faulty = faulty
        self.fault_skew = fault_skew
        # honest skew: offset + linear drift from the anchor time
        self.skew = 0.0
        self.drift_rate = 0.0
        self._drift_ref = 0.0

    def set_skew(self, skew: float, drift_rate: float = 0.0) -> None:
        """Install an honest offset (seconds) and drift (seconds/second),
        anchored at the current simulated time."""
        self.skew = skew
        self.drift_rate = drift_rate
        self._drift_ref = self.loop.now

    def clear_skew(self) -> None:
        self.skew = 0.0
        self.drift_rate = 0.0

    def _skew_now(self) -> float:
        s = self.skew
        if self.drift_rate:
            s += self.drift_rate * (self.loop.now - self._drift_ref)
        return s

    def interval_now(self) -> TimeInterval:
        t = self.loop.now
        if self.faulty:
            t = t + self.fault_skew  # true time now OUTSIDE claimed bounds
        lo = self.prng.uniform(0.0, self.max_error)
        hi = self.prng.uniform(0.0, self.max_error)
        s = self._skew_now()
        if s == 0.0:
            return TimeInterval(t - lo, t + hi)
        perceived = t + s
        # honest: report bounds wide enough to cover both the perceived and
        # the reference time, so true time stays inside the interval
        return TimeInterval(min(t, perceived) - lo, max(t, perceived) + hi)

    # -- the two asymmetric age checks ------------------------------------
    def definitely_older_than(self, t1: TimeInterval, delta: float) -> bool:
        """Commit gate: provably more than ``delta`` old."""
        return t1.latest + delta < self.interval_now().earliest

    def possibly_older_than(self, t1: TimeInterval, delta: float) -> bool:
        """Read gate: NOT safe to read iff possibly more than ``delta`` old."""
        return self.interval_now().latest > t1.latest + delta

    def lease_valid(self, t1: TimeInterval, delta: float) -> bool:
        return not self.possibly_older_than(t1, delta)
