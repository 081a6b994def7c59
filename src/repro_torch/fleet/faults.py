"""Data-plane faults, composable with the control-plane nemesis.

:class:`FleetContext` extends the nemesis :class:`FaultContext` with the
fleet, so ONE scenario's window list can mix data-plane faults (below)
with any fault from :mod:`repro.faults.library` — ``CrashRestart`` the
Raft leader in the same window that ``CheckpointStorm`` floods commits,
and both fire off the shared deterministic schedule.

Victim scopes for data-plane faults (resolved at activation time, like
the nemesis's node scopes):

* ``chief`` — whoever is chief right now;
* ``workers:K`` — the K highest-index live non-chief workers;
* ``fraction:P`` — the ceil(P·n) highest-index live non-chief workers
  (highest-index so the min-index chief-succession line is perturbed by
  ``chief``/``ChiefKill`` deliberately, not as a side effect);
* ``all`` — every live worker;
* an explicit worker id (``w3``).
"""

from __future__ import annotations

import math
from typing import Optional

from ..faults.base import Fault, FaultContext, Scenario
from .sim import Fleet
from .worker import Worker


class FleetContext(FaultContext):
    def __init__(self, cluster, fleet: Fleet) -> None:
        super().__init__(cluster)
        self.fleet = fleet

    def live_fleet(self) -> list[Worker]:
        return [w for w in self.fleet.ordered_workers() if w.alive]

    def chief(self) -> Optional[Worker]:
        for w in self.fleet.ordered_workers():
            if w.alive and w.is_chief:
                return w
        return None

    def pick_fleet(self, scope: str) -> list[str]:
        live = self.live_fleet()
        if scope == "all":
            return [w.wid for w in live]
        if scope == "chief":
            chief = self.chief()
            return [chief.wid] if chief is not None else []
        rest = [w for w in live if not w.is_chief]
        if scope.startswith("workers:"):
            k = int(scope.split(":", 1)[1])
            return [w.wid for w in rest[-k:]] if k else []
        if scope.startswith("fraction:"):
            frac = float(scope.split(":", 1)[1])
            k = math.ceil(frac * len(self.fleet.workers))
            return [w.wid for w in rest[-k:]] if k else []
        if scope in self.fleet.workers:
            return [scope] if self.fleet.workers[scope].alive else []
        raise ValueError(f"unknown fleet victim scope {scope!r}")


class FleetScenario(Scenario):
    """A scenario whose windows may contain data-plane faults. Installed
    with the fleet in scope; the window scheduler is the nemesis's own."""

    def install(self, cluster) -> FaultContext:
        raise RuntimeError(
            "FleetScenario needs the fleet: use install_fleet(cluster, fleet)")

    def install_fleet(self, cluster, fleet: Fleet) -> FleetContext:
        ctx = FleetContext(cluster, fleet)
        self.ctx = ctx
        self._schedule(ctx)
        return ctx


# ------------------------------------------------------------ the faults
class WorkerCrash(Fault):
    """Crash the scope's workers; each restarts (re-registers, restores
    from the latest valid manifest) ``downtime`` later."""

    def __init__(self, scope: str = "fraction:0.3",
                 downtime: float = 0.5) -> None:
        self.scope = scope
        self.downtime = downtime
        self.name = f"worker_crash[{scope}]"

    def start(self, ctx: FleetContext) -> None:
        for wid in ctx.pick_fleet(self.scope):
            ctx.fleet.crash_worker(wid, downtime=self.downtime)


class WorkerStraggler(Fault):
    """Slow the scope's workers by ``factor`` for the window — the
    registry's straggler table should flag them, and unflag on stop."""

    def __init__(self, scope: str = "fraction:0.25",
                 factor: float = 4.0) -> None:
        self.scope = scope
        self.factor = factor
        self.name = f"worker_straggler[{scope},x{factor}]"
        self._victims: list[str] = []

    def start(self, ctx: FleetContext) -> None:
        self._victims = ctx.pick_fleet(self.scope)
        for wid in self._victims:
            ctx.fleet.workers[wid].slowdown = self.factor
            ctx.note(f"straggler {wid} x{self.factor}")

    def stop(self, ctx: FleetContext) -> None:
        for wid in self._victims:
            ctx.fleet.workers[wid].slowdown = 1.0
        self._victims = []


class ChiefKill(Fault):
    """Kill the chief. One-shot by default (retrying until a chief
    exists); with ``period`` it chases every newly elected chief, one
    strike per (worker, epoch) — the fleet's LeaderNemesis."""

    def __init__(self, downtime: float = 0.6,
                 period: Optional[float] = None) -> None:
        self.downtime = downtime
        self.period = period
        mode = "once" if period is None else f"p={period}"
        self.name = f"chief_kill[{mode}]"
        self._active = False
        self._struck: set = set()

    def start(self, ctx: FleetContext) -> None:
        self._active = True
        self._struck = set()
        self._tick(ctx)

    def _tick(self, ctx: FleetContext) -> None:
        if not self._active or not ctx.fleet.running:
            return
        chief = ctx.chief()
        if chief is not None and (chief.wid, chief.epoch) not in self._struck:
            self._struck.add((chief.wid, chief.epoch))
            ctx.note(f"chief_kill strikes {chief.wid} (epoch {chief.epoch})")
            ctx.fleet.crash_worker(chief.wid, downtime=self.downtime)
            if self.period is None:
                self._active = False
                return
        # one-shot mode keeps probing until it lands a strike
        ctx.loop.call_later(self.period if self.period is not None else 0.1,
                            lambda: self._tick(ctx))

    def stop(self, ctx: FleetContext) -> None:
        self._active = False


class CheckpointStorm(Fault):
    """Chief commits a manifest every ``every`` steps for the window —
    maximal write pressure on the coordinator, and the window in which a
    Raft-leader crash is most likely to catch a commit in flight."""

    def __init__(self, every: int = 1) -> None:
        self.every = every
        self.name = f"checkpoint_storm[every={every}]"

    def start(self, ctx: FleetContext) -> None:
        ctx.fleet.ckpt_override = self.every

    def stop(self, ctx: FleetContext) -> None:
        ctx.fleet.ckpt_override = None
