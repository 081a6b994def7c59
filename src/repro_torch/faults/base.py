"""Nemesis substrate: the Fault protocol, fault windows, and the Scenario
scheduler.

A :class:`Fault` is a reversible perturbation of the simulated cluster
(cut links, skew clocks, crash nodes, perturb messages). A
:class:`Scenario` is a declarative schedule of faults — each
:class:`Window` starts its fault at a relative time and (optionally)
stops it later — installed on the deterministic event loop, so a
(seed, scenario, policy) triple always replays the identical run.

``Scenario.install`` is compatible with ``run_workload(fault_script=...)``:
it is called once with the built cluster, just before the workload
starts, and schedules everything it needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ..core.runner import Cluster


class FaultContext:
    """What a fault may touch: the cluster plus deterministic helpers for
    picking victims. One context per installed scenario; it also keeps a
    trace of fault activations for tests and debugging."""

    def __init__(self, cluster: "Cluster") -> None:
        self.cluster = cluster
        self.trace: list[tuple[float, str]] = []

    # -- shorthands --------------------------------------------------------
    @property
    def loop(self):
        return self.cluster.loop

    @property
    def net(self):
        return self.cluster.net

    @property
    def nodes(self):
        return self.cluster.nodes

    def note(self, event: str) -> None:
        self.trace.append((self.loop.now, event))
        tr = self.loop.tracer
        if tr is not None:
            # the scheduler's "start <name>" / "stop <name>" notes become
            # structured fault windows in the trace
            if event.startswith("start "):
                tr.emit("fault", op="start", label=event[6:])
            elif event.startswith("stop "):
                tr.emit("fault", op="stop", label=event[5:])
            else:
                tr.emit("fault", op="note", label=event)

    # -- victim selection (deterministic given cluster state) --------------
    def ids(self) -> list[int]:
        return sorted(self.nodes)

    def leader(self):
        return self.cluster.leader()

    def leader_id(self) -> int:
        """The directory's current leader, or the lowest node id if no
        leader is known yet."""
        ldr = self.leader()
        return ldr.id if ldr is not None else self.ids()[0]

    def followers(self) -> list[int]:
        lid = self.leader_id()
        return [i for i in self.ids() if i != lid]

    def minority(self, with_leader: bool = False) -> list[int]:
        """A deterministic strict minority (⌊n/2⌋ nodes): the leader plus
        the lowest-id followers, or followers only."""
        k = len(self.ids()) // 2
        if with_leader:
            return ([self.leader_id()] + self.followers())[:k]
        return self.followers()[:k]

    def pick(self, scope: str) -> list[int]:
        """Resolve a victim scope name to node ids: ``leader``,
        ``followers``, ``minority`` (followers only), ``minority+leader``,
        or ``all``."""
        if scope == "leader":
            return [self.leader_id()]
        if scope == "followers":
            return self.followers()
        if scope == "minority":
            return self.minority()
        if scope == "minority+leader":
            return self.minority(with_leader=True)
        if scope == "all":
            return self.ids()
        raise ValueError(f"unknown victim scope {scope!r}")


class Fault:
    """Base class: a reversible perturbation. ``start`` applies it,
    ``stop`` undoes it; both run on the event loop at scheduled times.
    Instances are single-use (they carry undo state), so scenario
    factories build fresh ones per run."""

    name = "fault"

    def start(self, ctx: FaultContext) -> None:
        raise NotImplementedError

    def stop(self, ctx: FaultContext) -> None:
        pass


@dataclass
class Window:
    """Activate ``fault`` at ``at`` seconds after scenario install; stop it
    at ``until`` (None = leave active to the end of the run)."""

    fault: Fault
    at: float
    until: Optional[float] = None


class Scenario:
    """A named, declarative fault schedule over one run."""

    def __init__(self, name: str, windows: list[Window],
                 expect_safe: bool = True, description: str = "",
                 raft_overrides: Optional[dict] = None,
                 meta: Optional[dict] = None) -> None:
        self.name = name
        self.windows = windows
        #: True = inside the fault model every *consistent* policy claims
        #: to tolerate; the matrix asserts zero violations. False = exceeds
        #: the model (lying clocks, disk loss): violations are expected
        #: findings, not failures.
        self.expect_safe = expect_safe
        self.description = description
        #: RaftParams kwargs the scenario *requires* for its expect_safe
        #: classification to hold (e.g. corruption scenarios need
        #: ``entry_checksums=True``). Harnesses merge these on top of their
        #: per-policy config; scenarios with no overrides leave historical
        #: runs untouched.
        self.raft_overrides = dict(raft_overrides or {})
        #: free-form scenario annotations (e.g. flap duty cycle) for tests.
        self.meta = dict(meta or {})
        self.ctx: Optional[FaultContext] = None

    def install(self, cluster: "Cluster") -> FaultContext:
        """Schedule every window on the cluster's event loop (relative to
        now, i.e. to workload start). Compatible with
        ``run_workload(fault_script=scenario.install)``."""
        ctx = FaultContext(cluster)
        self.ctx = ctx
        self._schedule(ctx)
        return ctx

    def _schedule(self, ctx: FaultContext) -> None:
        """Schedule the windows against an already-built context.
        Subclasses (the fleet's :class:`~repro.fleet.faults.FleetScenario`)
        install a richer context and reuse this scheduler unchanged."""
        cluster = ctx.cluster
        for w in self.windows:
            def fire(w=w) -> None:
                ctx.note(f"start {w.fault.name}")
                w.fault.start(ctx)

            cluster.loop.call_later(w.at, fire)
            if w.until is not None:
                def cease(w=w) -> None:
                    ctx.note(f"stop {w.fault.name}")
                    w.fault.stop(ctx)

                cluster.loop.call_later(w.until, cease)

    def __repr__(self) -> str:
        return (f"Scenario({self.name!r}, {len(self.windows)} windows, "
                f"expect_safe={self.expect_safe})")
