"""The fault library: every perturbation the nemesis engine can apply.

Network faults build on ``Network``'s directional cuts and
:class:`~repro.core.network.MessageFault` rules; clock faults on
``BoundedClock.set_skew`` (honest) and ``faulty`` (lying); process faults
on ``Node.crash``/``Node.restart(wipe_disk=...)``.

Victim selection goes through ``FaultContext.pick(scope)`` and is
resolved at *activation* time, so e.g. ``scope="leader"`` targets
whoever leads when the window opens — and :class:`LeaderNemesis`
re-resolves on every firing, chasing each newly elected leader.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..core.network import MessageFault
from ..core.prob import PRNG
from ..core.raft import AppendEntries
from .base import Fault, FaultContext


# ---------------------------------------------------------------- partitions
class _PartitionFault(Fault):
    """Shared undo bookkeeping: subclasses cut directed links via
    ``_cut``; ``stop`` heals exactly what was cut."""

    def __init__(self) -> None:
        self._cuts: list[tuple[int, int]] = []

    def _cut(self, ctx: FaultContext, src: int, dst: int) -> None:
        ctx.net.partition_oneway(src, dst)
        self._cuts.append((src, dst))

    def _cut_pair(self, ctx: FaultContext, a: int, b: int) -> None:
        self._cut(ctx, a, b)
        self._cut(ctx, b, a)

    def stop(self, ctx: FaultContext) -> None:
        for src, dst in self._cuts:
            ctx.net.heal_oneway(src, dst)
        self._cuts.clear()


class IsolateLeader(_PartitionFault):
    """Cut the current leader off from everyone. ``direction``:

    * ``both`` — classic symmetric isolation;
    * ``out``  — the leader can hear but not be heard (followers miss
      heartbeats and elect; the deposed leader learns of it);
    * ``in``   — the leader can be heard but hears nothing (followers stay
      quiet, the leader cannot commit: an availability trap).
    """

    def __init__(self, direction: str = "both") -> None:
        super().__init__()
        assert direction in ("both", "in", "out"), direction
        self.direction = direction
        self.name = f"isolate_leader[{direction}]"

    def start(self, ctx: FaultContext) -> None:
        vid = ctx.leader_id()
        for other in ctx.ids():
            if other == vid:
                continue
            if self.direction in ("both", "out"):
                self._cut(ctx, vid, other)
            if self.direction in ("both", "in"):
                self._cut(ctx, other, vid)


class MajorityMinority(_PartitionFault):
    """Split the cluster into two sides; ``leader_in_minority`` puts the
    leader on the losing side (the classic failover-forcing split)."""

    def __init__(self, leader_in_minority: bool = True) -> None:
        super().__init__()
        self.leader_in_minority = leader_in_minority
        side = "minority" if leader_in_minority else "majority"
        self.name = f"majority_minority[leader_in_{side}]"

    def start(self, ctx: FaultContext) -> None:
        if self.leader_in_minority:
            minority = set(ctx.minority(with_leader=True))
        else:
            minority = set(ctx.minority(with_leader=False))
        for a in ctx.ids():
            for b in ctx.ids():
                if a < b and (a in minority) != (b in minority):
                    self._cut_pair(ctx, a, b)


class PartialPartition(_PartitionFault):
    """Cut a single follower-follower link: both endpoints still see the
    rest of the cluster (the Cloudflare-outage topology that traps naive
    Raft implementations in election loops)."""

    name = "partial_partition"

    def start(self, ctx: FaultContext) -> None:
        followers = ctx.followers()
        if len(followers) >= 2:
            self._cut_pair(ctx, followers[0], followers[1])


class OneWayLink(_PartitionFault):
    """Cut exactly one directed link between the two lowest followers."""

    name = "oneway_link"

    def start(self, ctx: FaultContext) -> None:
        followers = ctx.followers()
        if len(followers) >= 2:
            self._cut(ctx, followers[0], followers[1])


# -------------------------------------------------------------- clock faults
class ClockSkew(Fault):
    """Per-node clock skew/drift. Honest by default (bounds widen, safety
    holds, availability degrades); ``lie=True`` makes the clock claim its
    normal tight bounds while actually being off — the §4.3 fault model
    breach that forfeits linearizability."""

    def __init__(self, skew: float, drift_rate: float = 0.0,
                 scope: str = "minority", lie: bool = False) -> None:
        self.skew = skew
        self.drift_rate = drift_rate
        self.scope = scope
        self.lie = lie
        kind = "lying" if lie else "honest"
        self.name = f"clock_skew[{kind},{scope}]"
        self._victims: list[int] = []

    def start(self, ctx: FaultContext) -> None:
        self._victims = ctx.pick(self.scope)
        for nid in self._victims:
            clock = ctx.nodes[nid].clock
            if self.lie:
                clock.faulty = True
                clock.fault_skew = self.skew
            else:
                clock.set_skew(self.skew, self.drift_rate)

    def stop(self, ctx: FaultContext) -> None:
        for nid in self._victims:
            clock = ctx.nodes[nid].clock
            if self.lie:
                clock.faulty = False
                clock.fault_skew = 0.0
            else:
                clock.clear_skew()
        self._victims = []


# ------------------------------------------------------------ process faults
class CrashRestart(Fault):
    """Crash the scope's nodes, restart them ``downtime`` later. With
    ``wipe_disk`` the restart loses persistent state (term/vote/log) —
    beyond Raft's fault model, hence only in unsafe scenarios."""

    def __init__(self, scope: str = "leader", downtime: float = 0.3,
                 wipe_disk: bool = False) -> None:
        self.scope = scope
        self.downtime = downtime
        self.wipe_disk = wipe_disk
        wipe = ",wipe" if wipe_disk else ""
        self.name = f"crash_restart[{scope}{wipe}]"
        self._down: list[int] = []

    def start(self, ctx: FaultContext) -> None:
        for nid in ctx.pick(self.scope):
            node = ctx.nodes[nid]
            if not node.alive:
                continue
            node.crash()
            self._down.append(nid)
            ctx.loop.call_later(
                self.downtime, lambda n=node: self._restart(ctx, n))

    def _restart(self, ctx: FaultContext, node) -> None:
        if not node.alive:
            node.restart(wipe_disk=self.wipe_disk)
            ctx.note(f"restarted node {node.id}"
                     f"{' (disk wiped)' if self.wipe_disk else ''}")
        if node.id in self._down:
            self._down.remove(node.id)

    def stop(self, ctx: FaultContext) -> None:
        # window closes early: bring anything still down back now
        for nid in list(self._down):
            node = ctx.nodes[nid]
            if not node.alive:
                node.restart(wipe_disk=self.wipe_disk)
        self._down.clear()


class LeaderNemesis(Fault):
    """The leader-chasing nemesis: every ``period`` it checks for a leader
    of a term it has not struck yet and crash-restarts it. Because the
    victim is re-resolved per firing, each newly elected leader gets hit
    in turn — the schedule the paper's availability story must survive."""

    def __init__(self, period: float = 0.5, downtime: float = 0.25,
                 wipe_disk: bool = False) -> None:
        self.period = period
        self.downtime = downtime
        self.wipe_disk = wipe_disk
        self.name = f"leader_nemesis[p={period}]"
        self._active = False
        self._last_struck_term = -1

    def start(self, ctx: FaultContext) -> None:
        self._active = True
        self._last_struck_term = -1
        self._tick(ctx)

    def _tick(self, ctx: FaultContext) -> None:
        if not self._active:
            return
        ldr = ctx.leader()
        if ldr is not None and ldr.alive and ldr.is_leader() \
                and ldr.term > self._last_struck_term:
            self._last_struck_term = ldr.term
            ctx.note(f"nemesis strikes leader {ldr.id} (term {ldr.term})")
            ldr.crash()
            ctx.loop.call_later(
                self.downtime,
                lambda n=ldr: n.restart(wipe_disk=self.wipe_disk)
                if not n.alive else None)
        ctx.loop.call_later(self.period, lambda: self._tick(ctx))

    def stop(self, ctx: FaultContext) -> None:
        self._active = False
        for node in ctx.nodes.values():
            if not node.alive:
                node.restart(wipe_disk=self.wipe_disk)


# --------------------------------------------------------- membership faults
class MembershipChaos(Fault):
    """Scheduled membership churn through ``change_membership`` (paper
    §4.4): every ``period`` the next op from an add/remove schedule is
    attempted against the current leader. Adds spawn a fresh node that
    joins as a non-voting learner (the leader auto-promotes it once its
    match index covers the commit index); removes drop a voter follower
    and — with ``decommission`` — crash it for good. Failed attempts
    (no leader, reconfig in progress, deposed mid-append) retry on the
    next tick, so the schedule survives overlapping crash/partition
    faults."""

    def __init__(self, period: float = 0.2, adds: int = 2, removes: int = 2,
                 decommission: bool = True, victim: str = "low") -> None:
        self.period = period
        ops: list[str] = []
        for i in range(max(adds, removes)):
            if i < adds:
                ops.append("add")
            if i < removes:
                ops.append("remove")
        self.ops = ops
        self.decommission = decommission
        assert victim in ("low", "high"), victim
        self.victim = victim
        self.name = f"membership_chaos[+{adds}/-{removes}]"
        self._active = False
        self._i = 0
        self._busy = False
        self._pending = None     # spawned-but-not-yet-joined learner

    def start(self, ctx: FaultContext) -> None:
        self._active = True
        self._i = 0
        self._tick(ctx)

    def _tick(self, ctx: FaultContext) -> None:
        if not self._active or self._i >= len(self.ops):
            return
        if not self._busy:
            ctx.loop.create_task(self._act(ctx))
        ctx.loop.call_later(self.period, lambda: self._tick(ctx))

    async def _act(self, ctx: FaultContext) -> None:
        self._busy = True
        try:
            ldr = ctx.leader()
            if ldr is None or not ldr.is_leader():
                return
            if self.ops[self._i] == "add":
                if self._pending is None or not self._pending.alive:
                    new_id = max(ctx.nodes) + 1
                    self._pending = ctx.cluster.spawn_node(
                        new_id, ldr.p, learner=True)
                res = await ldr.change_membership(
                    set(ldr.config),
                    learners=set(ldr.learners) | {self._pending.id})
                if res.ok:
                    ctx.note(f"added learner {self._pending.id}")
                    self._pending = None
                    self._i += 1
            else:
                voters = sorted(v for v in ldr.config if v != ldr.id)
                if len(voters) < 2:
                    self._i += 1      # refuse to shrink below two voters
                    return
                target = voters[0] if self.victim == "low" else voters[-1]
                res = await ldr.change_membership(set(ldr.config) - {target})
                if res.ok:
                    ctx.note(f"removed voter {target}")
                    self._i += 1
                    if self.decommission:
                        gone = ctx.nodes.get(target)
                        if gone is not None and gone.alive:
                            gone.crash()
        finally:
            self._busy = False

    def stop(self, ctx: FaultContext) -> None:
        # membership changes are durable — stopping just ends the churn
        self._active = False


class DiskLossRejoin(Fault):
    """The SAFE disk-loss path (ROADMAP item): crash the scope's nodes,
    demote each to a non-voting learner in the replicated config while it
    is down, then restart it disk-wiped with ``rejoin_as_learner`` — it
    refuses votes and elections regardless of stale log prefixes, the
    leader clamps its match index on first contact, replication catches
    it up, and auto-promotion returns it to the voter set via an ordinary
    CONFIG entry. Contrast ``CrashRestart(wipe_disk=True)``, which
    restarts a wiped node as a full voter and breaks Leader
    Completeness."""

    def __init__(self, scope: str = "minority", downtime: float = 0.2,
                 repair_timeout: float = 5.0) -> None:
        self.scope = scope
        self.downtime = downtime
        self.repair_timeout = repair_timeout
        self.name = f"disk_loss_rejoin[{scope}]"

    def start(self, ctx: FaultContext) -> None:
        for nid in ctx.pick(self.scope):
            node = ctx.nodes[nid]
            if not node.alive:
                continue
            node.crash()
            ctx.note(f"crashed node {nid} (disk lost)")
            ctx.loop.create_task(self._demote(ctx, nid))
            ctx.loop.call_later(self.downtime,
                                lambda n=node: self._rejoin(ctx, n))

    async def _demote(self, ctx: FaultContext, nid: int) -> None:
        """Move the wiped node from the voter to the learner set, retrying
        across leader changes until the CONFIG entry commits."""
        deadline = ctx.loop.now + self.repair_timeout
        while ctx.loop.now < deadline:
            ldr = ctx.leader()
            if ldr is not None and ldr.is_leader():
                if nid not in ldr.config:
                    return                      # already a learner (or gone)
                res = await ldr.change_membership(
                    set(ldr.config) - {nid},
                    learners=set(ldr.learners) | {nid})
                if res.ok:
                    ctx.note(f"demoted wiped node {nid} to learner")
                    return
            await ctx.loop.sleep(0.05)

    def _rejoin(self, ctx: FaultContext, node) -> None:
        if not node.alive:
            node.restart(wipe_disk=True, rejoin_as_learner=True)
            ctx.note(f"restarted node {node.id} as wiped learner")

    def stop(self, ctx: FaultContext) -> None:
        # the repair is durable (learner demotion + auto-promotion live in
        # the replicated config); nothing to undo when the window closes
        pass


# ------------------------------------------------------------ message faults
class MessageChaos(Fault):
    """Install a :class:`MessageFault` rule for the window: extra delay,
    reorder jitter, probabilistic loss, duplication — globally or on one
    directed link."""

    def __init__(self, extra_delay: float = 0.0, jitter: float = 0.0,
                 drop_prob: float = 0.0, dup_prob: float = 0.0,
                 src: Optional[int] = None, dst: Optional[int] = None,
                 label: str = "") -> None:
        self.rule = MessageFault(extra_delay=extra_delay, jitter=jitter,
                                 drop_prob=drop_prob, dup_prob=dup_prob,
                                 src=src, dst=dst)
        self.name = f"message_chaos[{label}]" if label else "message_chaos"
        self._handle: Optional[int] = None

    def start(self, ctx: FaultContext) -> None:
        self._handle = ctx.net.add_fault(self.rule)

    def stop(self, ctx: FaultContext) -> None:
        if self._handle is not None:
            ctx.net.remove_fault(self._handle)
            self._handle = None


class SlowNode(Fault):
    """Gray failure: the scope's nodes are up but degraded — extra
    per-message I/O service time plus inflated (and jittered) latency on
    everything they send. Unlike a crash, the node keeps answering
    *eventually*, so failure detectors stay quiet while its RPCs straggle
    past ``rpc_timeout`` — the fixed-retry hot loop the adaptive backoff
    flag exists to tame."""

    def __init__(self, scope: str = "followers", extra_io: float = 500e-6,
                 send_delay: float = 0.1, send_jitter: float = 0.05) -> None:
        self.scope = scope
        self.extra_io = extra_io
        self.send_delay = send_delay
        self.send_jitter = send_jitter
        self.name = f"slow_node[{scope}]"
        self._victims: list[int] = []
        self._handles: list[int] = []

    def start(self, ctx: FaultContext) -> None:
        self._victims = ctx.pick(self.scope)
        for nid in self._victims:
            ctx.net.set_io_slowdown(nid, self.extra_io)
            self._handles.append(ctx.net.add_fault(MessageFault(
                extra_delay=self.send_delay, jitter=self.send_jitter,
                src=nid)))

    def stop(self, ctx: FaultContext) -> None:
        for nid in self._victims:
            ctx.net.set_io_slowdown(nid, 0.0)
        for h in self._handles:
            ctx.net.remove_fault(h)
        self._victims = []
        self._handles = []


class FlappingLink(Fault):
    """Gray failure: directed links flap on a deterministic duty cycle —
    cut for ``down`` seconds, healed for ``up`` seconds, repeating while
    the window is open. The default cuts every inbound link of the first
    follower: the victim intermittently goes deaf, its election timer
    fires, and (without PreVote) each flap bumps the term and evicts a
    perfectly healthy leader. ``direction="out"`` flaps the victim's
    outbound side instead; ``direction="pair"`` flaps the single directed
    link victim -> leader.

    ``flaps`` counts down-phase onsets; the property tests bound term
    inflation per flap. Victim and links are resolved once, at window
    start."""

    def __init__(self, victim_scope: str = "followers",
                 direction: str = "in",
                 up: float = 0.25, down: float = 0.2) -> None:
        assert direction in ("in", "out", "pair"), direction
        self.victim_scope = victim_scope
        self.direction = direction
        self.up = up
        self.down = down
        self.name = f"flapping_link[{victim_scope},{direction}]"
        self._active = False
        self._links: list[tuple[int, int]] = []
        self.victim: Optional[int] = None
        self.flaps = 0

    def start(self, ctx: FaultContext) -> None:
        vid = ctx.pick(self.victim_scope)[0]
        self.victim = vid
        if self.direction == "in":
            self._links = [(p, vid) for p in ctx.ids() if p != vid]
        elif self.direction == "out":
            self._links = [(vid, p) for p in ctx.ids() if p != vid]
        else:
            self._links = [(vid, ctx.leader_id())]
        self._active = True
        self.flaps = 0
        self._go_down(ctx)

    def _go_down(self, ctx: FaultContext) -> None:
        if not self._active:
            return
        self.flaps += 1
        ctx.note(f"flap down #{self.flaps} (victim {self.victim})")
        for src, dst in self._links:
            ctx.net.partition_oneway(src, dst)
        ctx.loop.call_later(self.down, lambda: self._go_up(ctx))

    def _go_up(self, ctx: FaultContext) -> None:
        if not self._active:
            return
        ctx.note(f"flap up (victim {self.victim})")
        for src, dst in self._links:
            ctx.net.heal_oneway(src, dst)
        ctx.loop.call_later(self.up, lambda: self._go_down(ctx))

    def stop(self, ctx: FaultContext) -> None:
        self._active = False
        for src, dst in self._links:
            ctx.net.heal_oneway(src, dst)


class CorruptFault(Fault):
    """Field-level corruption of in-flight AppendEntries: with
    probability ``prob`` per delivered message, one field is mutated —
    a data entry's value, ``prev_index``, ``prev_term``, or
    ``leader_commit``. Mutated messages are fresh copies (the originals
    are shared with the sender's log and must stay pristine); any stale
    checksum/digest travels with the copy, so with
    ``RaftParams.entry_checksums`` the receiver detects and drops it,
    and without checksums the corruption is *applied* — the adversarial
    positive control for the linearizability checker.

    Draws come from a private PRNG seeded by ``seed``: zero draws from
    any pre-existing stream, so scenarios without this fault replay
    bit-identically."""

    def __init__(self, prob: float = 0.05, seed: int = 0xBADC0DE,
                 src: Optional[int] = None,
                 dst: Optional[int] = None) -> None:
        self.prob = prob
        self.seed = seed
        self.src = src
        self.dst = dst
        self.name = f"corrupt_append[p={prob}]"
        self.prng = PRNG(seed)
        self.corrupted = 0
        self._handle: Optional[int] = None

    def start(self, ctx: FaultContext) -> None:
        self.prng = PRNG(self.seed)
        self._handle = ctx.net.add_interceptor(
            lambda s, d, m: self._intercept(ctx, s, d, m))

    def _intercept(self, ctx: FaultContext, src: int, dst: int, msg):
        if not isinstance(msg, AppendEntries):
            return msg
        if self.src is not None and src != self.src:
            return msg
        if self.dst is not None and dst != self.dst:
            return msg
        if self.prng.random() >= self.prob:
            return msg
        bad = replace(msg, entries=list(msg.entries))
        # payload rot weighted up: header mutations (kinds 1-3) mostly
        # bounce off Raft's log-matching check, payload rot is the silent
        # kind real checksum machinery exists for
        kind = self.prng.choice([0, 0, 0, 1, 2, 3])
        data = [i for i, e in enumerate(bad.entries) if not e.is_control]
        if kind == 0 and not data:
            kind = 3                 # heartbeat: no payload to rot
        if kind == 0:
            # bit-rot a data entry's payload: same term/key, garbage value
            # (control entries are excluded — a mangled CONFIG payload
            # models a crash, not silent corruption)
            i = self.prng.choice(data)
            e = bad.entries[i]
            bad.entries[i] = replace(e, value=f"CORRUPT:{e.value}")
        elif kind == 1:
            bad.prev_index += self.prng.choice([-2, -1, 1, 2])
        elif kind == 2:
            bad.prev_term += self.prng.choice([1, 2])
        else:
            bad.leader_commit += self.prng.choice([-1, 1, 2])
        self.corrupted += 1
        ctx.note(f"corrupted append {src}->{dst} (kind {kind})")
        return bad

    def stop(self, ctx: FaultContext) -> None:
        if self._handle is not None:
            ctx.net.remove_interceptor(self._handle)
            self._handle = None


class IoSlowdown(Fault):
    """Extra per-message I/O service time on the scope's nodes (models a
    slow disk / saturated NIC rather than a slow network)."""

    def __init__(self, extra_service_time: float = 200e-6,
                 scope: str = "leader") -> None:
        self.extra = extra_service_time
        self.scope = scope
        self.name = f"io_slowdown[{scope}]"
        self._victims: list[int] = []

    def start(self, ctx: FaultContext) -> None:
        self._victims = ctx.pick(self.scope)
        for nid in self._victims:
            ctx.net.set_io_slowdown(nid, self.extra)

    def stop(self, ctx: FaultContext) -> None:
        for nid in self._victims:
            ctx.net.set_io_slowdown(nid, 0.0)
        self._victims = []
