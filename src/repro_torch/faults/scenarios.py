"""Named scenario registry + random scenario generator.

A *scenario* is a reusable fault schedule; the registry maps names to
factories (fresh ``Fault`` instances per run, since faults carry undo
state). ``expect_safe`` classifies the schedule:

* safe — inside the fault model every consistent policy claims to
  tolerate (crashes, any partition topology, message chaos, honest clock
  skew/drift, I/O slowdown). The fault matrix asserts **zero**
  linearizability violations here.
* unsafe — exceeds the model (lying clocks breaching the §4.3 bound,
  disk loss breaking vote persistence). Violations are expected findings
  that prove the checker bites, not failures.

Adding a scenario: write a factory returning ``[Window(...), ...]`` and
decorate it with ``@scenario(name, ...)``; it then shows up in the
matrix, the conformance tests, and ``benchmarks/fault_matrix.py``
automatically. Window times are relative to workload start; the standard
matrix run lasts ~1.2 s of simulated time.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from .base import Scenario, Window
from .library import (ClockSkew, CorruptFault, CrashRestart, DiskLossRejoin,
                      FlappingLink, IoSlowdown, IsolateLeader, LeaderNemesis,
                      MajorityMinority, MembershipChaos, MessageChaos,
                      OneWayLink, PartialPartition, SlowNode)

#: name -> scenario factory; call ``build_scenario(name)`` for a run-ready
#: instance. Iteration order is the canonical matrix order.
SCENARIOS: dict[str, Callable[[], Scenario]] = {}


def scenario(name: str, expect_safe: bool = True, description: str = "",
             raft_overrides: Optional[dict] = None,
             meta: Optional[dict] = None):
    """Register a window-list factory as a named scenario.
    ``raft_overrides`` are RaftParams kwargs the scenario needs for its
    ``expect_safe`` classification (e.g. checksums for corruption)."""

    def deco(factory: Callable[[], list[Window]]):
        def build() -> Scenario:
            return Scenario(name, factory(), expect_safe=expect_safe,
                            description=description,
                            raft_overrides=raft_overrides, meta=meta)

        build.scenario_name = name
        build.expect_safe = expect_safe
        build.description = description
        build.raft_overrides = dict(raft_overrides or {})
        SCENARIOS[name] = build
        return build

    return deco


def build_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}"
        ) from None


def safe_scenario_names() -> list[str]:
    return [n for n, f in SCENARIOS.items() if f.expect_safe]


def unsafe_scenario_names() -> list[str]:
    return [n for n, f in SCENARIOS.items() if not f.expect_safe]


# ------------------------------------------------------------ the catalogue
@scenario("leader_crash_restart",
          description="leader crashes at 0.3s, returns with disk at 0.7s")
def _leader_crash_restart() -> list[Window]:
    return [Window(CrashRestart("leader", downtime=0.4), at=0.3)]


@scenario("leader_nemesis",
          description="crash-restart nemesis chasing every new leader")
def _leader_nemesis() -> list[Window]:
    return [Window(LeaderNemesis(period=0.45, downtime=0.25), at=0.2,
                   until=1.1)]


@scenario("asym_partition_leader_deaf",
          description="one-way cut: leader sends but hears nothing")
def _asym_leader_deaf() -> list[Window]:
    return [Window(IsolateLeader("in"), at=0.3, until=0.8)]


@scenario("asym_partition_leader_mute",
          description="one-way cut: leader hears but cannot send")
def _asym_leader_mute() -> list[Window]:
    return [Window(IsolateLeader("out"), at=0.3, until=0.8)]


@scenario("majority_minority",
          description="leader trapped in a minority side for 0.6s")
def _majority_minority() -> list[Window]:
    return [Window(MajorityMinority(leader_in_minority=True), at=0.25,
                   until=0.85)]


@scenario("partial_partition",
          description="single follower-follower link cut; both see the rest")
def _partial_partition() -> list[Window]:
    return [Window(PartialPartition(), at=0.2, until=0.9)]


@scenario("oneway_flaky_link",
          description="one directed follower link dead, reverse alive")
def _oneway_link() -> list[Window]:
    return [Window(OneWayLink(), at=0.2, until=0.9)]


@scenario("clock_skew_minority",
          description="honest +80ms skew on a follower minority (beyond Δ "
                      "assumptions, bounds stay truthful)")
def _clock_skew_minority() -> list[Window]:
    return [Window(ClockSkew(skew=0.08, scope="minority"), at=0.2,
                   until=1.0)]


@scenario("clock_drift_all",
          description="honest 50ms/s drift on every node")
def _clock_drift_all() -> list[Window]:
    return [Window(ClockSkew(skew=0.0, drift_rate=0.05, scope="all"),
                   at=0.2, until=1.0)]


@scenario("delay_spike",
          description="+25ms one-way latency with 15ms jitter, all links")
def _delay_spike() -> list[Window]:
    return [Window(MessageChaos(extra_delay=0.025, jitter=0.015,
                                label="delay"), at=0.3, until=0.8)]


@scenario("dup_reorder",
          description="30% duplication + 10ms reorder jitter, all links")
def _dup_reorder() -> list[Window]:
    return [Window(MessageChaos(dup_prob=0.3, jitter=0.01,
                                label="dup+reorder"), at=0.15, until=1.0)]


@scenario("flaky_network",
          description="20% iid message loss on every link")
def _flaky_network() -> list[Window]:
    return [Window(MessageChaos(drop_prob=0.2, label="loss"), at=0.2,
                   until=0.9)]


@scenario("io_slowdown_leader",
          description="+300µs per-message I/O service time on the leader")
def _io_slowdown() -> list[Window]:
    return [Window(IoSlowdown(300e-6, scope="leader"), at=0.3, until=0.8)]


@scenario("combo_chaos",
          description="delay spike over a partial partition, then a leader "
                      "crash while messages duplicate")
def _combo_chaos() -> list[Window]:
    return [
        Window(PartialPartition(), at=0.15, until=0.7),
        Window(MessageChaos(extra_delay=0.01, jitter=0.01, label="delay"),
               at=0.25, until=0.9),
        Window(MessageChaos(dup_prob=0.2, label="dup"), at=0.4, until=1.0),
        Window(CrashRestart("leader", downtime=0.3), at=0.5),
    ]


# --------------------------------------------------- gray-failure tier
@scenario("slow_follower",
          description="one follower gray-degrades: +500µs I/O service plus "
                      "~100ms straggle on everything it sends — alive to "
                      "failure detectors, useless to the quorum")
def _slow_follower() -> list[Window]:
    return [Window(SlowNode("minority", extra_io=500e-6, send_delay=0.1,
                            send_jitter=0.05), at=0.2, until=0.9)]


@scenario("slow_leader",
          description="the leader itself straggles: heartbeats and "
                      "replication limp out ~60ms late — the CheckQuorum "
                      "borderline case")
def _slow_leader() -> list[Window]:
    return [Window(SlowNode("leader", extra_io=300e-6, send_delay=0.06,
                            send_jitter=0.03), at=0.3, until=0.8)]


@scenario("flapping_node",
          description="first follower's inbound links flap on a 450ms-down/"
                      "250ms-up duty cycle (down > election timeout): it "
                      "repeatedly goes deaf, times out, and — without "
                      "PreVote — its term-bumping candidacies evict a "
                      "healthy leader every flap",
          meta={"flap_down": 0.45, "flap_up": 0.25})
def _flapping_node() -> list[Window]:
    return [Window(FlappingLink("followers", direction="in",
                                up=0.25, down=0.45), at=0.2, until=1.2)]


@scenario("flapping_outbound",
          description="first follower's outbound links flap: its votes and "
                      "acks vanish intermittently while it still hears the "
                      "leader (no election pressure, replication staggers)",
          meta={"flap_down": 0.15, "flap_up": 0.2})
def _flapping_outbound() -> list[Window]:
    return [Window(FlappingLink("followers", direction="out",
                                up=0.2, down=0.15), at=0.2, until=1.0)]


@scenario("gray_combo",
          description="slow follower + flapping deaf follower + global "
                      "delay spike: the full gray-failure gauntlet")
def _gray_combo() -> list[Window]:
    return [
        Window(SlowNode("minority", extra_io=300e-6, send_delay=0.08,
                        send_jitter=0.04), at=0.15, until=0.9),
        Window(FlappingLink("followers", direction="in",
                            up=0.25, down=0.45), at=0.3, until=1.2),
        Window(MessageChaos(extra_delay=0.01, jitter=0.01, label="delay"),
               at=0.4, until=0.8),
    ]


# --------------------------------------------------- corruption tier
@scenario("corrupt_entries_checked",
          description="8% of AppendEntries mutated in flight (payloads, "
                      "prev_index/term, commit_index); end-to-end checksums "
                      "detect and drop every corrupted message",
          raft_overrides={"entry_checksums": True})
def _corrupt_entries_checked() -> list[Window]:
    return [Window(CorruptFault(prob=0.08, seed=0xBADC0DE), at=0.2,
                   until=0.9)]


@scenario("corrupt_storm_checked",
          description="25% corruption rate plus a leader crash mid-storm; "
                      "checksums must still hold the line",
          raft_overrides={"entry_checksums": True})
def _corrupt_storm_checked() -> list[Window]:
    return [
        Window(CorruptFault(prob=0.25, seed=0xC0FFEE), at=0.15, until=1.0),
        Window(CrashRestart("leader", downtime=0.3), at=0.5),
    ]


@scenario("corrupt_entries_unchecked", expect_safe=False,
          description="the corrupt_storm schedule with checksums OFF: "
                      "corrupted entries replicate, a follower with a "
                      "poisoned log takes over after the crash, and the "
                      "divergence becomes client-visible — violations here "
                      "are the checker's positive control")
def _corrupt_entries_unchecked() -> list[Window]:
    return [
        Window(CorruptFault(prob=0.25, seed=0xC0FFEE), at=0.15, until=1.0),
        Window(CrashRestart("leader", downtime=0.3), at=0.5),
    ]


# ------------------------------------------------------ membership chaos
@scenario("membership_churn",
          description="scheduled add-learner/promote/remove churn through "
                      "change_membership (paper §4.4)")
def _membership_churn() -> list[Window]:
    return [Window(MembershipChaos(period=0.2, adds=2, removes=2), at=0.2,
                   until=1.1)]


@scenario("membership_churn_crash",
          description="membership churn with the leader crash-restarting "
                      "mid-schedule")
def _membership_churn_crash() -> list[Window]:
    return [
        Window(MembershipChaos(period=0.2, adds=2, removes=1), at=0.2,
               until=1.1),
        Window(CrashRestart("leader", downtime=0.3), at=0.55),
    ]


@scenario("membership_churn_partition",
          description="membership churn while a follower-follower link is "
                      "cut, then a majority/minority split")
def _membership_churn_partition() -> list[Window]:
    return [
        Window(MembershipChaos(period=0.25, adds=1, removes=1), at=0.15,
               until=1.1),
        Window(PartialPartition(), at=0.3, until=0.7),
        Window(MajorityMinority(leader_in_minority=True), at=0.8,
               until=1.1),
    ]


@scenario("disk_loss_safe",
          description="a follower loses its disk but rejoins as a learner "
                      "(demote-while-down, catch up, auto-promote), then "
                      "the leader crashes: the safe default rejoin path")
def _disk_loss_safe() -> list[Window]:
    return [
        Window(DiskLossRejoin("minority", downtime=0.2), at=0.25),
        Window(CrashRestart("leader", downtime=0.3), at=0.55),
    ]


# -------------------------------------------------- beyond the fault model
@scenario("clock_lie_leader", expect_safe=False,
          description="leader's clock claims tight bounds while 10s slow: "
                      "its lease never looks expired (§4.3 breach)")
def _clock_lie() -> list[Window]:
    return [
        Window(ClockSkew(skew=-10.0, scope="leader", lie=True), at=0.2),
        Window(MajorityMinority(leader_in_minority=True), at=0.3,
               until=1.0),
    ]


@scenario("disk_loss", expect_safe=False,
          description="a follower loses its disk across a restart and "
                      "rejoins as a FULL VOTER, then the leader crashes: "
                      "vote persistence is broken (the safe default is "
                      "disk_loss_safe: rejoin as learner, then promote)")
def _disk_loss() -> list[Window]:
    return [
        Window(CrashRestart("minority", downtime=0.2, wipe_disk=True),
               at=0.25),
        Window(CrashRestart("leader", downtime=0.3), at=0.55),
    ]


# ------------------------------------------------------ random composition
def random_scenario(seed: int, duration: float = 1.2) -> Scenario:
    """Compose 1-3 random faults from the *safe* library into a scenario —
    deterministic in ``seed``. Used by the property tests to fuzz the
    schedule space beyond the named catalogue."""
    rng = random.Random(seed)
    pool: list[Callable[[random.Random], "object"]] = [
        lambda r: CrashRestart("leader", downtime=r.uniform(0.15, 0.45)),
        lambda r: CrashRestart("minority", downtime=r.uniform(0.15, 0.45)),
        lambda r: IsolateLeader(r.choice(["both", "in", "out"])),
        lambda r: MajorityMinority(leader_in_minority=r.random() < 0.5),
        lambda r: PartialPartition(),
        lambda r: OneWayLink(),
        lambda r: ClockSkew(skew=r.uniform(-0.1, 0.1),
                            drift_rate=r.uniform(0.0, 0.05),
                            scope=r.choice(["leader", "minority", "all"])),
        lambda r: MessageChaos(extra_delay=r.uniform(0.0, 0.02),
                               jitter=r.uniform(0.0, 0.015),
                               drop_prob=r.uniform(0.0, 0.25),
                               dup_prob=r.uniform(0.0, 0.25),
                               label="random"),
        lambda r: IoSlowdown(r.uniform(50e-6, 400e-6),
                             scope=r.choice(["leader", "all"])),
        lambda r: LeaderNemesis(period=r.uniform(0.35, 0.6),
                                downtime=r.uniform(0.15, 0.3)),
    ]
    windows = []
    for _ in range(rng.randint(1, 3)):
        fault = rng.choice(pool)(rng)
        at = rng.uniform(0.1, 0.5 * duration)
        until = min(duration - 0.05, at + rng.uniform(0.2, 0.6 * duration))
        windows.append(Window(fault, at=at, until=until))
    return Scenario(f"random_{seed}", windows, expect_safe=True,
                    description=f"random composition (seed {seed})")


def random_membership_scenario(seed: int, duration: float = 1.2) -> Scenario:
    """Random membership-churn schedule: one churn window (add/promote/
    remove through ``change_membership``, or a safe wipe-then-learner
    rejoin) overlapped with 0-2 faults from the safe library —
    deterministic in ``seed``. Exercises learner promotion mid-partition,
    remove-then-crash, and wipe-then-rejoin interleavings the named
    catalogue can't enumerate."""
    rng = random.Random(seed ^ 0x5EED)
    windows = []
    if rng.random() < 0.7:
        churn = MembershipChaos(period=rng.uniform(0.15, 0.35),
                                adds=rng.randint(1, 2),
                                removes=rng.randint(0, 2),
                                decommission=rng.random() < 0.7,
                                victim=rng.choice(["low", "high"]))
    else:
        churn = DiskLossRejoin("minority",
                               downtime=rng.uniform(0.15, 0.35))
    windows.append(Window(churn, at=rng.uniform(0.1, 0.3),
                          until=duration - 0.1))
    pool = [
        lambda r: CrashRestart("leader", downtime=r.uniform(0.15, 0.4)),
        lambda r: PartialPartition(),
        lambda r: MajorityMinority(leader_in_minority=r.random() < 0.5),
        lambda r: IsolateLeader(r.choice(["both", "in", "out"])),
        lambda r: MessageChaos(extra_delay=r.uniform(0.0, 0.015),
                               jitter=r.uniform(0.0, 0.01),
                               drop_prob=r.uniform(0.0, 0.15),
                               label="random"),
    ]
    for _ in range(rng.randint(0, 2)):
        fault = rng.choice(pool)(rng)
        at = rng.uniform(0.25, 0.6 * duration)
        until = min(duration - 0.05, at + rng.uniform(0.2, 0.5 * duration))
        windows.append(Window(fault, at=at, until=until))
    return Scenario(f"random_membership_{seed}", windows, expect_safe=True,
                    description=f"random membership churn (seed {seed})")


def random_gray_scenario(seed: int, duration: float = 1.2) -> Scenario:
    """Random gray-failure schedule: exactly one :class:`FlappingLink`
    (random duty cycle and direction) overlapped with 0-2 degradations
    (slow node, delay chaos, I/O slowdown) — deterministic in ``seed``.
    Crash- and partition-free, so voting-quorum connectivity persists
    throughout: the schedule space over which the PreVote/CheckQuorum
    term-inflation and single-lease-holder properties are asserted.

    Separate draw path (note the salt): adding this generator leaves
    ``random_scenario`` / ``random_membership_scenario`` sequences for
    every existing seed untouched."""
    rng = random.Random(seed ^ 0x6EA7)
    # down phases straddle the matrix election timeout (0.3-0.4s): some
    # flaps starve the victim long enough to campaign, some don't
    down = rng.uniform(0.25, 0.55)
    up = rng.uniform(0.15, 0.35)
    flap = FlappingLink("followers",
                        direction=rng.choice(["in", "out", "pair"]),
                        up=up, down=down)
    windows = [Window(flap, at=rng.uniform(0.1, 0.3),
                      until=duration - 0.1)]
    pool = [
        lambda r: SlowNode("minority", extra_io=r.uniform(100e-6, 500e-6),
                           send_delay=r.uniform(0.02, 0.1),
                           send_jitter=r.uniform(0.0, 0.05)),
        lambda r: MessageChaos(extra_delay=r.uniform(0.0, 0.015),
                               jitter=r.uniform(0.0, 0.01), label="gray"),
        lambda r: IoSlowdown(r.uniform(50e-6, 300e-6), scope="all"),
    ]
    for _ in range(rng.randint(0, 2)):
        fault = rng.choice(pool)(rng)
        at = rng.uniform(0.15, 0.5 * duration)
        until = min(duration - 0.05, at + rng.uniform(0.2, 0.6 * duration))
        windows.append(Window(fault, at=at, until=until))
    return Scenario(f"random_gray_{seed}", windows, expect_safe=True,
                    description=f"random gray-failure schedule (seed {seed})",
                    meta={"flap_down": down, "flap_up": up})
