"""Named fleet scenarios: data-plane chaos, control-plane chaos, and the
combined schedules where both strike at once.

Same registry idiom as :mod:`repro.faults.scenarios`; every scenario
here is within the crash-stop fault model (``expect_safe=True``), so the
fleet matrix asserts ZERO lineage violations for every consistent policy
— the ``inconsistent`` policy is the positive control that must get
flagged. Timings assume the default ``FleetParams.duration`` of 4s."""

from __future__ import annotations

from typing import Callable, Optional

from ..faults.base import Window
from ..faults.library import CrashRestart, LeaderNemesis, MajorityMinority
from .faults import (CheckpointStorm, ChiefKill, FleetScenario, WorkerCrash,
                     WorkerStraggler)

FLEET_SCENARIOS: dict[str, Callable[[], FleetScenario]] = {}


def fleet_scenario(name: str, expect_safe: bool = True,
                   description: str = "",
                   raft_overrides: Optional[dict] = None,
                   meta: Optional[dict] = None):
    def deco(factory: Callable[[], list[Window]]):
        def build() -> FleetScenario:
            return FleetScenario(name, factory(), expect_safe=expect_safe,
                                 description=description,
                                 raft_overrides=raft_overrides, meta=meta)

        build.scenario_name = name
        build.expect_safe = expect_safe
        build.description = description
        build.raft_overrides = dict(raft_overrides or {})
        FLEET_SCENARIOS[name] = build
        return build

    return deco


def build_fleet_scenario(name: str) -> FleetScenario:
    try:
        return FLEET_SCENARIOS[name]()
    except KeyError:
        raise ValueError(f"unknown fleet scenario {name!r}; registered: "
                         f"{sorted(FLEET_SCENARIOS)}") from None


def fleet_scenario_names() -> list[str]:
    return list(FLEET_SCENARIOS)


# ------------------------------------------------------- data-plane only
@fleet_scenario("calm", description="no faults; baseline poll/commit load")
def _calm() -> list[Window]:
    return []


@fleet_scenario("worker_crashes",
                description="two crash waves across the worker pool")
def _worker_crashes() -> list[Window]:
    return [Window(WorkerCrash("fraction:0.3", downtime=0.6), at=0.8),
            Window(WorkerCrash("fraction:0.2", downtime=0.5), at=2.2)]


@fleet_scenario("straggler_band",
                description="a quarter of the fleet runs 4x slow for 2s")
def _straggler_band() -> list[Window]:
    return [Window(WorkerStraggler("fraction:0.25", factor=4.0),
                   at=0.5, until=2.5)]


@fleet_scenario("chief_kill",
                description="kill the chief once; successor must take over")
def _chief_kill() -> list[Window]:
    return [Window(ChiefKill(downtime=0.8), at=1.0)]


@fleet_scenario("chief_nemesis",
                description="chase and kill every newly elected chief")
def _chief_nemesis() -> list[Window]:
    return [Window(ChiefKill(downtime=0.4, period=0.9), at=0.8, until=3.4)]


@fleet_scenario("checkpoint_storm",
                description="manifest every step + a crash wave mid-storm")
def _checkpoint_storm() -> list[Window]:
    return [Window(CheckpointStorm(every=1), at=0.5, until=3.0),
            Window(WorkerCrash("fraction:0.2", downtime=0.5), at=1.5)]


# --------------------------------------------- combined control + data
@fleet_scenario("leader_crash_mid_commit",
                description="Raft leader crashes twice during a "
                            "checkpoint storm: commits caught in flight")
def _leader_crash_mid_commit() -> list[Window]:
    return [Window(CheckpointStorm(every=1), at=0.5, until=3.0),
            Window(CrashRestart("leader", downtime=0.4), at=1.0),
            Window(CrashRestart("leader", downtime=0.4), at=2.2)]


@fleet_scenario("chief_and_leader_die",
                description="chief and Raft leader die at the same instant")
def _chief_and_leader_die() -> list[Window]:
    return [Window(ChiefKill(downtime=0.8), at=1.0),
            Window(CrashRestart("leader", downtime=0.4), at=1.0)]


@fleet_scenario("leader_nemesis_fleet",
                description="control-plane leader nemesis under a "
                            "full training fleet")
def _leader_nemesis_fleet() -> list[Window]:
    return [Window(LeaderNemesis(period=0.6, downtime=0.25),
                   at=0.6, until=3.2)]


@fleet_scenario("partition_churn",
                description="majority/minority split while a crash wave "
                            "forces restores mid-partition")
def _partition_churn() -> list[Window]:
    return [Window(MajorityMinority(leader_in_minority=True),
                   at=1.0, until=2.0),
            Window(WorkerCrash("fraction:0.3", downtime=0.5), at=1.2)]
