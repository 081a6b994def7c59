"""Deterministic training-fleet simulation (the data plane).

N worker actors share the simulated event loop with the Raft replica
set they coordinate through: register/heartbeat in the membership log,
poll the latest checkpoint every step through the configured read
policy, report step times, and elect a chief (fenced through the
replicated fleet log itself) that commits checkpoint manifests. Fault
scenarios compose data-plane chaos (:mod:`repro.fleet.faults`) with the
control-plane nemesis catalogue in one window schedule, and the
post-run lineage checker (:mod:`repro.fleet.lineage`) audits every
restore omnisciently. ``benchmarks/fleet_matrix.py`` sweeps
policy × scenario × seed over :func:`run_fleet`.
"""

from .faults import (CheckpointStorm, ChiefKill, FleetContext, FleetScenario,
                     WorkerCrash, WorkerStraggler)
from .lineage import (FLEET_KEY, LogView, check_lineage, extract_fleet_log)
from .scenarios import (FLEET_SCENARIOS, build_fleet_scenario, fleet_scenario,
                        fleet_scenario_names)
from .sim import Fleet, FleetParams, FleetResult, run_fleet
from .worker import Worker

__all__ = [
    "CheckpointStorm", "ChiefKill", "FleetContext", "FleetScenario",
    "WorkerCrash", "WorkerStraggler",
    "FLEET_KEY", "LogView", "check_lineage", "extract_fleet_log",
    "FLEET_SCENARIOS", "build_fleet_scenario", "fleet_scenario",
    "fleet_scenario_names",
    "Fleet", "FleetParams", "FleetResult", "run_fleet",
    "Worker",
]
