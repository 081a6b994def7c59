"""Deterministic, composable fault injection (the nemesis engine).

Three layers:

* :mod:`repro.faults.base` — the :class:`Fault` protocol, the
  :class:`Window`/:class:`Scenario` scheduler, and :class:`FaultContext`
  (deterministic victim selection + activation trace);
* :mod:`repro.faults.library` — the fault catalogue: asymmetric and
  partial partitions, majority/minority splits, honest and lying clock
  skew/drift, crash-restart with or without disk loss, scheduled membership churn
  (add/learner-promote/remove via ``change_membership``) and the safe
  wipe-then-learner-rejoin path, message delay /
  duplication / reordering / loss, I/O slowdown, and the leader-chasing
  nemesis;
* :mod:`repro.faults.scenarios` — the named scenario registry (safe vs
  beyond-the-fault-model schedules) plus the ``random_scenario`` /
  ``random_membership_scenario`` / ``random_gray_scenario`` fuzzers.

The catalogue spans three failure-model tiers: crash-stop (crashes,
partitions, message chaos, honest clocks), gray (``SlowNode``
degradation, ``FlappingLink`` duty-cycle flaps — nodes alive but
unreliable), and corruption (``CorruptFault`` field-level AppendEntries
mutation, detected-and-dropped when ``RaftParams.entry_checksums``).

Everything runs on the simulated event loop: a (seed, scenario, policy)
triple replays bit-identically. ``benchmarks/fault_matrix.py`` sweeps the
full policy × scenario × seed cube through ``check_linearizability``.
"""

from .base import Fault, FaultContext, Scenario, Window
from .library import (ClockSkew, CorruptFault, CrashRestart, DiskLossRejoin,
                      FlappingLink, IoSlowdown, IsolateLeader, LeaderNemesis,
                      MajorityMinority, MembershipChaos, MessageChaos,
                      OneWayLink, PartialPartition, SlowNode)
from .scenarios import (SCENARIOS, build_scenario, random_gray_scenario,
                        random_membership_scenario, random_scenario,
                        safe_scenario_names, scenario,
                        unsafe_scenario_names)

__all__ = [
    "Fault", "FaultContext", "Scenario", "Window",
    "ClockSkew", "CorruptFault", "CrashRestart", "DiskLossRejoin",
    "FlappingLink", "IoSlowdown",
    "IsolateLeader", "LeaderNemesis", "MajorityMinority", "MembershipChaos",
    "MessageChaos", "OneWayLink", "PartialPartition", "SlowNode",
    "SCENARIOS", "build_scenario", "random_gray_scenario",
    "random_membership_scenario", "random_scenario",
    "safe_scenario_names", "scenario", "unsafe_scenario_names",
]
