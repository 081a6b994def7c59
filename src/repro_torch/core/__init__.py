"""LeaseGuard core: Raft + leases, deterministic simulation (the paper)."""

from .checker import LinearizabilityError, check_linearizability
from .client import ClientLogEntry, Directory, Workload
from .clock import BoundedClock, TimeInterval
from .network import NetParams, Network
from .params import RaftParams, ReadMode, SimParams
from .raft import (CONFIG, END_LEASE, NOOP, LogEntry, Node, ReadResult,
                   WriteResult, encode_config, parse_config)
from .runner import Cluster, RunResult, build_cluster, run_workload, throughput_timeline
from .simulate import Condition, Event, EventLoop, Future, Task, TimeoutError_, wait_for

__all__ = [
    "LinearizabilityError", "check_linearizability", "ClientLogEntry",
    "Directory", "Workload", "BoundedClock", "TimeInterval", "NetParams",
    "Network", "RaftParams", "ReadMode", "SimParams", "END_LEASE", "NOOP",
    "LogEntry", "Node", "ReadResult", "WriteResult", "encode_config",
    "parse_config", "CONFIG", "Cluster", "RunResult",
    "build_cluster", "run_workload", "throughput_timeline", "Condition",
    "Event", "EventLoop", "Future", "Task", "TimeoutError_", "wait_for",
]
