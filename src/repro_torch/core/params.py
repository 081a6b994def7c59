"""All protocol + simulation parameters in one place (paper §6.1 params.py)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class ReadMode(enum.Enum):
    """User-facing consistency switch. Each value is resolved to a
    ConsistencyPolicy class by the registry in ``repro.consistency`` —
    the value string equals the policy's ``name``."""

    INCONSISTENT = "inconsistent"    # local read, no consistency mechanism
    QUORUM = "quorum"                # Raft's default: per-read majority check
    ONGARO_LEASE = "ongaro_lease"    # heartbeat-based lease ([41] §6.4.1)
    LEASEGUARD = "leaseguard"        # this paper: the log is the lease
    READ_INDEX = "readindex"         # Raft ReadIndex: batched read barrier
    FOLLOWER_READ = "follower_read"  # leased leader barrier + follower serve


@dataclass
class RaftParams:
    n_nodes: int = 3
    election_timeout: float = 0.5          # ET
    election_jitter: float = 0.2           # uniform extra per election cycle
    heartbeat_interval: float = 0.05
    rpc_timeout: float = 0.25
    lease_duration: Optional[float] = None  # Δ; defaults to ET when None
    read_mode: ReadMode = ReadMode.LEASEGUARD
    # LeaseGuard optimization flags (paper §3.2, §3.3). With both False,
    # this is the "log-based lease" configuration of Figs. 7/9.
    defer_commit_writes: bool = True
    inherited_lease_reads: bool = True
    # lease upkeep (paper §5.1)
    noop_on_election: bool = True
    lease_maintenance: bool = True          # proactive no-op before expiry
    # membership: the leader's replication loop promotes a learner to
    # voter (one CONFIG entry) once its match_index covers commitIndex
    auto_promote_learners: bool = True
    # --- gray-failure resilience (all OFF by default: every committed
    # artifact replays bit-identically, and the disabled code paths make
    # no PRNG draws) ---
    # PreVote: a would-be candidate polls a majority with a trial
    # (non-term-bumping) vote before incrementing its term, so a flapping
    # node cannot inflate terms and evict a healthy lease-holding leader
    prevote: bool = False
    # CheckQuorum: a leader that has not heard from a voting majority
    # within an election timeout steps down (and stops serving its lease)
    # instead of serving a doomed lease window
    check_quorum: bool = False
    # capped exponential backoff + jitter on per-peer AppendEntries RPC
    # timeouts, replacing the fixed rpc_timeout hot-loop against
    # slow/dead peers
    replication_backoff: bool = False
    backoff_base: float = 0.02       # first retry delay after a timeout
    backoff_max: float = 0.5         # cap on the exponential growth
    # end-to-end checksums on AppendEntries (header digest + per-entry
    # checksums): corrupted messages are detected and dropped instead of
    # applied (the corruption nemesis tier's defense)
    entry_checksums: bool = False
    # clocks (paper §2.2; AWS clock-bound preset is 50 µs)
    max_clock_error: float = 50e-6
    # client-visible timeouts
    write_timeout: float = 2.0
    read_timeout: float = 2.0
    batch_max_entries: int = 128

    @property
    def delta(self) -> float:
        return self.lease_duration if self.lease_duration is not None else self.election_timeout


@dataclass
class SimParams:
    seed: int = 1
    one_way_latency_mean: float = 191e-6    # AWS same-subnet (paper §6.5)
    one_way_latency_variance: float = 391e-6 ** 2
    io_service_time: float = 0.0            # >0 models I/O contention (Figs. 9-11)
    sim_duration: float = 3.0
    # workload (open loop, paper §6.3-6.6)
    interarrival: float = 300e-6            # mean gap between client arrivals
    write_fraction: float = 1.0 / 3.0
    n_keys: int = 1000
    zipf_a: float = 0.0                     # 0 = uniform
    value_size: int = 1024
    # fraction of reads routed to a non-leader replica (only useful with a
    # policy that can serve them, e.g. ReadMode.FOLLOWER_READ)
    follower_read_fraction: float = 0.0
