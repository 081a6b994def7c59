"""Pluggable consistency layer: one module per mechanism (paper §6-§7).

``ReadMode`` (repro.core.params) stays the user-facing switch; this
package owns the mapping from mode to policy implementation. The
replication core (repro.core.raft) delegates every consistency decision
— commit gating, read serving, vote delays, lease upkeep, extra RPCs —
to the node's policy object.

Adding a mechanism is a one-file drop-in:

1. subclass :class:`ConsistencyPolicy` in a new module here,
2. add a ``ReadMode`` value whose string equals the policy's ``name``,
3. add one ``REGISTRY`` entry below.

Benchmarks, the coordinator, and the conformance tests iterate the
registry, so the new mechanism shows up everywhere automatically.
"""

from __future__ import annotations

from ..core.params import ReadMode
from .base import ConsistencyPolicy
from .follower import FollowerReadPolicy, ReadIndexReply, ReadIndexRequest
from .inconsistent import InconsistentPolicy
from .leaseguard import LeaseGuardPolicy
from .ongaro import OngaroLeasePolicy
from .quorum import QuorumPolicy
from .readindex import ReadIndexPolicy

#: mode -> policy class; iteration order is the canonical benchmark order.
REGISTRY: dict[ReadMode, type[ConsistencyPolicy]] = {
    ReadMode.INCONSISTENT: InconsistentPolicy,
    ReadMode.QUORUM: QuorumPolicy,
    ReadMode.ONGARO_LEASE: OngaroLeasePolicy,
    ReadMode.LEASEGUARD: LeaseGuardPolicy,
    ReadMode.READ_INDEX: ReadIndexPolicy,
    ReadMode.FOLLOWER_READ: FollowerReadPolicy,
}


def make_policy(node) -> ConsistencyPolicy:
    """Instantiate the policy selected by ``node.p.read_mode``."""
    try:
        cls = REGISTRY[node.p.read_mode]
    except KeyError:
        raise ValueError(
            f"no consistency policy registered for {node.p.read_mode!r}"
        ) from None
    return cls(node)


def resolve_read_mode(mode) -> ReadMode:
    """Accept a ReadMode, a policy-name string, or a policy class."""
    if isinstance(mode, ReadMode):
        return mode
    if isinstance(mode, type) and issubclass(mode, ConsistencyPolicy):
        for m, cls in REGISTRY.items():
            if cls is mode:
                return m
        raise ValueError(f"policy class {mode.__name__} is not registered")
    if isinstance(mode, str):
        return ReadMode(mode)
    raise ValueError(f"unknown consistency mode {mode!r}")


def benchmark_configs(variants: bool = True) -> dict[str, dict]:
    """name -> benchmark config, one entry per benchmark row.

    A config is RaftParams kwargs, except for the optional ``sim_params``
    key: SimParams overrides a policy needs to be exercised meaningfully
    (e.g. follower_read routes a slice of reads to followers). Consumers
    split the two with :func:`split_bench_config`.

    ``variants=True`` includes per-policy flag variants (the paper's
    log_lease / defer_commit ablation ladder); ``variants=False`` yields
    exactly one config per registered policy.
    """
    out: dict[str, dict] = {}
    for mode, cls in REGISTRY.items():
        vs = cls.bench_variants()
        if not variants:
            # keep only the policy's canonical config (named after it)
            vs = {cls.name: vs.get(cls.name, {})}
        for name, flags in vs.items():
            out[name] = dict(read_mode=mode, **flags)
    return out


def split_bench_config(config: dict) -> tuple[dict, dict]:
    """Split a :func:`benchmark_configs` entry into
    (RaftParams kwargs, SimParams kwargs)."""
    raft = dict(config)
    sim = raft.pop("sim_params", {})
    return raft, sim


__all__ = [
    "ConsistencyPolicy", "FollowerReadPolicy", "InconsistentPolicy",
    "LeaseGuardPolicy", "OngaroLeasePolicy", "QuorumPolicy",
    "ReadIndexPolicy", "ReadIndexReply", "ReadIndexRequest", "REGISTRY",
    "ReadMode", "benchmark_configs", "make_policy", "resolve_read_mode",
    "split_bench_config",
]
