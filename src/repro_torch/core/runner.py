"""Build a replica set, run a workload, gather stats (paper run_with_params).

This is the entry point used by tests, benchmarks, and examples. Given
(RaftParams, SimParams, seed) it is fully deterministic.

Warm-start fast path
--------------------

Sweeps (``benchmarks/fault_matrix.py``, ``benchmarks/simperf.py``) run the
same (RaftParams, policy) cell over many seeds, and every cold run pays
for the same cluster boot + leader election before the workload starts.
:meth:`Cluster.snapshot` captures a post-election cluster as plain state
(logs with shared entries preserved, applied KV state, terms/votes, the
elected leader) and :meth:`ClusterSnapshot.restore` rehydrates it onto a
fresh event loop, re-asserting the leader's leadership at its snapshot
term and re-keying every PRNG stream with the target seed so each restored
run diverges per seed. ``run_workload(warm_start=True)`` amortizes one
snapshot per (RaftParams, SimParams-minus-seed) across all seeds.

A warm run is NOT bit-identical to the cold run of the same seed (the
boot phase is shared, and PRNG streams are re-keyed); it is deterministic
— the same (params, seed, warm_start=True) always replays identically —
and semantically equivalent: a settled cluster with an established leader
serving the same workload distribution. Cold runs are byte-for-byte
unaffected by the fast path.
"""

from __future__ import annotations

import copy
from dataclasses import astuple, dataclass, field, replace
from typing import Callable, Optional

from .checker import check_linearizability
from .client import ClientLogEntry, Directory, Workload
from .clock import BoundedClock
from .network import NetParams, Network
from .params import RaftParams, SimParams
from .prob import PRNG
from .raft import Node
from .simulate import EventLoop
from ..obs.metrics import Metrics
from ..obs.trace import Tracer


@dataclass
class Cluster:
    loop: EventLoop
    net: Network
    nodes: dict[int, Node]
    directory: Directory
    prng: PRNG

    def leader(self) -> Optional[Node]:
        lid = self.directory.leader_id
        return self.nodes.get(lid) if lid is not None else None

    def wait_for_leader(self, max_time: float = 10.0) -> Node:
        """Run the loop until some node is leader.

        Event-driven: blocks on :attr:`Directory.announcements` instead of
        polling every 10 ms, then aligns the clock to the historical 10 ms
        polling boundary — so the workload start time (and every PRNG draw
        after it) is bit-identical to the old polling loop."""
        loop = self.loop
        deadline = loop.now + max_time
        boundary = loop.now
        for n in self.nodes.values():       # warm restores: already led
            if n.is_leader():
                return n
        while loop.now < deadline:
            gen = self.directory.announcements
            while self.directory.announcements == gen and not loop._stopped:
                t = loop._next_time()
                if t is None or t > deadline:
                    # nothing left that could elect anyone before deadline
                    loop.run_until(deadline)
                    raise RuntimeError("no leader elected")
                loop._step()
            # replicate the old polling loop's accumulated 10 ms grid so
            # loop.now lands exactly where run_until(now + 0.01) would
            while boundary < loop.now:
                boundary += 0.01
            loop.run_until(boundary)
            for n in self.nodes.values():
                if n.is_leader():
                    return n
        raise RuntimeError("no leader elected")

    def spawn_node(self, node_id: int, raft: RaftParams,
                   max_clock_error: float = 50e-6,
                   learner: bool = True) -> Node:
        """Create a fresh node (elastic scaling; it joins the replica set
        once a leader appends the CONFIG entry that includes it). By
        default the newcomer considers itself a non-voting learner until
        a replicated CONFIG says otherwise — so it can never elect itself
        leader of a one-node 'cluster' before it is added."""
        from .clock import BoundedClock
        clock = BoundedClock(self.loop, self.prng.fork(600 + node_id),
                             max_clock_error)
        if learner:
            peers, learners = [], [node_id]
        else:
            peers, learners = [node_id], []
        node = Node(node_id, self.loop, self.net, clock,
                    self.prng.fork(700 + node_id), raft,
                    peers,            # adopts the real config from the log
                    on_leader=self.directory.on_leader, learners=learners)
        self.nodes[node_id] = node
        return node

    def snapshot(self) -> "ClusterSnapshot":
        """Capture the cluster's replicated + applied state for warm
        restarts. Meant to be taken at a quiescent point (post-election,
        pre-workload): in-flight RPCs and parked timers are deliberately
        NOT captured — :meth:`ClusterSnapshot.restore` regenerates the
        leader's replication machinery instead."""
        return ClusterSnapshot(self)


class ClusterSnapshot:
    """Plain-state capture of a booted cluster (see module docstring).

    ``restore(seed)`` rehydrates onto a fresh event loop: followers come
    back with their logs/terms/applied state, the snapshot leader
    re-asserts leadership at its snapshot term through the normal
    ``_become_leader`` path (fresh no-op, fresh replication tasks, fresh
    policy state — policy state is process-volatile by design), and every
    PRNG stream is re-keyed with ``seed`` for per-seed divergence."""

    def __init__(self, cluster: Cluster) -> None:
        self.now = cluster.loop.now
        self.net_params = replace(cluster.net.params)
        leader = None
        for nid, n in sorted(cluster.nodes.items()):
            if n.is_leader():
                leader = nid
                break
        self.leader_id = leader
        # one memo across all nodes: LogEntry objects shared between
        # replicas in the sim stay shared in the snapshot (and in every
        # restore), which the omniscient checker relies on
        memo: dict = {}
        self.raft = cluster.nodes[next(iter(cluster.nodes))].p
        self.nodes: dict[int, dict] = {}
        for nid, n in sorted(cluster.nodes.items()):
            self.nodes[nid] = {
                "term": n.term,
                "voted_for": n.voted_for,
                "log": copy.deepcopy(n.log, memo),
                "commit_index": n.commit_index,
                "last_applied": n.last_applied,
                "data": copy.deepcopy(n.data, memo),
                "config": set(n.config),
                "learners": set(n.learners),
                "leader_hint": n.leader_hint,
            }

    def restore(self, seed: int) -> Cluster:
        loop = EventLoop()
        loop.now = self.now
        # re-key every stream: same snapshot + same seed -> identical run,
        # different seeds -> divergent latencies/workload/clock draws
        root = PRNG((seed * 0x9E3779B97F4A7C15 + 0xB007) % 2**63)
        net = Network(loop, root.fork(101), replace(self.net_params))
        directory = Directory()
        ids = sorted(self.nodes)
        memo: dict = {}
        nodes: dict[int, Node] = {}
        for nid in ids:
            st = self.nodes[nid]
            clock = BoundedClock(loop, root.fork(200 + nid),
                                 self.raft.max_clock_error)
            node = Node(nid, loop, net, clock, root.fork(300 + nid),
                        self.raft, ids, on_leader=directory.on_leader)
            node.term = st["term"]
            node.voted_for = st["voted_for"]
            node.log = copy.deepcopy(st["log"], memo)
            node.commit_index = st["commit_index"]
            node.last_applied = st["last_applied"]
            node.data = copy.deepcopy(st["data"], memo)
            node.config = set(st["config"])
            node.learners = set(st["learners"])
            node.leader_hint = st["leader_hint"]
            nodes[nid] = node
        cluster = Cluster(loop, net, nodes, directory, root)
        if self.leader_id is not None:
            leader = nodes[self.leader_id]
            # re-assert leadership at the snapshot term: appends a fresh
            # no-op, spawns replication + policy maintenance, announces
            leader._become_leader()
            noop_index = leader.last_log_index
            # settle until the no-op applies on the leader (lease live),
            # mirroring what the tail of a cold boot provides
            deadline = loop.now + 10 * self.raft.heartbeat_interval
            while leader.is_leader() and leader.last_applied < noop_index:
                t = loop._next_time()
                if t is None or t > deadline:
                    break
                loop._step()
        if cluster.leader() is None or not cluster.leader().is_leader():
            cluster.wait_for_leader()   # contested snapshot: fall back
        return cluster


#: fixed seed for the shared boot phase of every warm-started cell
WARM_BOOT_SEED = 0xB007

_WARM_CACHE: dict[tuple, ClusterSnapshot] = {}
_WARM_CACHE_MAX = 64


def _warm_key(raft: RaftParams, sim: SimParams) -> tuple:
    return (astuple(raft), astuple(replace(sim, seed=0)))


def warm_cluster(raft: RaftParams, sim: SimParams) -> Cluster:
    """A post-election cluster for ``sim.seed``, amortizing one boot +
    election per (RaftParams, SimParams-minus-seed) across all seeds."""
    key = _warm_key(raft, sim)
    snap = _WARM_CACHE.get(key)
    if snap is None:
        boot = build_cluster(raft, replace(sim, seed=WARM_BOOT_SEED))
        boot.wait_for_leader()
        snap = boot.snapshot()
        if len(_WARM_CACHE) >= _WARM_CACHE_MAX:
            _WARM_CACHE.pop(next(iter(_WARM_CACHE)))
        _WARM_CACHE[key] = snap
    return snap.restore(sim.seed)


def clear_warm_cache() -> None:
    _WARM_CACHE.clear()


def build_cluster(raft: RaftParams, sim: SimParams,
                  clock_faults: Optional[dict[int, float]] = None) -> Cluster:
    loop = EventLoop()
    prng = PRNG(sim.seed)
    net = Network(loop, prng.fork(101), NetParams(
        one_way_latency_mean=sim.one_way_latency_mean,
        one_way_latency_variance=sim.one_way_latency_variance,
        io_service_time=sim.io_service_time,
        rpc_timeout=raft.rpc_timeout,
    ))
    directory = Directory()
    ids = list(range(raft.n_nodes))
    nodes = {}
    for i in ids:
        fault = (clock_faults or {}).get(i, 0.0)
        clock = BoundedClock(loop, prng.fork(200 + i), raft.max_clock_error,
                             faulty=fault != 0.0, fault_skew=fault)
        nodes[i] = Node(i, loop, net, clock, prng.fork(300 + i), raft, ids,
                        on_leader=directory.on_leader)
    return Cluster(loop, net, nodes, directory, prng)


@dataclass
class RunResult:
    history: list[ClientLogEntry]
    reads_ok: int = 0
    reads_fail: int = 0
    writes_ok: int = 0
    writes_fail: int = 0
    read_latencies: list[float] = field(default_factory=list)
    write_latencies: list[float] = field(default_factory=list)
    linearizable_ops: int = 0
    t_start: float = 0.0            # workload start (simulated seconds)
    t_end: float = 0.0              # end of run incl. settle time
    loop_stats: dict = field(default_factory=dict)
    net_stats: dict = field(default_factory=dict)
    #: cluster-aggregated protocol counters (terms, elections, evictions,
    #: checksum drops) — the gray-failure matrix's metrics
    raft_stats: dict = field(default_factory=dict)
    #: per-node breakdown of raft_stats (the aggregation above loses
    #: which node churned — this keeps the attribution)
    raft_by_node: dict = field(default_factory=dict)
    #: flight-recorder events (run_workload(trace=True)); None when off
    trace: Optional[list] = None
    #: the unified Metrics registry the three dicts above are views of
    metrics: Optional[object] = None

    def summarize(self) -> dict:
        import statistics as st

        def pct(xs, q):
            if not xs:
                return float("nan")
            xs = sorted(xs)
            k = min(len(xs) - 1, int(q * len(xs)))
            return xs[k]

        return {
            "reads_ok": self.reads_ok, "reads_fail": self.reads_fail,
            "writes_ok": self.writes_ok, "writes_fail": self.writes_fail,
            "read_p50": pct(self.read_latencies, 0.50),
            "read_p90": pct(self.read_latencies, 0.90),
            "write_p50": pct(self.write_latencies, 0.50),
            "write_p90": pct(self.write_latencies, 0.90),
            "read_mean": st.fmean(self.read_latencies) if self.read_latencies else float("nan"),
            "write_mean": st.fmean(self.write_latencies) if self.write_latencies else float("nan"),
        }


def _attach_warm_tracer(cluster: Cluster) -> Tracer:
    """Attach a tracer to a warm-restored cluster and seed it with the
    state the boot phase already established (which the tracer missed):
    the restored leader's role and, for lease-carrying policies, the
    serving window its election no-op opened. Uses only values already
    computed — zero PRNG draws."""
    tr = Tracer(cluster.loop)
    leader = cluster.leader()
    if leader is not None and leader.is_leader():
        ctx = tr.emit("role", node=leader.id, term=leader.term,
                      parent=None, role="leader", reason="warm_start")
        leader._trace_ctx = ctx
        pol = leader.policy
        if hasattr(pol, "last_prior_term_index"):
            e = leader.log[leader.commit_index]
            tr.emit("lease", node=leader.id, term=leader.term, parent=ctx,
                    op="acquire", entry_term=e.term,
                    until=e.interval.latest + leader.p.delta,
                    limbo=len(getattr(pol, "limbo_keys", ())))
    return tr


def run_workload(raft: RaftParams, sim: SimParams,
                 fault_script: Optional[Callable[[Cluster], None]] = None,
                 check: bool = True,
                 settle_time: float = 1.0,
                 warm_start: bool = False,
                 trace: bool = False) -> RunResult:
    """End-to-end deterministic run.

    ``fault_script(cluster)`` may schedule crashes/partitions on the loop
    before the workload starts (paper §6.5 crashes the leader at t=0.5s).

    ``warm_start=True`` skips the per-seed cluster boot + election by
    restoring a cached post-election snapshot (see module docstring);
    histories differ from the cold run of the same seed but remain fully
    deterministic per (params, seed).

    ``trace=True`` attaches the flight recorder (repro.obs): the returned
    result carries the full event list in ``.trace``. Tracing draws
    nothing from any PRNG, so the run's history is bit-identical with it
    on or off.
    """
    if warm_start:
        cluster = warm_cluster(raft, sim)
        if trace:
            _attach_warm_tracer(cluster)
    else:
        cluster = build_cluster(raft, sim)
        if trace:
            # before the boot election, so the trace captures it
            Tracer(cluster.loop)
        cluster.wait_for_leader()
    loop = cluster.loop
    t0 = loop.now
    workload = Workload(loop, cluster.nodes, cluster.directory,
                        cluster.prng.fork(999), sim)
    if fault_script is not None:
        fault_script(cluster)
    loop.create_task(workload.run(sim.sim_duration))
    loop.run_until(t0 + sim.sim_duration + settle_time)
    history = workload.finalize()

    metrics = Metrics.from_cluster(cluster)
    res = RunResult(history=history, t_start=t0, t_end=loop.now,
                    loop_stats=metrics.loop_stats(),
                    net_stats=metrics.net_stats(),
                    raft_stats=metrics.raft_stats(),
                    raft_by_node=metrics.raft_stats_by_node(),
                    trace=(loop.tracer.events
                           if loop.tracer is not None else None),
                    metrics=metrics)
    for op in history:
        lat = op.end_ts - op.start_ts
        if op.op_type == "Read":
            if op.success:
                res.reads_ok += 1
                res.read_latencies.append(lat)
            else:
                res.reads_fail += 1
        else:
            if op.success:
                res.writes_ok += 1
                res.write_latencies.append(lat)
            else:
                res.writes_fail += 1
    if check:
        res.linearizable_ops = check_linearizability(history)
    return res


def throughput_timeline(history: list[ClientLogEntry], bin_size: float,
                        t_start: float, t_end: float) -> list[dict]:
    """Per-bin successful read/write counts — the paper's availability plots."""
    n_bins = int((t_end - t_start) / bin_size) + 1
    bins = [{"t": t_start + i * bin_size, "reads": 0, "writes": 0,
             "read_fail": 0, "write_fail": 0} for i in range(n_bins)]
    for op in history:
        i = int((op.end_ts - t_start) / bin_size)
        if 0 <= i < n_bins:
            b = bins[i]
            if op.op_type == "Read":
                b["reads" if op.success else "read_fail"] += 1
            else:
                b["writes" if op.success else "write_fail"] += 1
    return bins
