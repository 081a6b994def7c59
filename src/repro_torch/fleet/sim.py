"""The fleet harness: N training workers + one Raft replica set on ONE
deterministic event loop.

``run_fleet(raft, sim, fleet_params, scenario)`` mirrors
``core.runner.run_workload``: build the cluster, elect a leader, install
the (fleet) scenario, start the workers, run for ``duration`` plus a
settle window, then audit omnisciently — the lineage checks off the
surviving replicas' Raft log, steps-lost / recovery-time around chief
and leader deaths, and the control-plane message load per worker step
(clients call replica methods directly, so every Network message is
intra-replica-set coordination: the quorum-poll bottleneck measured
exactly).

Everything is deterministic per (RaftParams, SimParams, FleetParams,
scenario): worker PRNGs fork off the cluster root *after* it is built,
so fleet runs never perturb the replica set's replay."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import json

from ..coord.kvstore import CoordClient
from ..coord.registry import REPORTS_KEY, straggler_flags_from
from ..core import RaftParams, SimParams, build_cluster
from ..core.runner import Cluster
from ..faults.base import Scenario
from .lineage import check_lineage, extract_fleet_log
from .worker import Worker


@dataclass
class FleetParams:
    n_workers: int = 8
    step_time: float = 0.02         # simulated seconds per training step
    step_jitter: float = 0.25       # uniform per-step jitter fraction
    ckpt_every: int = 5             # chief commits a manifest every N own steps
    poll_timeout: float = 0.15      # per-step checkpoint poll budget
    op_timeout: float = 0.4         # registry / commit / restore op budget
    retry_delay: float = 0.05
    heartbeat_period: float = 0.25
    report_every: int = 10          # step-time report cadence (steps)
    worker_ttl: float = 0.6         # liveness TTL for chief election
    chief_check_period: float = 0.18
    duration: float = 4.0
    settle: float = 1.0
    #: fraction of reads served by a random (possibly stale) replica —
    #: how clients of the ``inconsistent`` policy actually behave
    read_any_fraction: float = 0.0


class Fleet:
    """Owns the workers and the run-wide traces the checker consumes."""

    def __init__(self, cluster: Cluster, params: FleetParams) -> None:
        self.cluster = cluster
        self.p = params
        self.loop = cluster.loop
        self.running = False
        self.t0 = cluster.loop.now
        self.total_steps = 0
        self.ckpt_override: Optional[int] = None    # CheckpointStorm hook
        self.restores: list[dict] = []
        self.commit_log: list[tuple[float, int, bool]] = []
        self.last_ok_commit_step = -1
        self.chief_deaths: list[dict] = []
        self.trace: list[tuple[float, str]] = []
        self.workers: dict[str, Worker] = {}
        # forked AFTER build_cluster: the replica set's draw order (and
        # therefore every committed artifact) replays untouched
        for i in range(params.n_workers):
            w = Worker(self, i, cluster.prng.fork(1000 + i),
                       CoordClient(cluster, prng=cluster.prng.fork(1500 + i),
                                   op_timeout=params.op_timeout,
                                   retry_delay=params.retry_delay,
                                   read_any_fraction=params.read_any_fraction))
            self.workers[w.wid] = w

    def ckpt_every(self) -> int:
        return self.ckpt_override or self.p.ckpt_every

    def worker_order(self, wid: str) -> int:
        w = self.workers.get(wid)
        return w.index if w is not None else 10 ** 9

    def ordered_workers(self) -> list[Worker]:
        return sorted(self.workers.values(), key=lambda w: w.index)

    def note(self, event: str) -> None:
        self.trace.append((self.loop.now, event))
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("fleet", op="note", label=event)

    # -- traces ------------------------------------------------------------
    def record_restore(self, wid: str, kind: str, t_start: float,
                       t_end: float, manifest: Optional[dict],
                       gen: int) -> None:
        self.restores.append({"wid": wid, "kind": kind, "t_start": t_start,
                              "t_end": t_end, "manifest": manifest,
                              "gen": gen})
        tr = self.loop.tracer
        if tr is not None:
            step = manifest["step"] if manifest else -1
            tr.emit("fleet", op="restore", wid=wid, kind=kind, step=step)

    def record_commit(self, t: float, step: int, ok: bool) -> None:
        self.commit_log.append((t, step, ok))
        if ok and step > self.last_ok_commit_step:
            self.last_ok_commit_step = step
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("fleet", op="manifest", step=step, ok=ok)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.running = True
        self.t0 = self.loop.now
        for w in self.ordered_workers():
            w.start()

    def crash_worker(self, wid: str,
                     downtime: Optional[float] = None) -> bool:
        w = self.workers[wid]
        if not w.alive:
            return False
        if w.is_chief:
            self.chief_deaths.append({
                "t": self.loop.now, "wid": wid, "epoch": w.epoch,
                "local_step": w.local_step,
                "committed_step": self.last_ok_commit_step})
        self.note(f"worker {wid} crashed"
                  + (" (chief)" if w.is_chief else ""))
        w.crash()
        if downtime is not None:
            self.loop.call_later(downtime, lambda: self.start_worker(wid))
        return True

    def start_worker(self, wid: str) -> None:
        w = self.workers[wid]
        if w.alive or not self.running:
            return
        self.note(f"worker {wid} restarts")
        w.start()


@dataclass
class FleetResult:
    violations: list[dict]
    total_steps: int
    n_claims: int
    n_manifests: int
    n_valid_manifests: int
    restores: int
    stale_polls: int
    polls_ok: int
    polls_failed: int
    commits_ok: int
    commits_failed: int
    messages: int                   # network messages during the run
    messages_per_step: float
    chief_deaths: list[dict]        # each with steps_lost / recovery_time
    leader_recoveries: list[float]  # commit-recovery time per leader death
    max_commit_gap: float
    straggler_flags: dict = field(default_factory=dict)
    restores_detail: list = field(default_factory=list)
    trace: list = field(default_factory=list)
    events: list = field(default_factory=list)  # flight-recorder events

    def summarize(self) -> dict:
        return {
            "violations": len(self.violations),
            "violation_checks": sorted({v["check"] for v in self.violations}),
            "total_steps": self.total_steps,
            "claims": self.n_claims,
            "manifests": self.n_manifests,
            "valid_manifests": self.n_valid_manifests,
            "restores": self.restores,
            "stale_polls": self.stale_polls,
            "polls_ok": self.polls_ok,
            "polls_failed": self.polls_failed,
            "commits_ok": self.commits_ok,
            "commits_failed": self.commits_failed,
            "messages_per_step": round(self.messages_per_step, 3),
            "chief_deaths": len(self.chief_deaths),
            "steps_lost": [d["steps_lost"] for d in self.chief_deaths],
            "chief_recovery": [round(d["recovery_time"], 3)
                               if d["recovery_time"] is not None else None
                               for d in self.chief_deaths],
            "leader_recovery": [round(t, 3) for t in self.leader_recoveries],
            "max_commit_gap": round(self.max_commit_gap, 3),
            "stragglers_flagged": sorted(
                w for w, slow in self.straggler_flags.items() if slow),
        }


#: fault-trace markers that mean "the Raft leader just died"
_LEADER_DEATH_MARKS = ("start crash_restart[leader", "nemesis strikes leader")


def run_fleet(raft: RaftParams, sim: SimParams,
              fleet_params: Optional[FleetParams] = None,
              scenario: Optional[Scenario] = None,
              trace: bool = False) -> FleetResult:
    fp = fleet_params or FleetParams()
    cluster = build_cluster(raft, sim)
    if trace:
        # attach before the boot election so the trace starts at the root
        from ..obs import Tracer
        Tracer(cluster.loop)
    cluster.wait_for_leader()
    fleet = Fleet(cluster, fp)
    ctx = None
    if scenario is not None:
        install_fleet = getattr(scenario, "install_fleet", None)
        if install_fleet is not None:
            ctx = install_fleet(cluster, fleet)
        else:
            ctx = scenario.install(cluster)
    msgs0 = cluster.net.messages_sent
    fleet.start()
    loop = cluster.loop
    loop.run_until(fleet.t0 + fp.duration)
    fleet.running = False
    loop.run_until(loop.now + fp.settle)

    entries = extract_fleet_log(cluster)
    violations = check_lineage(entries, fleet.restores)
    ok_commits = sorted((t, s) for t, s, ok in fleet.commit_log if ok)

    def recovery_after(t: float) -> Optional[float]:
        for tc, _ in ok_commits:
            if tc > t:
                return tc - t
        return None

    chief_deaths = []
    for d in fleet.chief_deaths:
        chief_deaths.append(dict(
            d, steps_lost=max(0, d["local_step"] - d["committed_step"]),
            recovery_time=recovery_after(d["t"])))
    leader_recoveries = []
    if ctx is not None:
        for t, event in ctx.trace:
            if any(m in event for m in _LEADER_DEATH_MARKS):
                rec = recovery_after(t)
                if rec is not None:
                    leader_recoveries.append(rec)

    gap = 0.0
    prev_t = fleet.t0
    for tc, _ in ok_commits:
        gap = max(gap, tc - prev_t)
        prev_t = tc

    ws = list(fleet.workers.values())
    # the straggler table as the launcher would read it at run end
    auth = max(cluster.nodes.values(),
               key=lambda n: (n.alive, n.last_applied, -n.id))
    reports = [json.loads(v) for v in auth.data.get(REPORTS_KEY, [])]
    n_claims = sum(1 for rec, _ in entries if rec.get("kind") == "claim")
    n_manifests = sum(1 for rec, _ in entries
                      if rec.get("kind") == "manifest")
    from .lineage import LogView
    view = LogView()
    for rec, _ in entries:
        view.feed_one(rec)
    total = fleet.total_steps
    return FleetResult(
        violations=violations,
        total_steps=total,
        n_claims=n_claims,
        n_manifests=n_manifests,
        n_valid_manifests=len(view.valid),
        restores=len(fleet.restores),
        stale_polls=sum(w.stale_polls for w in ws),
        polls_ok=sum(w.polls_ok for w in ws),
        polls_failed=sum(w.polls_failed for w in ws),
        commits_ok=sum(w.commits_ok for w in ws),
        commits_failed=sum(w.commits_failed for w in ws),
        messages=cluster.net.messages_sent - msgs0,
        messages_per_step=(cluster.net.messages_sent - msgs0) / max(1, total),
        chief_deaths=chief_deaths,
        leader_recoveries=leader_recoveries,
        max_commit_gap=gap,
        straggler_flags=straggler_flags_from(reports),
        restores_detail=fleet.restores,
        trace=(ctx.trace if ctx is not None else []) + fleet.trace,
        events=(cluster.loop.tracer.events
                if cluster.loop.tracer is not None else []),
    )
