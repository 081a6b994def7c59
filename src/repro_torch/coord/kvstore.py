"""In-process coordination service: a LeaseGuard Raft replica set driven
by a crank adapter.

The deterministic simulator (repro.core) models time explicitly; the
trainer lives in wall-clock time. The adapter bridges them: each client
call cranks the simulated event loop forward until the operation's future
resolves (or a simulated timeout passes). One simulated replica set =
one coordination service; fault injection (crash_leader, partition) is
exposed for tests, examples, and failover drills.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Union

from ..consistency import resolve_read_mode
from ..core import (Cluster, RaftParams, ReadMode, SimParams, build_cluster)
from ..core.prob import PRNG
from ..core.raft import Node, ReadResult, WriteResult
from ..core.simulate import TimeoutError_, wait_for


class CoordinatorError(RuntimeError):
    pass


class CoordClient:
    """Event-loop-native client path: awaitable KV operations for actors
    that live *on* the simulated loop (the fleet simulator's training
    workers), beside the crank-based :class:`LocalCoordinator` for
    wall-clock callers. Any number of clients can have operations in
    flight concurrently; values share the coordinator's JSON encoding so
    both paths read each other's keys.

    Operations retry across leader failovers until an op deadline, then
    report failure instead of raising — a worker that cannot reach the
    control plane keeps training (the paper's point: polls are advisory,
    not on the critical path). ``append`` stops retrying the moment an
    attempt is *ambiguous* (an entry was appended but not confirmed)
    unless the record is idempotent; non-idempotent callers confirm by
    reading back, which is how the fleet chief avoids duplicate manifests.

    ``read_any_fraction`` routes that fraction of reads to a random live
    non-leader replica (same idiom as the workload's
    ``follower_read_fraction``) — used to model clients of the
    ``inconsistent`` policy actually hitting stale replicas.
    """

    def __init__(self, cluster: Cluster, prng: Optional[PRNG] = None,
                 op_timeout: float = 0.5, retry_delay: float = 0.05,
                 read_any_fraction: float = 0.0) -> None:
        self.cluster = cluster
        self.prng = prng
        self.op_timeout = op_timeout
        self.retry_delay = retry_delay
        self.read_any_fraction = read_any_fraction
        self.appends_ok = 0
        self.appends_failed = 0
        self.reads_ok = 0
        self.reads_failed = 0
        self.retries = 0

    @property
    def loop(self):
        return self.cluster.loop

    @staticmethod
    def decode(raw: list) -> list:
        return [json.loads(v) for v in raw]

    def _leader_node(self) -> Optional[Node]:
        lid = self.cluster.directory.leader_id
        if lid is None:
            return None
        node = self.cluster.nodes.get(lid)
        if node is None or not node.alive:
            return None
        return node

    def _read_target(self) -> Optional[Node]:
        leader = self._leader_node()
        frac = self.read_any_fraction
        if frac <= 0.0 or self.prng is None or self.prng.random() >= frac:
            return leader
        others = [n for _, n in sorted(self.cluster.nodes.items())
                  if n.alive and n is not leader]
        if not others:
            return leader
        return others[self.prng.randint(0, len(others) - 1)]

    async def append(self, key: str, value: Any, idempotent: bool = False,
                     timeout: Optional[float] = None) -> WriteResult:
        """Replicated append; returns the raft :class:`WriteResult` (the
        caller may hold ``.entry`` — its ``execution_ts`` resolves
        ambiguous outcomes omnisciently, as the workload checker does).
        Retries safe failures (nothing appended) until the deadline;
        ambiguous failures retry only when ``idempotent=True``."""
        payload = json.dumps(value)
        deadline = self.loop.now + (self.op_timeout if timeout is None
                                    else timeout)
        last = WriteResult(False, "unavailable")
        while True:
            node = self._leader_node()
            if node is not None:
                try:
                    last = await wait_for(
                        self.loop.create_task(node.client_write(key, payload)),
                        max(1e-9, deadline - self.loop.now))
                except TimeoutError_:
                    # The in-flight write may still commit; it is ambiguous
                    # but we no longer hold its entry — callers confirm by
                    # reading back.
                    last = WriteResult(False, "client_timeout")
                if last.ok:
                    self.appends_ok += 1
                    return last
                ambiguous = last.entry is not None or last.error == "client_timeout"
                if ambiguous and not idempotent:
                    self.appends_failed += 1
                    return last
            if self.loop.now >= deadline:
                self.appends_failed += 1
                return last
            self.retries += 1
            await self.loop.sleep(self.retry_delay)

    async def read_raw(self, key: str,
                       timeout: Optional[float] = None) -> ReadResult:
        """Read via the configured policy; ``.value`` is the raw (encoded)
        list — ``decode()`` it, or scan it lazily from the tail."""
        deadline = self.loop.now + (self.op_timeout if timeout is None
                                    else timeout)
        while True:
            node = self._read_target()
            if node is not None:
                try:
                    res = await wait_for(
                        self.loop.create_task(node.client_read(key)),
                        max(1e-9, deadline - self.loop.now))
                except TimeoutError_:
                    res = ReadResult(False, error="client_timeout")
                if res.ok:
                    self.reads_ok += 1
                    return res
            if self.loop.now >= deadline:
                self.reads_failed += 1
                return ReadResult(False, error="unavailable")
            self.retries += 1
            await self.loop.sleep(self.retry_delay)

    async def read_list(self, key: str,
                        timeout: Optional[float] = None) -> Optional[list]:
        """Decoded read, or None when the control plane is unavailable."""
        res = await self.read_raw(key, timeout=timeout)
        if not res.ok:
            return None
        return self.decode(res.value)

    def stats(self) -> dict:
        return {"appends_ok": self.appends_ok,
                "appends_failed": self.appends_failed,
                "reads_ok": self.reads_ok,
                "reads_failed": self.reads_failed,
                "retries": self.retries}


class LocalCoordinator:
    """Replicated, linearizable KV (append-only lists per key) with
    LeaseGuard zero-roundtrip reads by default; any policy from the
    ``repro.consistency`` registry can be selected by enum or name."""

    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 read_mode: Union[ReadMode, str] = ReadMode.LEASEGUARD,
                 lease_duration: float = 1.0) -> None:
        self.read_mode = resolve_read_mode(read_mode)
        raft = RaftParams(n_nodes=n_nodes, read_mode=self.read_mode,
                          election_timeout=0.5, heartbeat_interval=0.05,
                          lease_duration=lease_duration)
        sim = SimParams(seed=seed)
        self.cluster: Cluster = build_cluster(raft, sim)
        self.cluster.wait_for_leader()
        self.reads = 0
        self.read_messages = 0

    # -- crank ----------------------------------------------------------
    def _run(self, coro, max_sim_time: float = 30.0):
        loop = self.cluster.loop
        task = loop.create_task(coro)
        deadline = loop.now + max_sim_time
        while not task.done() and loop.now < deadline:
            loop.run_until(loop.now + 0.01)
        if not task.done():
            raise CoordinatorError("coordinator operation timed out")
        return task.result()

    def _leader(self):
        ldr = self.cluster.leader()
        if ldr is None or not ldr.alive:
            # crank until a leader exists (failover in progress)
            self.cluster.wait_for_leader()
            ldr = self.cluster.leader()
        if ldr is None:
            raise CoordinatorError("no leader")
        return ldr

    # -- public KV API ----------------------------------------------------
    def append(self, key: str, value: Any, retries: int = 5) -> None:
        """Linearizable durable write (committed through the Raft log)."""
        payload = json.dumps(value)
        for _ in range(retries):
            ldr = self._leader()
            res = self._run(ldr.client_write(key, payload))
            if res.ok:
                return
            # not_leader / no_lease / timeout: crank forward and retry
            self.cluster.loop.run_until(self.cluster.loop.now + 0.3)
        raise CoordinatorError(f"write failed after {retries} retries")

    def read_list(self, key: str, retries: int = 5) -> list:
        """Linearizable read — zero network roundtrips under LeaseGuard."""
        for _ in range(retries):
            ldr = self._leader()
            before = self.cluster.net.messages_sent
            res = self._run(ldr.client_read(key))
            if res.ok:
                self.reads += 1
                self.read_messages += self.cluster.net.messages_sent - before
                return [json.loads(v) for v in res.value]
            self.cluster.loop.run_until(self.cluster.loop.now + 0.3)
        raise CoordinatorError(f"read failed after {retries} retries")

    def read_latest(self, key: str) -> Optional[Any]:
        xs = self.read_list(key)
        return xs[-1] if xs else None

    # -- elastic scaling (paper §4.4 single-node reconfiguration) ---------
    def add_node(self, wait_for_promotion: bool = True,
                 max_sim_time: float = 30.0) -> int:
        """Add one fresh replica the safe way: it joins as a non-voting
        learner (receives and applies the log, counts toward nothing),
        and the leader promotes it to voter via an ordinary CONFIG entry
        once its match index covers the commit index."""
        new_id = max(self.cluster.nodes) + 1
        ldr = self._leader()
        self.cluster.spawn_node(new_id, ldr.p, learner=True)
        res = self._run(ldr.change_membership(
            set(ldr.config), learners=set(ldr.learners) | {new_id}))
        if not res.ok:
            raise CoordinatorError(f"add_node failed: {res.error}")
        if wait_for_promotion:
            loop = self.cluster.loop
            deadline = loop.now + max_sim_time
            while loop.now < deadline:
                ldr = self._leader()
                if new_id in ldr.config:
                    return new_id
                loop.run_until(loop.now + 0.05)
            raise CoordinatorError(f"node {new_id} was never promoted")
        return new_id

    def remove_node(self, node_id: int, retries: int = 5) -> None:
        """Remove ANY replica, the current leader included: removing the
        leader does a planned handover first (§5.1 end-lease, then step
        aside), waits for the successor, and retries the removal there."""
        for _ in range(retries):
            ldr = self._leader()
            if node_id not in ldr.config and node_id not in ldr.learners:
                return                          # already out
            if node_id == ldr.id:
                self.relinquish_leadership()    # handover, then retry below
                continue
            res = self._run(ldr.change_membership(
                set(ldr.config) - {node_id},
                learners=set(ldr.learners) - {node_id}))
            if res.ok:
                return
            self.cluster.loop.run_until(self.cluster.loop.now + 0.3)
        raise CoordinatorError(f"remove_node({node_id}) failed "
                               f"after {retries} retries")

    # legacy names for the same operations
    def scale_up(self) -> int:
        return self.add_node()

    def scale_down(self, node_id: int) -> None:
        self.remove_node(node_id)

    # -- fault injection ---------------------------------------------------
    def crash_leader(self) -> int:
        ldr = self._leader()
        ldr.crash()
        return ldr.id

    def restart_node(self, node_id: int) -> None:
        self.cluster.nodes[node_id].restart()

    def relinquish_leadership(self) -> None:
        """Planned handover (paper §5.1 end-lease)."""
        ldr = self._leader()
        ldr.relinquish_lease()
        self.cluster.loop.run_until(self.cluster.loop.now + 0.2)
        ldr.crash()

    def stats(self) -> dict:
        return {
            "consistency": self.read_mode.value,
            "reads": self.reads,
            "read_messages": self.read_messages,
            "messages_total": self.cluster.net.messages_sent,
            "leader": self.cluster.directory.leader_id,
            "term": self.cluster.directory.leader_term,
        }
