"""Open-loop workload clients + history records (paper §6.1-6.3).

Each client performs one operation against the node it believes is the
leader (client-server latency is zero, as in the paper's Q1/Q2 setups).
Workload generators are *open loop*: arrivals follow a Poisson process
regardless of response latency [45].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .params import SimParams
from .prob import PRNG, Zipf
from .raft import Node
from .simulate import EventLoop


@dataclass(slots=True)
class ClientLogEntry:
    """One operation in the history (paper §6.2)."""
    op_type: str                 # "ListAppend" | "Read"
    start_ts: float
    execution_ts: Optional[float]
    end_ts: float
    key: str
    value: object                # appended value, or list returned by Read
    success: bool
    error: str = ""


class Directory:
    """Shared leader hint: nodes report leadership; clients consult it."""

    def __init__(self) -> None:
        self.leader_id: Optional[int] = None
        self.leader_term = -1
        #: bumps on every leadership announcement (even stale-term ones);
        #: lets ``Cluster.wait_for_leader`` block on the event instead of
        #: polling the node set every 10 ms
        self.announcements = 0

    def on_leader(self, node_id: int, term: int) -> None:
        self.announcements += 1
        if term >= self.leader_term:
            self.leader_id = node_id
            self.leader_term = term


class Workload:
    def __init__(self, loop: EventLoop, nodes: dict[int, Node],
                 directory: Directory, prng: PRNG, sim: SimParams) -> None:
        self.loop = loop
        self.nodes = nodes
        self.directory = directory
        self.prng = prng
        self.sim = sim
        self.zipf = Zipf(sim.n_keys, sim.zipf_a) if sim.zipf_a > 0 else None
        self.history: list[ClientLogEntry] = []
        self._entry_refs: list = []   # (record, LogEntry) for late commits
        self._value_seq = 0
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    def finalize(self) -> list[ClientLogEntry]:
        """Refresh append commit times from the shared log entries."""
        for rec, entry in self._entry_refs:
            rec.execution_ts = entry.execution_ts
        return self.history

    def _pick_key(self) -> str:
        if self.zipf is not None:
            return f"k{self.zipf.sample(self.prng)}"
        return f"k{self.prng.randint(0, self.sim.n_keys - 1)}"

    async def run(self, duration: float) -> None:
        """Spawn one-op clients by Poisson arrivals for ``duration`` seconds."""
        end = self.loop.now + duration
        while self.loop.now < end and not self._stop:
            gap = self.prng.exponential(self.sim.interarrival)
            await self.loop.sleep(gap)
            if self.loop.now >= end or self._stop:
                break
            is_write = self.prng.random() < self.sim.write_fraction
            key = self._pick_key()
            if is_write:
                self._value_seq += 1
                self.loop.create_task(self._one_write(key, self._value_seq))
            else:
                self.loop.create_task(self._one_read(key))

    def _leader_node(self) -> Optional[Node]:
        lid = self.directory.leader_id
        if lid is None:
            return None
        return self.nodes.get(lid)

    async def _one_write(self, key: str, value: int) -> None:
        start = self.loop.now
        node = self._leader_node()
        if node is None or not node.alive:
            self.history.append(ClientLogEntry(
                "ListAppend", start, None, self.loop.now, key, value, False,
                "no_leader"))
            return
        res = await node.client_write(key, value)
        # Execution time = when the write was committed on the leader (§6.2).
        # We hold the shared LogEntry object: if the write commits *later*
        # (e.g. after a failover), finalize() picks up its commit time, which
        # resolves the paper's failed-append ambiguity omnisciently.
        rec = ClientLogEntry(
            "ListAppend", start,
            res.entry.execution_ts if res.entry is not None else None,
            self.loop.now, key, value, res.ok, res.error)
        self.history.append(rec)
        if res.entry is not None:
            self._entry_refs.append((rec, res.entry))

    def _read_target(self) -> Optional[Node]:
        """Usually the leader; with ``follower_read_fraction`` > 0, a random
        live non-leader replica (for policies that can serve follower reads).
        The fraction==0 path makes no PRNG draws, so existing seeds replay
        identically."""
        leader = self._leader_node()
        frac = self.sim.follower_read_fraction
        if frac <= 0.0 or self.prng.random() >= frac:
            return leader
        others = [n for _, n in sorted(self.nodes.items())
                  if n.alive and n is not leader]
        if not others:
            return leader
        return others[self.prng.randint(0, len(others) - 1)]

    async def _one_read(self, key: str) -> None:
        start = self.loop.now
        node = self._read_target()
        if node is None or not node.alive:
            self.history.append(ClientLogEntry(
                "Read", start, None, self.loop.now, key, None, False,
                "no_leader"))
            return
        res = await node.client_read(key)
        self.history.append(ClientLogEntry(
            "Read", start, res.execution_ts if res.ok else None,
            self.loop.now, key, res.value, res.ok, res.error))
