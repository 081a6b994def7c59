"""Follower reads routed through the leader's lease state.

The leader runs full LeaseGuard (this class subclasses
:class:`LeaseGuardPolicy`, so leader-local reads, the commit gate and
lease upkeep are unchanged). A *follower* serves a read locally after
one light RPC to the leader:

1. follower -> leader: ``ReadIndexRequest(key)``;
2. the leader validates its lease for that key — the same zero-roundtrip
   barrier it would apply to a local read, including the §3.3 limbo
   check — and returns ``readIndex = commitIndex`` plus the barrier
   timestamp;
3. the follower waits until ``lastApplied >= readIndex`` and serves the
   state **as of readIndex**, linearized at the barrier time.

Linearizable because any write committed before the read was issued has
index <= the leader's commitIndex at barrier time (the lease rules out a
newer leader having committed past it), and the follower only answers
once it has applied at least that far. Compared with serving every read
on the leader this trades one cheap RPC for moving the read data path —
state-machine access and the value transfer — off the leader.

Two details matter for the linearization point (the nemesis matrix
caught both as real stale-read bugs):

* the follower must NOT serve its *current* applied state stamped with
  the *serve* time: the leader may have committed more entries between
  the barrier and the serve, so claiming a serve-time linearization
  point orders those committed writes before a read that cannot see
  them. The read linearizes at the **barrier** — every write committed
  before the barrier has index <= readIndex, every later commit has a
  later timestamp;
* symmetrically, the value must be cut at readIndex even if the
  follower has already applied further entries, or the read would
  observe writes from after its own linearization point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.raft import ReadResult
from ..core.simulate import TimeoutError_, wait_for
from .leaseguard import LeaseGuardPolicy


@dataclass
class ReadIndexRequest:
    term: int
    key: str


@dataclass
class ReadIndexReply:
    term: int
    ok: bool
    read_index: int = 0
    barrier_ts: float = 0.0     # leader time at barrier = linearization point
    error: str = ""


class FollowerReadPolicy(LeaseGuardPolicy):
    name = "follower_read"

    @classmethod
    def bench_variants(cls) -> dict[str, dict]:
        # one row (the LeaseGuard ablations belong to the parent policy);
        # route a slice of workload reads to followers so the benchmark
        # actually exercises the read-index RPC path, not just the
        # inherited leader path
        return {cls.name: {"sim_params": {"follower_read_fraction": 0.3}}}

    # ------------------------------------------------------- leader side
    def on_message(self, src: int, msg: Any) -> Any:
        if isinstance(msg, ReadIndexRequest):
            n = self.node
            if msg.term > n.term:
                n._step_down(msg.term)
                return ReadIndexReply(n.term, False, error="not_leader")
            if not n.is_leader():
                return ReadIndexReply(n.term, False, error="not_leader")
            err = self._read_barrier(msg.key)
            if err:
                return ReadIndexReply(n.term, False, error=err)
            return ReadIndexReply(n.term, True, read_index=n.commit_index,
                                  barrier_ts=n.loop.now)
        return None

    # ----------------------------------------------------- follower side
    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        if n.is_leader():
            return await super().gate_read(key)
        lid = n.leader_hint
        if lid is None or lid == n.id:
            return ReadResult(False, error="not_leader")
        try:
            reply: ReadIndexReply = await wait_for(
                n.net.call(n.id, lid, ReadIndexRequest(n.term, key)),
                n.p.rpc_timeout)
        except TimeoutError_:
            return ReadResult(False, error="timeout")
        if reply is None or not isinstance(reply, ReadIndexReply):
            return ReadResult(False, error="no_reply")
        if reply.term > n.term:
            n._step_down(reply.term)
        if not reply.ok:
            return ReadResult(False, error=reply.error)
        # serve the state AS OF the read index, linearized at the barrier
        return await self._serve_when_applied(
            key, reply.read_index, as_of_index=True,
            execution_ts=reply.barrier_ts)
