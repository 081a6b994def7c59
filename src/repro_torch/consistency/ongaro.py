"""Ongaro leases ([41] §6.4.1, as implemented in paper §7.1).

The leader holds a lease iff a majority of its last-successful
AppendEntries *start* times are less than ET old; while leased, reads
are served locally. Safety additionally requires followers to refuse to
vote within ET of hearing from a leader — which is why this mechanism
delays elections, the availability cost LeaseGuard avoids (paper §3
"Elections").
"""

from __future__ import annotations

from ..core.raft import ReadResult, RequestVote
from .base import ConsistencyPolicy


class OngaroLeasePolicy(ConsistencyPolicy):
    name = "ongaro_lease"

    def __init__(self, node) -> None:
        super().__init__(node)
        # peer -> start time of the last successful AppendEntries to it
        self.acked_at: dict[int, float] = {}

    def on_become_leader(self) -> None:
        self.acked_at = {}

    def on_append_response(self, peer: int, sent_at: float) -> None:
        self.acked_at[peer] = sent_at

    def gate_vote(self, msg: RequestVote) -> bool:
        # do not vote within ET of hearing from a leader ([41] §6.4.1);
        # LeaseGuard deliberately does NOT delay elections (paper §3).
        n = self.node
        return n.loop.now - n._last_heartbeat < n.p.election_timeout

    def has_lease(self) -> bool:
        n = self.node
        fresh = 1  # self counts as "now"
        for p in n.peers:
            s = self.acked_at.get(p)
            if s is not None and n.loop.now - s < n.p.election_timeout:
                fresh += 1
        return fresh >= n.majority()

    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        if not n.is_leader():
            return ReadResult(False, error="not_leader")
        if not self.has_lease():
            return ReadResult(False, error="no_lease")
        return await self._local_read(key, n.term)
