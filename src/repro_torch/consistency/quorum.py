"""Quorum reads: Raft's default consistency (paper §6, "quorum").

Every read pays one majority round (an empty AppendEntries barrier) to
confirm the node is still leader, then waits for its applied state to
catch up to the commit index observed at arrival. Linearizable, but each
read costs a full round trip and competes with replication for I/O —
the effect behind the paper's Figs. 9-11 throughput gap.
"""

from __future__ import annotations

from ..core.raft import ReadResult
from .base import ConsistencyPolicy


class QuorumPolicy(ConsistencyPolicy):
    name = "quorum"

    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        if not n.is_leader():
            return ReadResult(False, error="not_leader")
        term0 = n.term
        if not await self._confirm_leadership():
            return ReadResult(False, error="no_quorum")
        return await self._local_read(key, term0)
