"""No consistency mechanism: local reads with no lease or barrier.

The paper's lower-bound baseline (§6): reads are as fast as possible and
as wrong as possible — any replica (a deposed leader that has not yet
heard of its successor, a lagging follower) happily serves whatever it
has applied. Useful to bound the cost every real mechanism pays, and the
positive control for the nemesis matrix: under partition scenarios this
policy MUST produce stale reads that ``check_linearizability`` flags.
"""

from __future__ import annotations

from ..core.raft import ReadResult
from .base import ConsistencyPolicy


class InconsistentPolicy(ConsistencyPolicy):
    name = "inconsistent"

    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        return ReadResult(True, list(n.data.get(key, [])),
                          execution_ts=n.loop.now)
