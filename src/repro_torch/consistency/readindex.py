"""ReadIndex: Raft's batched read barrier (Ongaro's dissertation §6.4).

Like quorum reads, the leader proves it is still leader with an empty
AppendEntries round before serving — but the proof is *shared*: the
leader records ``readIndex = commitIndex`` at read arrival, and every
read that arrives while a confirmation round is pending joins the next
round instead of starting its own. A burst of N concurrent reads costs
O(1) rounds instead of N, which is the whole advantage over QUORUM on
read-heavy workloads.

Safety detail: a read may only rely on a round that *started at or
after* the read arrived — an older in-flight round cannot rule out a
depose that happened just before this read. Late arrivals therefore
wait out the stale round and share the fresh one that follows.
"""

from __future__ import annotations

from typing import Optional

from ..core.raft import ReadResult
from ..core.simulate import Future
from .base import ConsistencyPolicy


class ReadIndexPolicy(ConsistencyPolicy):
    name = "readindex"

    def __init__(self, node) -> None:
        super().__init__(node)
        # in-flight / last-finished confirmation: (started_at, done-future)
        self._round: Optional[tuple[float, Future]] = None

    def on_become_leader(self) -> None:
        self._round = None

    async def _confirmed_after(self, arrival: float) -> bool:
        """True once a leadership round that started at/after ``arrival``
        succeeded; batches concurrent callers onto one round."""
        n = self.node
        while True:
            rnd = self._round
            if rnd is not None and rnd[0] >= arrival:
                if rnd[1].done():
                    return rnd[1].result()
                return await rnd[1]
            if rnd is not None and not rnd[1].done():
                # a round from before our arrival is in flight: wait it out,
                # then share the fresh round one of the waiters starts
                await rnd[1]
                continue
            done = Future(n.loop)
            self._round = (n.loop.now, done)
            ok = await self._confirm_leadership()
            done.set_result(ok)
            return ok

    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        if not n.is_leader():
            return ReadResult(False, error="not_leader")
        term0 = n.term
        # dissertation §6.4 step 1: commitIndex only covers every acked
        # write once an own-term entry (the election no-op) has committed —
        # a fresh leader's commitIndex may lag writes the old leader acked.
        deadline = n.loop.now + n.p.read_timeout
        while n.is_leader() and n.term == term0 and \
                n.log[n.commit_index].term != n.term:
            if n.loop.now >= deadline:
                return ReadResult(False, error="timeout")
            await n._cond_wait(deadline)
        if not n.is_leader() or n.term != term0:
            return ReadResult(False, error="not_leader")
        read_index = n.commit_index  # the ReadIndex
        if not await self._confirmed_after(n.loop.now):
            return ReadResult(False, error="no_quorum")
        if not n.is_leader() or n.term != term0:
            return ReadResult(False, error="not_leader")
        return await self._serve_when_applied(key, read_index,
                                              leader_term=term0)
