"""The ConsistencyPolicy interface: every consistency decision a node makes.

``Node`` (repro.core.raft) is pure Raft — replication and elections. One
policy instance per node answers the questions the replication core cannot
answer by itself:

* may the commit index advance right now?        ``gate_commit``
* may this client write be accepted right now?   ``gate_write``
* how is a client read served?                   ``gate_read``
* may this RequestVote be granted right now?     ``gate_vote``
* what background upkeep does leadership need?   ``maintenance_task``

plus event notifications (``on_become_leader``, ``on_commit_advanced``,
``on_commit_blocked``, ``on_append_response``) and an RPC extension point
(``on_message``) for policies that speak extra message types — e.g. the
follower-read policy's read-index exchange.

Policies are stateful: mechanism-specific leader state (limbo keys,
heartbeat ack times, in-flight read-index rounds) lives on the policy,
not on the node, and is re-derived in ``on_become_leader``.
"""

from __future__ import annotations

from typing import Any, Optional, TYPE_CHECKING

from ..core.raft import (AppendEntries, AppendEntriesReply, ReadResult,
                         RequestVote)
from ..core.simulate import TimeoutError_, wait_for

if TYPE_CHECKING:  # avoid a runtime import cycle with repro.core.raft
    from ..core.raft import Node


class ConsistencyPolicy:
    """Base class; subclasses override only the hooks they need.

    The defaults are maximally permissive (no lease, no vote delay, no
    commit gate) and ``gate_read`` is abstract — every mechanism must at
    least decide how a read is served.
    """

    #: registry key; must equal the corresponding ``ReadMode`` value.
    name = "base"

    def __init__(self, node: "Node") -> None:
        self.node = node

    # ------------------------------------------------------------ registry
    @classmethod
    def bench_variants(cls) -> dict[str, dict]:
        """Benchmark rows this policy contributes: name -> extra RaftParams
        kwargs. Default: a single row with no extra flags."""
        return {cls.name: {}}

    # ----------------------------------------------------------------- hooks
    def on_become_leader(self) -> None:
        """Called once per election win, after the node's leader volatile
        state is reset and before the election no-op is appended."""

    def gate_commit(self) -> bool:
        """True = the commit index must not advance yet (LeaseGuard's
        commit gate). Queried on every replication ack."""
        return False

    def on_commit_blocked(self) -> None:
        """Called when ``gate_commit`` vetoed a commit advance — the policy
        may schedule a recheck for when the gate should open."""

    def gate_write(self) -> str:
        """Non-empty string = refuse the client write with that error."""
        return ""

    def gate_vote(self, msg: RequestVote) -> bool:
        """True = withhold the vote (Ongaro leases delay elections)."""
        return False

    def on_commit_advanced(self) -> None:
        """Called on the leader after the applied index advanced."""

    def on_append_response(self, peer: int, sent_at: float) -> None:
        """Called on every successful AppendEntries ack; ``sent_at`` is the
        simulated time the RPC was issued (Ongaro's lease input)."""

    def on_quorum_lost(self) -> None:
        """Called just before a CheckQuorum step-down: the leader could
        not reach a voting majority within an election timeout and is
        about to relinquish leadership (and with it, serving its lease).
        Policies drop any leader-local serving state here."""

    def on_message(self, src: int, msg: Any) -> Any:
        """Handle a policy-specific RPC; return the reply or None."""
        return None

    async def maintenance_task(self, epoch: int) -> None:
        """Leader background task (e.g. proactive lease extension).
        Spawned once per leadership epoch; must exit when deposed."""
        return

    async def gate_read(self, key: str) -> ReadResult:
        raise NotImplementedError

    # ------------------------------------------------------- shared helpers
    async def _serve_when_applied(self, key: str, read_index: int,
                                  leader_term: Optional[int] = None,
                                  recheck=None, as_of_index: bool = False,
                                  execution_ts: Optional[float] = None,
                                  ) -> ReadResult:
        """Serve the local value once lastApplied >= ``read_index``. With
        ``leader_term``, abort if this node stops leading that term.
        ``recheck()`` (if given) re-validates the policy's read
        precondition after the wait; returning a ReadResult vetoes.

        ``as_of_index`` cuts the value at ``read_index`` (log-prefix
        state) instead of serving the current applied state, and
        ``execution_ts`` overrides the serve-time linearization point —
        follower reads use both to linearize at the leader's barrier."""
        n = self.node
        deadline = n.loop.now + n.p.read_timeout
        while n.alive:
            if leader_term is not None and (
                    not n.is_leader() or n.term != leader_term):
                return ReadResult(False, error="not_leader")
            if n.last_applied >= read_index:
                if recheck is not None:
                    veto = recheck()
                    if veto is not None:
                        return veto
                if as_of_index:
                    value = [e.value for e in n.log[1:read_index + 1]
                             if not e.is_control and e.key == key]
                else:
                    value = list(n.data.get(key, []))
                return ReadResult(
                    True, value,
                    execution_ts=n.loop.now if execution_ts is None
                    else execution_ts)
            if n.loop.now >= deadline:
                return ReadResult(False, error="timeout")
            await n._cond_wait(deadline)
        return ReadResult(False, error="not_leader")

    async def _local_read(self, key: str, term0: int,
                          recheck=None) -> ReadResult:
        """Wait lastApplied >= commitIndex-at-arrival, then read locally
        (paper Fig. 2 read tail)."""
        return await self._serve_when_applied(
            key, self.node.commit_index, leader_term=term0, recheck=recheck)

    async def _confirm_leadership(self) -> bool:
        """One empty-AppendEntries round: True iff a majority acked and we
        are still the same-term leader (Raft's read barrier)."""
        n = self.node
        tr = n.loop.tracer
        bid = None
        if tr is not None:
            bid = tr.emit("barrier", node=n.id, term=n.term,
                          parent=n._trace_ctx, op="start")
        term0 = n.term
        msg = n._make_append(n.last_log_index, [], n.commit_index)
        futs = [n.net.call(n.id, p, msg) for p in n.peers]
        acks = 1
        deposed = False
        for f in futs:
            try:
                reply: AppendEntriesReply = await wait_for(f, n.p.rpc_timeout)
            except TimeoutError_:
                continue
            if reply.term > n.term:
                n._step_down(reply.term)
                deposed = True
                break
            if reply.success:
                acks += 1
            if acks >= n.majority():
                break
        ok = (not deposed and acks >= n.majority()
              and n.term == term0 and n.is_leader())
        if tr is not None:
            tr.emit("barrier", node=n.id, term=n.term, parent=bid,
                    op="ok" if ok else "fail")
        return ok
