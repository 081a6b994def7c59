"""LeaseGuard: the log is the lease (paper §3, Fig. 2).

Entries carry ``intervalNow()`` from the writing leader's
bounded-uncertainty clock. The three pieces:

* **commit gate** (Fig. 2 CommitEntry): a new leader must not commit
  while any prior-term entry is possibly < Δ old — O(1) via a cached
  newest-prior-term index (§7.1);
* **read gate**: reads are local while the newest committed entry is
  provably < Δ old, with the limbo-region check for inherited leases
  (§3.3) — keys written between the old leader's last advertised
  commitIndex and its last appended entry cannot be served until an
  own-term entry commits;
* **optimizations** (§3.2/§3.3): deferred-commit writes (accept and
  replicate during the old lease, ack when it expires) and
  inherited-lease reads, each behind a RaftParams flag so the paper's
  log_lease / defer_commit ablations are this same policy.
"""

from __future__ import annotations

from ..core.raft import END_LEASE, NOOP, ReadResult
from .base import ConsistencyPolicy


class LeaseGuardPolicy(ConsistencyPolicy):
    name = "leaseguard"

    def __init__(self, node) -> None:
        super().__init__(node)
        self.limbo_keys: set[str] = set()
        self.last_prior_term_index = 0
        self._recheck_scheduled = False

    @classmethod
    def bench_variants(cls) -> dict[str, dict]:
        # the paper's Figs. 7/9 ablation ladder
        return {
            "log_lease": dict(defer_commit_writes=False,
                              inherited_lease_reads=False),
            "defer_commit": dict(defer_commit_writes=True,
                                 inherited_lease_reads=False),
            "leaseguard": {},
        }

    # ------------------------------------------------------------ leadership
    def on_become_leader(self) -> None:
        n = self.node
        # limbo region: (commitIndex, last log index at election]  (§3.3)
        self.limbo_keys = {
            n.log[i].key
            for i in range(n.commit_index + 1, n.last_index_at_election + 1)
            if not n.log[i].is_control
        }
        # O(1) commit-gate cache (§7.1): newest prior-term entry
        self.last_prior_term_index = 0
        for i in range(n.last_log_index, -1, -1):
            if n.log[i].term < n.term:
                self.last_prior_term_index = i
                break
        tr = n.loop.tracer
        if tr is not None:
            # window derived from values already in hand — no clock reads,
            # so tracing never perturbs the PRNG draw order
            e = n.log[n.commit_index]
            tr.emit("lease", node=n.id, term=n.term, parent=n._trace_ctx,
                    op="acquire", entry_term=e.term,
                    until=e.interval.latest + n.p.delta,
                    limbo=len(self.limbo_keys))

    # ------------------------------------------------------------ commit gate
    def gate_commit(self) -> bool:
        n = self.node
        i = self.last_prior_term_index
        if i == 0:
            return False
        e = n.log[i]
        if e.key == END_LEASE and \
                e.term == n.log[n.last_index_at_election].term:
            # planned handover (§5.1): prior leader relinquished its lease.
            return False
        return not n.clock.definitely_older_than(e.interval, n.p.delta)

    def on_commit_blocked(self) -> None:
        if self._recheck_scheduled:
            return
        self._recheck_scheduled = True
        n = self.node
        e = n.log[self.last_prior_term_index]
        tr = n.loop.tracer
        if tr is not None:
            tr.emit("lease", node=n.id, term=n.term, parent=n._trace_ctx,
                    op="gate_blocked", entry_term=e.term,
                    until=e.interval.latest + n.p.delta)
        eta = max(0.0, e.interval.latest + n.p.delta - n.loop.now) \
            + 2 * n.clock.max_error + 1e-6

        def recheck() -> None:
            self._recheck_scheduled = False
            n._try_advance_commit()

        n.loop.call_later(eta, recheck)

    def gate_write(self) -> str:
        if not self.node.p.defer_commit_writes and self.gate_commit():
            # unoptimized log-based lease: refuse writes during the old lease
            return "no_lease"
        return ""

    def on_commit_advanced(self) -> None:
        n = self.node
        if self.limbo_keys and n.log[n.commit_index].term == n.term:
            self.limbo_keys = set()  # own-term commit ends limbo
        tr = n.loop.tracer
        if tr is not None:
            e = n.log[n.commit_index]
            tr.emit("lease", node=n.id, term=n.term, parent=n._trace_ctx,
                    op="extend", entry_term=e.term,
                    until=e.interval.latest + n.p.delta)

    def holds_lease(self) -> bool:
        """Invariant probe (tests only): could this node serve a local read
        right now, ignoring limbo keys? True iff it is the leader and the
        newest committed entry's lease is still valid under its own
        bounded-uncertainty clock. Safety demands this is never
        simultaneously true on two nodes."""
        n = self.node
        return (n.alive and n.is_leader()
                and n.clock.lease_valid(n.log[n.commit_index].interval,
                                        n.p.delta))

    # -------------------------------------------------------------- read gate
    def _read_barrier(self, key: str) -> str:
        """Lease + limbo checks; non-empty string = reject reason."""
        n = self.node
        e = n.log[n.commit_index]
        if not n.clock.lease_valid(e.interval, n.p.delta):
            return "no_lease"
        if e.term != n.term:
            # inherited lease (§3.3)
            if not n.p.inherited_lease_reads:
                return "no_lease"
            if key in self.limbo_keys:
                return "limbo"
        return ""

    async def gate_read(self, key: str) -> ReadResult:
        n = self.node
        if not n.is_leader():
            return ReadResult(False, error="not_leader")
        err = self._read_barrier(key)
        if err:
            return ReadResult(False, error=err)
        term0 = n.term

        def recheck():
            e2 = self._read_barrier(key)
            return ReadResult(False, error=e2) if e2 else None

        return await self._local_read(key, term0, recheck=recheck)

    # ------------------------------------------------------------ lease upkeep
    async def maintenance_task(self, epoch: int) -> None:
        """Proactive lease extension (§5.1): append a no-op before expiry."""
        n = self.node
        if not n.p.lease_maintenance:
            return
        interval = max(n.p.delta / 4.0, 2 * n.p.heartbeat_interval)
        while n.alive and n.state == "leader" and n._leader_epoch == epoch:
            await n.loop.sleep(interval)
            if not (n.alive and n.state == "leader"
                    and n._leader_epoch == epoch):
                return
            e = n.log[n.commit_index]
            # refresh when the lease is past half its life and nothing newer
            # is in flight to extend it
            if n.last_log_index == n.commit_index and \
                    n.clock.possibly_older_than(e.interval, n.p.delta / 2):
                n._append_local(NOOP, None)
