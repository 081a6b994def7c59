"""Pure Raft replication + elections; consistency is a pluggable policy.

:class:`Node` implements only the replication substrate — log append,
AppendEntries/RequestVote, commit counting, elections, membership changes.
Every *consistency* decision (how reads are served, whether commits or
votes must wait, lease upkeep) is delegated to a
:class:`repro.consistency.ConsistencyPolicy` selected by
``RaftParams.read_mode``: LeaseGuard's commit gate and limbo region
(paper §3, Fig. 2), Ongaro leases ([41] §6.4.1), quorum reads, ReadIndex
batching, follower reads, and inconsistent reads each live in their own
module under ``repro.consistency``.

The policy hook points in this file:

* ``_handle_vote``         -> ``policy.gate_vote``
* ``_become_leader``       -> ``policy.on_become_leader`` + ``maintenance_task``
* ``_replicate`` ack       -> ``policy.on_append_response``
* ``_try_advance_commit``  -> ``policy.gate_commit`` / ``on_commit_blocked``
* ``_apply_committed``     -> ``policy.on_commit_advanced``
* ``client_write``         -> ``policy.gate_write``
* ``client_read``          -> ``policy.gate_read``
* unknown RPC types        -> ``policy.on_message``
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .clock import BoundedClock, TimeInterval
from .network import Network
from .params import RaftParams
from .prob import PRNG
from .simulate import Condition, EventLoop, Future, TimeoutError_, wait_for

NOOP = "__noop__"
END_LEASE = "__end_lease__"
CONFIG = "__config__"          # single-node membership change (paper §4.4)


@dataclass(slots=True)
class LogEntry:
    term: int
    key: str                       # NOOP / END_LEASE for control entries
    value: Any
    interval: TimeInterval         # intervalNow() on the writing leader
    execution_ts: Optional[float] = None  # true time committed+applied on leader
    checksum: Optional[int] = None  # content checksum (RaftParams.entry_checksums)

    @property
    def is_control(self) -> bool:
        return self.key in (NOOP, END_LEASE, CONFIG)


# ---------------------------------------------------------------- messages
@dataclass(slots=True)
class RequestVote:
    term: int
    candidate: int
    last_log_index: int
    last_log_term: int


@dataclass(slots=True)
class VoteReply:
    term: int
    granted: bool


@dataclass(slots=True)
class AppendEntries:
    term: int
    leader: int
    prev_index: int
    prev_term: int
    entries: list
    leader_commit: int
    checksum: Optional[int] = None  # end-to-end digest (entry_checksums)


@dataclass(slots=True)
class PreVoteRequest:
    """Trial vote for ``term`` (= candidate's term + 1) that bumps NO
    term anywhere (Raft thesis §9.6): the candidate only campaigns for
    real once a majority signals it would win."""
    term: int
    candidate: int
    last_log_index: int
    last_log_term: int


@dataclass(slots=True)
class PreVoteReply:
    term: int
    granted: bool


def entry_checksum(term: int, key: str, value: Any) -> int:
    """Content checksum for one log entry (stable across replicas)."""
    return zlib.crc32(repr((term, key, value)).encode())


def append_digest(msg: "AppendEntries") -> int:
    """End-to-end digest over an AppendEntries' header fields and its
    entries' checksums — any in-flight field mutation breaks it."""
    return zlib.crc32(repr(
        (msg.term, msg.leader, msg.prev_index, msg.prev_term,
         msg.leader_commit, tuple(e.checksum for e in msg.entries))
    ).encode())


@dataclass(slots=True)
class AppendEntriesReply:
    term: int
    success: bool
    match_index: int


class WriteResult:
    __slots__ = ("ok", "error", "entry")

    def __init__(self, ok: bool, error: str = "",
                 entry: Optional["LogEntry"] = None) -> None:
        self.ok = ok
        self.error = error
        # The appended LogEntry object (shared across replicas in the sim):
        # its ``execution_ts`` is set iff/when the write actually commits,
        # which the omniscient checker uses to resolve ambiguous failures.
        self.entry = entry


class ReadResult:
    __slots__ = ("ok", "value", "error", "execution_ts")

    def __init__(self, ok: bool, value: Any = None, error: str = "",
                 execution_ts: float = 0.0) -> None:
        self.ok = ok
        self.value = value
        self.error = error
        self.execution_ts = execution_ts


_SENTINEL = LogEntry(term=0, key=NOOP, value=None,
                     interval=TimeInterval(-1e18, -1e18))


# ------------------------------------------------- membership config codec
def encode_config(voters, learners=()) -> object:
    """CONFIG entry value. Voter-only configs keep the legacy encoding (a
    sorted id list) so old logs and artifacts replay unchanged; configs
    with learners use ``{"voters": [...], "learners": [...]}``."""
    if learners:
        return {"voters": sorted(voters), "learners": sorted(learners)}
    return sorted(voters)


def parse_config(value) -> tuple[set, set]:
    """(voters, learners) from either CONFIG encoding."""
    if isinstance(value, dict):
        return set(value["voters"]), set(value["learners"])
    return set(value), set()


class Node:
    __slots__ = (
        "id", "loop", "net", "clock", "prng", "p", "config", "learners",
        "_seed_config", "_seed_learners", "_forced_learner", "on_leader",
        "term", "voted_for", "log", "state", "commit_index", "last_applied",
        "data", "alive", "next_index", "match_index",
        "last_index_at_election", "leader_hint", "_leader_epoch",
        "_last_heartbeat", "_cond", "_new_entries", "policy",
        "freeze_commit_broadcast", "_frozen_commit", "_timer_gen",
        "_election_sleep", "_last_peer_ack", "_backoff_fails",
        "_backoff_sleep", "elections_started", "prevote_rounds",
        "leader_evictions", "healthy_evictions", "quorum_step_downs",
        "checksum_drops", "_trace_ctx",
    )

    def __init__(self, node_id: int, loop: EventLoop, net: Network,
                 clock: BoundedClock, prng: PRNG, params: RaftParams,
                 peers: list[int],
                 on_leader: Optional[Callable[[int, int], None]] = None,
                 learners: Optional[list[int]] = None) -> None:
        self.id = node_id
        self.loop = loop
        self.net = net
        self.clock = clock
        self.prng = prng
        self.p = params
        # membership: mutated only via CONFIG log entries (paper §4.4
        # single-node changes — overlapping majorities preserve Leader
        # Completeness, on which the lease argument rests). ``config`` is
        # the VOTER set; ``learners`` receive AppendEntries and apply
        # state but are excluded from majorities, withhold votes, and
        # never start elections.
        self.config: set[int] = set(peers)
        self.learners: set[int] = set(learners or ())
        # the deployment-time config, used when truncation (or disk loss)
        # leaves a log with no surviving CONFIG entry
        self._seed_config: set[int] = set(self.config)
        self._seed_learners: set[int] = set(self.learners)
        # a wiped node rejoining via the safe path acts as a learner even
        # while its (re-replicated) log prefix still lists it as a voter;
        # cleared once a CONFIG entry recording its learner role arrives
        self._forced_learner = False
        self.on_leader = on_leader

        # persistent state
        self.term = 0
        self.voted_for: Optional[int] = None
        self.log: list[LogEntry] = [_SENTINEL]

        # volatile state
        self.state = "follower"
        self.commit_index = 0
        self.last_applied = 0
        self.data: dict[str, list] = {}
        self.alive = True

        # leader state
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}
        self.last_index_at_election = 0
        self.leader_hint: Optional[int] = None  # who we last heard leads
        self._leader_epoch = 0   # bumps every leadership change; stops stale tasks

        self._last_heartbeat = loop.now
        self._cond = Condition(loop)     # commit/apply/state changes
        self._new_entries = Condition(loop)
        # consistency layer: all lease/read/vote/commit-gating decisions are
        # delegated to the policy selected by params.read_mode. (Local import:
        # repro.consistency imports from this module.)
        from ..consistency import make_policy
        self.policy = make_policy(self)
        # fault injection: freeze the commitIndex the leader advertises so
        # followers replicate entries without learning they are committed —
        # used to engineer a large limbo region (paper §6.6 places 100
        # entries in the limbo region to stress the skewness experiment).
        self.freeze_commit_broadcast = False
        self._frozen_commit = 0

        # gray-failure resilience state. _last_peer_ack feeds CheckQuorum
        # (and the healthy-eviction counter) from every AppendEntries
        # reply; the backoff dicts pace per-peer retries when
        # replication_backoff is on. All maintained without PRNG draws.
        self._last_peer_ack: dict[int, float] = {}
        self._backoff_fails: dict[int, int] = {}
        self._backoff_sleep: dict[int, tuple] = {}   # peer -> (future, timer)
        # instrumentation for the gray matrix (term-inflation and
        # lease-churn evidence); counting never changes behavior
        self.elections_started = 0   # real (term-bumping) campaigns
        self.prevote_rounds = 0      # trial rounds issued
        self.leader_evictions = 0    # deposed by a higher term while leading
        self.healthy_evictions = 0   # ... while still reaching a quorum
        self.quorum_step_downs = 0   # voluntary CheckQuorum step-downs
        self.checksum_drops = 0      # corrupted AppendEntries dropped

        # flight recorder context: id of this node's latest role-transition
        # event (repro.obs) — the causal parent of everything it does.
        # None until the first role event, and always None when untraced.
        self._trace_ctx: Optional[int] = None

        # bumps on every crash/restart so a timer task from a previous
        # incarnation exits instead of running alongside the new one
        self._timer_gen = 0
        # the election timer's parked (future, timer); lazy-cancelled on
        # crash/restart so a dead generation exits immediately instead of
        # leaving its wakeup in the heap until the old deadline
        self._election_sleep: Optional[tuple] = None

        net.register(node_id, self._on_message)
        loop.create_task(self._election_timer(self._timer_gen))

    # ------------------------------------------------------------- helpers
    @property
    def last_log_index(self) -> int:
        return len(self.log) - 1

    @property
    def peers(self) -> list[int]:
        """Voting peers: election + quorum-round targets."""
        return [p for p in self.config if p != self.id]

    @property
    def replication_peers(self) -> list[int]:
        """Everyone the leader replicates to: voters AND learners."""
        return [p for p in self.config if p != self.id] + \
            [p for p in self.learners if p != self.id]

    def majority(self) -> int:
        """Quorum size over VOTERS only — learners never count."""
        return len(self.config) // 2 + 1

    def is_learner(self) -> bool:
        """Non-voting: in the learner set, forced by a safe disk-loss
        rejoin, or simply not (yet / any longer) a voting member."""
        return self._forced_learner or self.id in self.learners \
            or self.id not in self.config

    def _refresh_config(self) -> None:
        """Adopt the newest CONFIG entry in the log (Raft uses the latest
        config as soon as it is appended, not committed). If conflict
        truncation (or a disk wipe) removed EVERY config entry, fall back
        to the seed config — silently keeping the truncated-away
        membership would count majorities against a config no surviving
        log supports."""
        for i in range(self.last_log_index, 0, -1):
            if self.log[i].key == CONFIG:
                self._adopt_config(*parse_config(self.log[i].value))
                return
        self._adopt_config(set(self._seed_config), set(self._seed_learners))

    def _adopt_config(self, voters: set, learners: set = frozenset()) -> None:
        old = self.config | self.learners
        new = set(voters) | set(learners)
        self.config = set(voters)
        self.learners = set(learners)
        if self.state == "leader":
            # prune replication bookkeeping for removed members — without
            # this, next/match entries (and their heartbeat loops, via the
            # membership check in _replicate) leak across reconfigurations
            for p in old - new:
                self.next_index.pop(p, None)
                self.match_index.pop(p, None)
                # a backoff park pending for a pruned peer must be
                # cancelled/reaped, not left to fire into next_index for
                # a ghost peer (its _replicate task wakes, sees the peer
                # gone, and exits)
                self._backoff_fails.pop(p, None)
                self._wake_backoff(p)
            for p in new - old:
                if p not in self.next_index and p != self.id:
                    self.next_index[p] = self.last_log_index + 1
                    self.match_index[p] = 0
                    self.loop.create_task(
                        self._replicate(p, self._leader_epoch))

    def _signal(self) -> None:
        self._cond.notify_all()

    def is_leader(self) -> bool:
        return self.state == "leader" and self.alive

    # compatibility shims: mechanism state lives on the policy
    @property
    def limbo_keys(self) -> set:
        return getattr(self.policy, "limbo_keys", set())

    def _commit_gate_blocked(self) -> bool:
        return self.policy.gate_commit()

    # ------------------------------------------------------ crash / restart
    def crash(self) -> None:
        tr = self.loop.tracer
        if tr is not None:
            self._trace_ctx = tr.emit("role", node=self.id, term=self.term,
                                      parent=self._trace_ctx, role="down",
                                      reason="crash")
        self.alive = False
        self.state = "follower"
        self._leader_epoch += 1
        self._timer_gen += 1
        self.net.set_down(self.id, True)
        self._wake_election_timer()
        for p in list(self._backoff_sleep):
            self._wake_backoff(p)       # parked retries exit via the guard
        self._backoff_fails.clear()
        self._signal()

    def _wake_election_timer(self) -> None:
        """Lazy-cancel the parked election timer: its heap entry is marked
        dead (reaped at pop, never dispatched) and the waiting generation
        is woken now — it re-checks its guard, sees the generation bump,
        and exits instead of lingering until the old deadline. No PRNG
        draw happens on the dead path, so replay is unaffected."""
        parked = self._election_sleep
        if parked is not None:
            f, timer = parked
            timer.cancel()
            if not f.done():
                f.set_result(None)

    def _wake_backoff(self, peer: int) -> None:
        """Lazy-cancel a parked replication-backoff sleep (same scheme as
        the election timer): the heap entry is reaped, the waiting
        _replicate task wakes now, re-checks membership, and exits."""
        parked = self._backoff_sleep.pop(peer, None)
        if parked is not None:
            f, timer = parked
            timer.cancel()
            if not f.done():
                f.set_result(None)

    async def _backoff_park(self, peer: int, delay: float) -> None:
        f = Future(self.loop)
        timer = self.loop.call_later_cancelable(delay, f._wake)
        self._backoff_sleep[peer] = (f, timer)
        await f
        if self._backoff_sleep.get(peer, (None,))[0] is f:
            del self._backoff_sleep[peer]

    def restart(self, wipe_disk: bool = False,
                rejoin_as_learner: bool = False) -> None:
        """Come back from a crash with persistent state (term, voted_for,
        log) intact. With ``wipe_disk`` the persistent state is ALSO lost —
        the node rejoins as if freshly installed. That exceeds Raft's fault
        model (a wiped voter can re-vote in a term and break Leader
        Completeness), which is exactly why the nemesis engine offers it:
        the linearizability matrix classifies it as an *unsafe* fault.
        The static membership config is assumed to survive reinstalls (it
        lives in deployment config, not the Raft log).

        ``rejoin_as_learner`` is the SAFE wipe path (ROADMAP item): the
        node comes back refusing to vote or campaign — regardless of what
        stale log prefixes claim — until a CONFIG entry recording its
        learner demotion reaches it; the leader then catches it up and
        auto-promotes it via an ordinary CONFIG entry."""
        if wipe_disk:
            self.term = 0
            self.voted_for = None
            self.log = [_SENTINEL]
            self._forced_learner = rejoin_as_learner
        self.alive = True
        self.state = "follower"
        self.commit_index = 0
        self.last_applied = 0
        self.data = {}
        self.leader_hint = None
        self._last_heartbeat = self.loop.now
        self._refresh_config()       # membership may have changed on disk
        # policy state is process-volatile: a restarted node starts fresh
        from ..consistency import make_policy
        self.policy = make_policy(self)
        self.net.set_down(self.id, False)
        tr = self.loop.tracer
        if tr is not None:
            self._trace_ctx = tr.emit(
                "role", node=self.id, term=self.term, parent=self._trace_ctx,
                role="follower",
                reason="restart_wiped" if wipe_disk else "restart")
        self._timer_gen += 1
        self._wake_election_timer()   # reap any parked prior-gen wakeup
        self.loop.create_task(self._election_timer(self._timer_gen))

    # --------------------------------------------------------- RPC handler
    def _on_message(self, src: int, msg: Any) -> Any:
        if not self.alive:
            return None
        if isinstance(msg, RequestVote):
            return self._handle_vote(src, msg)
        if isinstance(msg, AppendEntries):
            return self._handle_append(src, msg)
        if isinstance(msg, PreVoteRequest):
            return self._handle_prevote(src, msg)
        return self.policy.on_message(src, msg)

    def _step_down(self, term: int, count_eviction: bool = True) -> None:
        tr = self.loop.tracer
        if term > self.term:
            if tr is not None:
                tr.emit("term_bump", node=self.id, term=term,
                        parent=self._trace_ctx, prev=self.term)
            self.term = term
            self.voted_for = None
        if self.state != "follower":
            was_leader = self.state == "leader"
            if was_leader and count_eviction:
                # deposed by a higher term; "healthy" if we could still
                # reach a quorum — the disruptive-election signature
                # PreVote/CheckQuorum exist to prevent
                self.leader_evictions += 1
                if self._quorum_connected():
                    self.healthy_evictions += 1
            self.state = "follower"
            self._leader_epoch += 1
            if tr is not None:
                reason = ("check_quorum" if not count_eviction
                          else "deposed" if was_leader else "higher_term")
                self._trace_ctx = tr.emit(
                    "role", node=self.id, term=self.term,
                    parent=self._trace_ctx, role="follower", reason=reason)
        self._signal()

    def _quorum_connected(self) -> bool:
        """Did we hear from a voting majority (incl. ourselves) within
        the last election timeout? Fed by every AppendEntries reply."""
        horizon = self.loop.now - self.p.election_timeout
        live = 1 + sum(1 for p in self.peers
                       if self._last_peer_ack.get(p, float("-inf")) >= horizon)
        return live >= self.majority()

    def _handle_vote(self, src: int, msg: RequestVote) -> VoteReply:
        if msg.term > self.term:
            self._step_down(msg.term)
        granted = False
        if self.is_learner():
            # non-voting: a learner (or a wiped node on the safe rejoin
            # path) must never contribute to an election quorum before its
            # promotion CONFIG entry — Leader Completeness rests on it
            return VoteReply(self.term, False)
        if msg.term == self.term and self.voted_for in (None, msg.candidate):
            up_to_date = (msg.last_log_term, msg.last_log_index) >= (
                self.log[-1].term, self.last_log_index)
            # e.g. Ongaro leases withhold votes within ET of hearing from a
            # leader; LeaseGuard deliberately does not delay elections.
            vote_blocked = self.policy.gate_vote(msg)
            if up_to_date and not vote_blocked:
                granted = True
                self.voted_for = msg.candidate
                self._last_heartbeat = self.loop.now
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("vote", node=self.id, term=self.term,
                    parent=self._trace_ctx, candidate=msg.candidate,
                    granted=granted, prevote=False)
        return VoteReply(self.term, granted)

    def _handle_prevote(self, src: int, msg: PreVoteRequest) -> PreVoteReply:
        """Trial vote (thesis §9.6): NEVER bumps our term, never sets
        voted_for, never resets the election timer — purely advisory.
        Granted only if the candidate's log is up-to-date AND we have not
        heard from a live leader within an election timeout, so a healed
        flapper cannot depose a healthy lease-holding leader, and a
        partitioned one cannot inflate terms at all."""
        granted = False
        if not self.is_learner() and msg.term > self.term:
            up_to_date = (msg.last_log_term, msg.last_log_index) >= (
                self.log[-1].term, self.last_log_index)
            heard_leader = self.state == "leader" or (
                self.leader_hint is not None
                and self.loop.now - self._last_heartbeat
                < self.p.election_timeout)
            granted = up_to_date and not heard_leader
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("vote", node=self.id, term=self.term,
                    parent=self._trace_ctx, candidate=msg.candidate,
                    granted=granted, prevote=True)
        return PreVoteReply(self.term, granted)

    def _handle_append(self, src: int,
                       msg: AppendEntries) -> Optional[AppendEntriesReply]:
        if self.p.entry_checksums and (
                msg.checksum is None or msg.checksum != append_digest(msg)
                or any(e.checksum != entry_checksum(e.term, e.key, e.value)
                       for e in msg.entries)):
            # end-to-end integrity failed: detected-and-dropped before any
            # state (even our term) is touched. No reply — the sender's
            # RPC times out and retries with a fresh transmission.
            self.checksum_drops += 1
            return None
        if msg.term < self.term:
            return AppendEntriesReply(self.term, False, 0)
        if msg.term > self.term or self.state != "follower":
            self._step_down(msg.term)
        self._last_heartbeat = self.loop.now
        self.leader_hint = msg.leader
        # log consistency check; the failure reply carries our last log
        # index so the leader can clamp a match_index that exceeds our
        # actual log (only possible after a disk wipe — without it the
        # clamp is a no-op, since a matched prefix never shrinks within
        # the leader's term)
        if msg.prev_index < 0 or msg.prev_index > self.last_log_index or \
                self.log[msg.prev_index].term != msg.prev_term:
            # (negative prev_index is only reachable via in-flight field
            # corruption; honest leaders never send one)
            return AppendEntriesReply(self.term, False, self.last_log_index)
        # append / resolve conflicts
        idx = msg.prev_index
        config_touched = False
        for e in msg.entries:
            idx += 1
            if idx <= self.last_log_index:
                if self.log[idx].term != e.term:
                    config_touched |= any(x.key == CONFIG
                                          for x in self.log[idx:])
                    del self.log[idx:]          # truncate conflicting suffix
                    # impossible honestly (committed prefixes never
                    # truncate), but corruption of leader_commit with
                    # checksums off can leave these pointing past the
                    # log; clamp so the checker — not an IndexError —
                    # reports the resulting divergence
                    if self.commit_index > self.last_log_index:
                        self.commit_index = self.last_log_index
                    if self.last_applied > self.last_log_index:
                        self.last_applied = self.last_log_index
                    self.log.append(e)
                    config_touched |= e.key == CONFIG
            else:
                self.log.append(e)
                config_touched |= e.key == CONFIG
        if config_touched:
            self._refresh_config()
        match = msg.prev_index + len(msg.entries)
        if self._forced_learner and 0 < msg.leader_commit <= self.last_log_index:
            # a wiped node's vote is safe again exactly when its (prefix-
            # matched) log covers the cluster commit point: from here on it
            # only votes for candidates at least as complete as that log.
            # Content-based tests (e.g. "saw a CONFIG demoting me") cannot
            # distinguish a pre-wipe learner stint from the post-wipe
            # demotion, so catch-up is the only sound clearing condition.
            self._forced_learner = False
        if msg.leader_commit > self.commit_index:
            self.commit_index = min(msg.leader_commit, self.last_log_index)
            self._apply_committed()
        return AppendEntriesReply(self.term, True, match)

    # ------------------------------------------------------------ elections
    async def _election_timer(self, gen: int) -> None:
        while self.alive and self._timer_gen == gen:
            timeout = self.p.election_timeout + self.prng.uniform(
                0.0, self.p.election_jitter)
            deadline = self._last_heartbeat + timeout
            if self.loop.now < deadline:
                # cancelable sleep: crash/restart reaps the heap entry and
                # wakes this generation immediately (it then exits)
                f = Future(self.loop)
                timer = self.loop.call_later_cancelable(
                    deadline - self.loop.now, f._wake)
                self._election_sleep = (f, timer)
                await f
                self._election_sleep = None
                continue
            if self.state == "leader" or self.is_learner():
                if self.state == "leader" and self.p.check_quorum \
                        and not self._quorum_connected():
                    # CheckQuorum: no word from a voting majority within
                    # an election timeout — step down and stop serving
                    # the lease instead of riding out a doomed lease
                    # window in which every read/write can only time out
                    self.quorum_step_downs += 1
                    self.policy.on_quorum_lost()
                    self._step_down(self.term, count_eviction=False)
                # learners never start elections; they just keep waiting
                self._last_heartbeat = self.loop.now
                continue
            await self._run_for_election()

    async def _prevote_round(self) -> bool:
        """One PreVote round: poll the voters with a trial ballot for
        ``term + 1`` without bumping any term. True = a majority signals
        the real campaign would win. While partitioned this keeps
        failing, so a flapping node's term never inflates."""
        self.prevote_rounds += 1
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("election", node=self.id, term=self.term + 1,
                    parent=self._trace_ctx, kind="prevote")
        term0 = self.term
        msg = PreVoteRequest(self.term + 1, self.id, self.last_log_index,
                             self.log[-1].term)
        grants = 1
        futs = [self.net.call(self.id, p, msg) for p in self.peers]
        for f in futs:
            try:
                reply: PreVoteReply = await wait_for(f, self.p.rpc_timeout)
            except TimeoutError_:
                continue
            # abort if circumstances changed mid-round (a vote was
            # granted, a higher term arrived); a same-term heartbeat
            # keeps the round alive — peers hearing that leader refuse
            # anyway. (state may legitimately be "candidate" here: a
            # node whose previous real election failed retries.)
            if not self.alive or self.term != term0 \
                    or self.state == "leader":
                return False
            if reply.term > self.term:
                self._step_down(reply.term)
                return False
            if reply.granted:
                grants += 1
            if grants >= self.majority():
                return True
        return grants >= self.majority()

    async def _run_for_election(self) -> None:
        if self.p.prevote:
            self._last_heartbeat = self.loop.now  # full timeout before retry
            if not await self._prevote_round():
                return                            # stay a quiet follower
        self.term += 1
        self.elections_started += 1
        term = self.term
        self.state = "candidate"
        self.voted_for = self.id
        self._last_heartbeat = self.loop.now
        tr = self.loop.tracer
        if tr is not None:
            self._trace_ctx = tr.emit(
                "role", node=self.id, term=term, parent=self._trace_ctx,
                role="candidate", reason="election_timeout")
            tr.emit("election", node=self.id, term=term,
                    parent=self._trace_ctx, kind="campaign")
        msg = RequestVote(term, self.id, self.last_log_index, self.log[-1].term)
        votes = 1
        futs = [self.net.call(self.id, p, msg) for p in self.peers]
        for f in futs:
            try:
                reply: VoteReply = await wait_for(f, self.p.rpc_timeout)
            except TimeoutError_:
                continue
            if not self.alive or self.state != "candidate" or self.term != term:
                return
            if reply.term > self.term:
                self._step_down(reply.term)
                return
            if reply.granted:
                votes += 1
            if votes >= self.majority():
                self._become_leader()
                return

    def _become_leader(self) -> None:
        self.state = "leader"
        self._leader_epoch += 1
        epoch = self._leader_epoch
        self.next_index = {p: self.last_log_index + 1
                           for p in self.replication_peers}
        self.match_index = {p: 0 for p in self.replication_peers}
        # CheckQuorum grace: a fresh leader gets one full election
        # timeout before connectivity is judged
        self._last_peer_ack = {p: self.loop.now for p in self.peers}
        self._backoff_fails.clear()
        self.last_index_at_election = self.last_log_index
        self.leader_hint = self.id
        tr = self.loop.tracer
        if tr is not None:
            self._trace_ctx = tr.emit(
                "role", node=self.id, term=self.term, parent=self._trace_ctx,
                role="leader", reason="won_election")
        self.policy.on_become_leader()
        if self.p.noop_on_election:
            self._append_local(NOOP, None)
        for p in self.replication_peers:
            self.loop.create_task(self._replicate(p, epoch))
        self.loop.create_task(self.policy.maintenance_task(epoch))
        if self.on_leader is not None:
            self.on_leader(self.id, self.term)
        self._signal()

    # ------------------------------------------------------------ leader ops
    def _append_local(self, key: str, value: Any) -> int:
        entry = LogEntry(self.term, key, value, self.clock.interval_now())
        if self.p.entry_checksums:
            entry.checksum = entry_checksum(entry.term, entry.key,
                                            entry.value)
        self.log.append(entry)
        if key == CONFIG:
            self._adopt_config(*parse_config(value))
        self._new_entries.notify_all()
        self._try_advance_commit()   # single-node replica sets commit locally
        return self.last_log_index

    def _make_append(self, prev_index: int, entries: list,
                     commit: int) -> AppendEntries:
        """Build an AppendEntries, stamping the end-to-end digest when
        ``entry_checksums`` is on (every sender — replication loop and
        policy barriers alike — must go through here)."""
        msg = AppendEntries(self.term, self.id, prev_index,
                            self.log[prev_index].term, entries, commit)
        if self.p.entry_checksums:
            msg.checksum = append_digest(msg)
        return msg

    async def _replicate(self, peer: int, epoch: int) -> None:
        """Per-follower replication + heartbeat loop (voters AND learners)."""
        while self.alive and self.state == "leader" \
                and self._leader_epoch == epoch \
                and (peer in self.config or peer in self.learners):
            ni = self.next_index[peer]
            entries = self.log[ni: ni + self.p.batch_max_entries]
            prev = ni - 1
            if self.freeze_commit_broadcast:
                advertised_commit = min(self._frozen_commit, self.commit_index)
            else:
                advertised_commit = self.commit_index
            msg = self._make_append(prev, list(entries), advertised_commit)
            start = self.loop.now
            size = 256 + sum(64 + (len(e.value) if isinstance(e.value, (bytes, str))
                                   else 8) for e in entries)
            try:
                reply: AppendEntriesReply = await wait_for(
                    self.net.call(self.id, peer, msg, size=size),
                    self.p.rpc_timeout)
            except TimeoutError_:
                if self.p.replication_backoff:
                    # capped exponential backoff + jitter instead of the
                    # fixed rpc_timeout hot-loop against a slow/dead peer
                    fails = self._backoff_fails.get(peer, 0) + 1
                    self._backoff_fails[peer] = fails
                    delay = min(self.p.backoff_max,
                                self.p.backoff_base * (1 << (fails - 1)))
                    delay *= 1.0 + self.prng.random()
                    await self._backoff_park(peer, delay)
                    if peer not in self.next_index:
                        return    # pruned from the config while parked
                continue
            self._last_peer_ack[peer] = self.loop.now
            self._backoff_fails.pop(peer, None)
            if not self.alive or self.state != "leader" or self._leader_epoch != epoch:
                return
            if reply.term > self.term:
                self._step_down(reply.term)
                return
            if peer not in self.next_index:
                return            # removed from the config during the RPC
            if reply.success:
                self.policy.on_append_response(peer, start)
                if reply.match_index > self.match_index[peer]:
                    self.match_index[peer] = reply.match_index
                self.next_index[peer] = reply.match_index + 1
                self._try_advance_commit()
                if peer in self.learners and self.p.auto_promote_learners \
                        and reply.match_index >= self.commit_index:
                    # caught up to everything committed: promote to voter
                    # via an ordinary single-node CONFIG entry
                    self._maybe_promote_learner(peer)
                if self.next_index.get(peer, 0) > self.last_log_index:
                    # up to date: wait for new entries or heartbeat tick
                    await self._wait_new_entries(self.p.heartbeat_interval)
            else:
                # the reply's match_index is the follower's last log index:
                # clamp our record if its log REGRESSED (disk wipe) so a
                # lost log is never counted toward a commit majority
                if reply.match_index < self.match_index[peer]:
                    self.match_index[peer] = reply.match_index
                self.next_index[peer] = max(1, self.next_index[peer] - 1)

    async def _wait_new_entries(self, timeout: float) -> None:
        """Wait until new entries are appended, or the heartbeat tick fires."""
        await self._new_entries.wait(timeout)

    # -- commit counting (gated by the policy, e.g. LeaseGuard Fig. 2) ------
    def _try_advance_commit(self) -> None:
        if self.state != "leader" or not self.alive:
            return
        if self.policy.gate_commit():
            self.policy.on_commit_blocked()
            return
        matches = sorted([v for p, v in self.match_index.items()
                          if p in self.config] + [self.last_log_index],
                         reverse=True)
        m = matches[self.majority() - 1]
        # standard Raft: only count-commit entries of the current term
        while m > self.commit_index and self.log[m].term != self.term:
            m -= 1
        if m > self.commit_index:
            self.commit_index = m
            self._apply_committed()

    def _apply_committed(self) -> None:
        advanced = False
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self.log[self.last_applied]
            if not e.is_control:
                self.data.setdefault(e.key, []).append(e.value)
            if self.state == "leader" and e.execution_ts is None:
                e.execution_ts = self.loop.now   # commit-on-leader time (§6.2)
            advanced = True
        if advanced:
            if self.state == "leader":
                tr = self.loop.tracer
                if tr is not None:
                    tr.emit("commit", node=self.id, term=self.term,
                            parent=self._trace_ctx, index=self.commit_index)
                self.policy.on_commit_advanced()
            self._signal()

    def _reconfig_in_progress(self) -> bool:
        """One reconfiguration at a time: any uncommitted CONFIG blocks."""
        for i in range(self.last_log_index, self.commit_index, -1):
            if self.log[i].key == CONFIG:
                return True
        return False

    def _maybe_promote_learner(self, peer: int) -> None:
        """Auto-promotion (driven from the replication loop): once a
        learner's acked match_index covers the leader's commit index, a
        CONFIG entry moves it into the voter set."""
        if self.state != "leader" or not self.alive \
                or peer not in self.learners or self._reconfig_in_progress():
            return
        self._append_local(CONFIG, encode_config(self.config | {peer},
                                                 self.learners - {peer}))

    async def change_membership(self, new_config: set,
                                learners: Optional[set] = None) -> WriteResult:
        """Single-node reconfiguration (paper §4.4): add or remove ONE
        node, add/remove a learner, or change one node's role
        (learner⇄voter). The CONFIG entry is an ordinary log entry — it
        carries a clock interval, extends the lease, and obeys the commit
        gate, so all LeaseGuard guarantees hold across the change
        (overlapping majorities over the VOTER set preserve Leader
        Completeness; learner-set changes never move a quorum).

        ``learners=None`` keeps the current learner set minus any node
        being promoted into ``new_config`` — so the legacy voter-only call
        shape both adds fresh voters and promotes learners."""
        if not self.is_leader():
            return WriteResult(False, "not_leader")
        new_voters = set(new_config)
        new_learners = (self.learners - new_voters if learners is None
                        else set(learners))
        if new_voters & new_learners:
            return WriteResult(False, "voter_learner_overlap")
        affected = (new_voters ^ self.config) | (new_learners ^ self.learners)
        if len(affected) != 1:
            return WriteResult(False, "only_single_node_changes")
        if self.id not in new_voters:
            return WriteResult(False, "cannot_remove_leader")
        if self._reconfig_in_progress():
            return WriteResult(False, "reconfig_in_progress")
        index = self._append_local(CONFIG,
                                   encode_config(new_voters, new_learners))
        entry = self.log[index]
        deadline = self.loop.now + self.p.write_timeout
        while self.alive:
            if self.last_applied >= index and len(self.log) > index \
                    and self.log[index] is entry:
                return WriteResult(True, entry=entry)
            if self.state != "leader" or self.loop.now >= deadline:
                return WriteResult(False, "failed", entry=entry)
            await self._cond_wait(deadline)
        return WriteResult(False, "crashed", entry=entry)

    def freeze_commits(self) -> None:
        """Fault injection: stop advertising commitIndex advances."""
        self._frozen_commit = self.commit_index
        self.freeze_commit_broadcast = True

    def relinquish_lease(self) -> None:
        """Planned handover (§5.1): commit an end-lease entry, then step down."""
        if self.is_leader():
            tr = self.loop.tracer
            if tr is not None:
                tr.emit("lease", node=self.id, term=self.term,
                        parent=self._trace_ctx, op="relinquish")
            self._append_local(END_LEASE, None)

    # ---------------------------------------------------------- client API
    async def client_write(self, key: str, value: Any) -> WriteResult:
        tr = self.loop.tracer
        if tr is None:
            return await self._client_write(key, value)
        # traced path: same single awaited coroutine, so scheduling (and
        # with it every PRNG draw) is identical to the untraced path
        sid = tr.emit("write", node=self.id, term=self.term,
                      parent=self._trace_ctx, op="start", key=key)
        res = await self._client_write(key, value)
        if res.ok:
            tr.emit("write", node=self.id, term=self.term, parent=sid,
                    op="done", key=key)
        else:
            tr.emit("write", node=self.id, term=self.term, parent=sid,
                    op="fail", key=key, error=res.error)
        return res

    async def _client_write(self, key: str, value: Any) -> WriteResult:
        if not self.is_leader():
            return WriteResult(False, "not_leader")
        err = self.policy.gate_write()
        if err:
            return WriteResult(False, err)
        term0 = self.term
        index = self._append_local(key, value)
        entry = self.log[index]
        deadline = self.loop.now + self.p.write_timeout
        while self.alive:
            if self.last_applied >= index:
                if len(self.log) > index and self.log[index] is entry:
                    return WriteResult(True, entry=entry)
                return WriteResult(False, "not_leader", entry=entry)  # lost
            if self.state != "leader" or self.term != term0:
                return WriteResult(False, "not_leader", entry=entry)  # unknown
            if self.loop.now >= deadline:
                return WriteResult(False, "timeout", entry=entry)
            await self._cond_wait(deadline)
        return WriteResult(False, "crashed", entry=entry)

    async def client_read(self, key: str) -> ReadResult:
        tr = self.loop.tracer
        if tr is None:
            return await self.policy.gate_read(key)
        t0 = self.loop.now
        sid = tr.emit("read", node=self.id, term=self.term,
                      parent=self._trace_ctx, op="start", key=key)
        res = await self.policy.gate_read(key)
        if res.ok:
            tr.emit("read", node=self.id, term=self.term, parent=sid,
                    op="done", key=key, stall=self.loop.now - t0)
        else:
            tr.emit("read", node=self.id, term=self.term, parent=sid,
                    op="fail", key=key, error=res.error,
                    stall=self.loop.now - t0)
        return res

    async def _cond_wait(self, deadline: float) -> None:
        await self._cond.wait(max(0.0, deadline - self.loop.now) + 1e-9)
