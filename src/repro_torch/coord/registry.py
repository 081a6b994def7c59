"""Training-cluster metadata on top of the LeaseGuard coordinator.

Three tables, all backed by the replicated linearizable KV:

* **checkpoint registry** — a checkpoint exists once its manifest is
  committed through the Raft log; ``latest_checkpoint()`` is the
  paper's zero-roundtrip leased read (on a 1000-node fleet every worker
  polls this every step — with quorum reads that poll would be the
  coordinator's bottleneck; with LeaseGuard it is free);
* **membership** — workers register, heartbeat, and deregister; all
  three are events in ONE append-only log (``members/log``) folded in
  log order, so a worker that leaves and later re-registers is live
  again (a set-difference over separate join/leave tables would kill it
  forever). ``live_workers(ttl=...)`` additionally requires a heartbeat
  (or join) within the last ``ttl`` simulated seconds;
* **straggler table** — per-worker step-time reports; the launcher flags
  workers slower than ``threshold ×`` the fleet median, computed over a
  *per-worker* recent window (a global window would let fast, frequent
  reporters evict slow workers from the sample entirely).

Two client shapes share the same schema and fold helpers:
:class:`ClusterRegistry` (synchronous, over the crank adapter) for
wall-clock trainers, and :class:`AsyncClusterRegistry` (awaitable, over
:class:`~repro.coord.kvstore.CoordClient`) for actors living on the
simulated event loop — the fleet simulator's workers.
"""

from __future__ import annotations

import statistics
from typing import Any, Optional

from .kvstore import CoordClient, LocalCoordinator

CKPT_KEY = "ckpt/manifest"
MEMBERS_KEY = "members/log"
REPORTS_KEY = "stragglers/reports"


# ------------------------------------------------------------ fold helpers
def fold_members(events: list[dict]) -> dict[str, dict]:
    """Fold join/leave/heartbeat events **in log order** into the current
    membership: ``wid -> {"meta", "last_seen"}``. A leave removes the
    worker; a later join resurrects it (the rejoin path a join-set minus
    leave-set difference gets wrong). Heartbeats only refresh workers
    that are currently registered."""
    members: dict[str, dict] = {}
    for r in events:
        ev, wid = r["ev"], r["id"]
        if ev == "join":
            members[wid] = {"meta": r.get("meta") or {},
                            "last_seen": r.get("t", 0.0)}
        elif ev == "leave":
            members.pop(wid, None)
        elif ev == "hb":
            m = members.get(wid)
            if m is not None and r.get("t", 0.0) > m["last_seen"]:
                m["last_seen"] = r["t"]
    return members


def live_from(events: list[dict], now: Optional[float] = None,
              ttl: Optional[float] = None) -> set[str]:
    """Live worker ids from a folded event log. ``ttl=None`` is pure
    membership; with a TTL, a worker is live only if its last join or
    heartbeat is at most ``ttl`` seconds old."""
    members = fold_members(events)
    if ttl is None:
        return set(members)
    assert now is not None, "ttl-based liveness needs the current time"
    return {wid for wid, m in members.items()
            if now - m["last_seen"] <= ttl}


def straggler_flags_from(reports: list[dict], threshold: float = 1.5,
                         window: int = 64) -> dict[str, bool]:
    """Flag workers whose recent mean step time exceeds ``threshold ×``
    the fleet median. The window is applied **per worker** (each
    worker's last ``window`` reports) before pooling for the median —
    a single global ``[-window:]`` slice would let fast, frequent
    reporters push slow workers out of the sample."""
    per: dict[str, list[float]] = {}
    for r in reports:
        per.setdefault(r["id"], []).append(r["s"])
    per = {wid: xs[-window:] for wid, xs in per.items()}
    if not per:
        return {}
    med = statistics.median(s for xs in per.values() for s in xs)
    return {wid: statistics.fmean(xs) > threshold * med
            for wid, xs in per.items()}


class ClusterRegistry:
    def __init__(self, coord: Optional[LocalCoordinator] = None,
                 consistency: Optional[str] = None) -> None:
        """``consistency`` selects a policy from the ``repro.consistency``
        registry by name (default: leaseguard). Ignored when ``coord`` is
        supplied."""
        if coord is None:
            coord = (LocalCoordinator() if consistency is None
                     else LocalCoordinator(read_mode=consistency))
        self.coord = coord

    def _now(self) -> float:
        return self.coord.cluster.loop.now

    # -- checkpoints -------------------------------------------------------
    def commit_checkpoint(self, manifest: dict) -> bool:
        self.coord.append(CKPT_KEY, manifest)
        return True

    def latest_checkpoint(self) -> Optional[dict]:
        return self.coord.read_latest(CKPT_KEY)

    def checkpoint_history(self) -> list[dict]:
        return self.coord.read_list(CKPT_KEY)

    # -- membership --------------------------------------------------------
    def register_worker(self, worker_id: str, meta: Optional[dict] = None) -> None:
        self.coord.append(MEMBERS_KEY, {"ev": "join", "id": worker_id,
                                        "meta": meta or {}, "t": self._now()})

    def deregister_worker(self, worker_id: str) -> None:
        self.coord.append(MEMBERS_KEY, {"ev": "leave", "id": worker_id,
                                        "t": self._now()})

    def heartbeat(self, worker_id: str) -> None:
        """Liveness ping; feeds ``live_workers(ttl=...)``."""
        self.coord.append(MEMBERS_KEY, {"ev": "hb", "id": worker_id,
                                        "t": self._now()})

    def live_workers(self, ttl: Optional[float] = None) -> set[str]:
        events = self.coord.read_list(MEMBERS_KEY)
        return live_from(events, now=self._now(), ttl=ttl)

    # -- stragglers ---------------------------------------------------------
    def report_step_time(self, worker_id: str, step: int,
                         seconds: float) -> None:
        self.coord.append(REPORTS_KEY,
                          {"id": worker_id, "step": step, "s": seconds})

    def straggler_flags(self, threshold: float = 1.5,
                        window: int = 64) -> dict[str, bool]:
        """Workers whose recent mean step time exceeds threshold× the
        fleet median. Zero-roundtrip read: callable every step."""
        reports = self.coord.read_list(REPORTS_KEY)
        return straggler_flags_from(reports, threshold, window)


class AsyncClusterRegistry:
    """Awaitable twin of :class:`ClusterRegistry` for actors that share
    the cluster's event loop (the fleet simulator's training workers).
    Mutators return False (and liveness reads None) instead of raising
    when the control plane is unavailable past the client's op timeout —
    actor loops skip the tick and retry on their own cadence."""

    def __init__(self, client: CoordClient) -> None:
        self.client = client

    def _now(self) -> float:
        return self.client.loop.now

    # -- membership --------------------------------------------------------
    async def register_worker(self, worker_id: str,
                              meta: Optional[dict] = None) -> bool:
        res = await self.client.append(
            MEMBERS_KEY, {"ev": "join", "id": worker_id,
                          "meta": meta or {}, "t": self._now()},
            idempotent=True)
        return res.ok

    async def deregister_worker(self, worker_id: str) -> bool:
        res = await self.client.append(
            MEMBERS_KEY, {"ev": "leave", "id": worker_id, "t": self._now()},
            idempotent=True)
        return res.ok

    async def heartbeat(self, worker_id: str) -> bool:
        res = await self.client.append(
            MEMBERS_KEY, {"ev": "hb", "id": worker_id, "t": self._now()},
            idempotent=True)
        return res.ok

    async def live_workers(self, ttl: Optional[float] = None
                           ) -> Optional[set[str]]:
        res = await self.client.read_raw(MEMBERS_KEY)
        if not res.ok:
            return None
        return live_from(self.client.decode(res.value),
                         now=self._now(), ttl=ttl)

    # -- stragglers ---------------------------------------------------------
    async def report_step_time(self, worker_id: str, step: int,
                               seconds: float) -> bool:
        res = await self.client.append(
            REPORTS_KEY, {"id": worker_id, "step": step, "s": seconds},
            idempotent=True)
        return res.ok

    async def straggler_flags(self, threshold: float = 1.5,
                              window: int = 64) -> Optional[dict[str, bool]]:
        res = await self.client.read_raw(REPORTS_KEY)
        if not res.ok:
            return None
        return straggler_flags_from(self.client.decode(res.value),
                                    threshold, window)
