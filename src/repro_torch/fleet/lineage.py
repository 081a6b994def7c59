"""Checkpoint lineage: the fleet log schema, epoch fencing, and the
omniscient post-run checker.

The whole fleet coordinates through ONE replicated key (``fleet/log``)
holding two record kinds, both appended through the Raft log:

* ``{"kind": "claim", "epoch": e, "chief": wid}`` — a worker claiming
  chiefdom for a new epoch;
* ``{"kind": "manifest", "epoch": e, "chief": wid, "step": s,
  "parent": p, "id": "wid:e:s"}`` — a checkpoint manifest committed by
  a chief.

**Epoch fencing.** A manifest is *valid* iff its ``(epoch, chief)``
equals the nearest *preceding* claim in the log (first occurrence per
``id`` wins). Because claims and manifests share one key, fencing is
decided by Raft's own total order — no timestamps involved: the moment
a new chief's claim commits, every later manifest by the deposed chief
is invalid by construction. A new chief appends its claim and *then*
performs its takeover read, so under a linearizable read policy that
read observes every valid manifest that will ever precede its claim —
which is exactly what makes valid steps monotone for consistent
policies and lets stale reads (the ``inconsistent`` policy) break them.

**The checker** is omniscient in the same way ``core.checker`` is: it
reads the surviving replicas' Raft log directly (record + the entry's
``execution_ts``, the true commit-on-leader time) and the harness's
restore trace, and asserts:

1. **no forks** — valid manifests have strictly increasing steps;
2. **durability** — every manifest a worker restored from is in the
   committed log with ``execution_ts`` no later than the read's return;
3. **staleness bound** — no restore observed less than the newest valid
   manifest committed strictly before the read began (a linearizable
   read must see every write that committed before it started).
"""

from __future__ import annotations

import json
from typing import Any, Optional

FLEET_KEY = "fleet/log"

_EPS = 1e-9


class LogView:
    """Incremental fold of the fleet log. Feeding a longer raw list only
    decodes the new tail — the log is append-only and committed prefixes
    of equal length are identical (Raft log matching), so the fold state
    is monotone. Feeding a *shorter* list than already seen is a stale
    read; callers detect that via :attr:`n` before feeding."""

    __slots__ = ("n", "_cur", "last_claim", "valid", "_seen")

    def __init__(self) -> None:
        self.n = 0
        self._cur: Optional[tuple] = None       # fence: (epoch, chief)
        self.last_claim: Optional[dict] = None
        self.valid: list[dict] = []             # fenced, deduped manifests
        self._seen: set[str] = set()

    def feed_raw(self, raw: list) -> "LogView":
        for v in raw[self.n:]:
            self.feed_one(json.loads(v))
        self.n = len(raw)
        return self

    def feed_one(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "claim":
            self._cur = (rec["epoch"], rec["chief"])
            self.last_claim = rec
        elif kind == "manifest":
            if (self._cur == (rec["epoch"], rec["chief"])
                    and rec["id"] not in self._seen):
                self._seen.add(rec["id"])
                self.valid.append(rec)

    @property
    def latest(self) -> Optional[dict]:
        return self.valid[-1] if self.valid else None


def extract_fleet_log(cluster, key: str = FLEET_KEY) -> list[tuple[dict, Optional[float]]]:
    """The committed fleet log as ``(record, execution_ts)`` pairs, read
    omnisciently off the most advanced surviving replica's Raft log.
    ``execution_ts`` is the commit-on-leader time (None for the rare
    entry applied on a follower whose leader never got to stamp it)."""
    node = max(cluster.nodes.values(),
               key=lambda n: (n.alive, n.last_applied, -n.id))
    out = []
    for idx in range(1, node.last_applied + 1):
        e = node.log[idx]
        if e.key == key:
            out.append((json.loads(e.value), e.execution_ts))
    return out


def check_lineage(entries: list[tuple[dict, Optional[float]]],
                  restores: list[dict]) -> list[dict]:
    """Run the three lineage checks; returns a list of violation dicts
    (empty = clean). ``restores`` is the harness trace: each has ``wid``,
    ``kind`` (boot / rejoin / takeover), ``t_start``/``t_end`` of the
    read, and ``manifest`` (the valid manifest it observed, or None)."""
    violations: list[dict] = []

    fence: Optional[tuple] = None
    seen: set[str] = set()
    valid: list[tuple[dict, Optional[float]]] = []
    committed_ts: dict[str, Optional[float]] = {}
    for rec, ts in entries:
        kind = rec.get("kind")
        if kind == "claim":
            fence = (rec["epoch"], rec["chief"])
        elif kind == "manifest":
            if rec["id"] not in committed_ts:
                committed_ts[rec["id"]] = ts
            if fence == (rec["epoch"], rec["chief"]) and rec["id"] not in seen:
                seen.add(rec["id"])
                valid.append((rec, ts))

    # 1. committed steps monotone, no forks
    prev: Optional[dict] = None
    for rec, ts in valid:
        if prev is not None and rec["step"] <= prev["step"]:
            violations.append({
                "check": "fork", "id": rec["id"], "epoch": rec["epoch"],
                "chief": rec["chief"], "step": rec["step"],
                "prev_step": prev["step"],
                "detail": "valid manifest steps went non-monotone"})
        prev = rec

    for r in restores:
        man = r["manifest"]
        # 2. durability: you can only restore from a committed manifest,
        #    and only after it committed
        if man is not None:
            ts = committed_ts.get(man["id"], "missing")
            if ts == "missing":
                violations.append({
                    "check": "durability", "wid": r["wid"],
                    "kind": r["kind"], "id": man["id"],
                    "detail": "restored manifest never committed"})
            elif ts is not None and ts > r["t_end"] + _EPS:
                violations.append({
                    "check": "durability", "wid": r["wid"],
                    "kind": r["kind"], "id": man["id"],
                    "detail": "restored manifest committed after the read "
                              "returned"})
        # 3. staleness: a linearizable read beginning at t_start must see
        #    every valid manifest committed strictly before t_start
        bound, bound_id = -1, None
        for rec, ts in valid:
            if ts is not None and ts < r["t_start"] - _EPS \
                    and rec["step"] > bound:
                bound, bound_id = rec["step"], rec["id"]
        observed = man["step"] if man is not None else -1
        if observed < bound:
            violations.append({
                "check": "stale_restore", "wid": r["wid"], "kind": r["kind"],
                "observed_step": observed, "bound_step": bound,
                "bound_id": bound_id,
                "detail": "restored from a manifest staler than the "
                          "policy's consistency bound"})
    return violations
