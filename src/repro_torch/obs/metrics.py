"""The unified Metrics registry + derived per-run series.

:class:`Metrics` supersedes the ad-hoc ``loop_stats`` / ``net_stats`` /
``raft_stats`` dicts that ``run_workload`` used to assemble by hand:
every series is registered under its historical name, keyed by node id
where per-node attribution exists (the ad-hoc ``raft_stats`` summed
across nodes and lost it — the counter-drift fix). The compatibility
accessors (:meth:`Metrics.loop_stats` etc.) reproduce the old dicts
key-for-key so existing artifacts and tests are unchanged, and
:meth:`Metrics.raft_stats_by_node` exposes the per-node breakdown the
matrix artifacts now embed.

The second half of the module derives headline series from a recorded
trace (a list of event dicts, see :mod:`repro.obs.schema`):

* :func:`leader_timeline` / :func:`leader_uptime_fraction`
* :func:`lease_coverage`
* :func:`read_stall_histogram`
* :func:`election_to_first_commit`
* :func:`fault_detection_latency` (e.g. CheckQuorum step-down lag)

bundled by :func:`derive_headline_series`. All pure functions over the
trace: they never touch the simulation.
"""

from __future__ import annotations

from typing import Optional

#: per-node protocol counters, in the historical raft_stats order
_RAFT_COUNTERS = ("elections_started", "prevote_rounds", "leader_evictions",
                  "healthy_evictions", "quorum_step_downs", "checksum_drops")


class Metrics:
    """Counters, gauges, and sim-time histograms keyed by (name, node).

    ``node=None`` is the cluster-/loop-level key. Values are plain
    numbers; histograms store their observations (runs are short enough
    that exact percentiles beat bucketed sketches).
    """

    def __init__(self) -> None:
        self._counters: dict[str, dict[Optional[int], float]] = {}
        self._gauges: dict[str, dict[Optional[int], float]] = {}
        self._hists: dict[str, dict[Optional[int], list[float]]] = {}

    # -- writers -----------------------------------------------------------
    def inc(self, name: str, node: Optional[int] = None,
            value: float = 1) -> None:
        series = self._counters.setdefault(name, {})
        series[node] = series.get(node, 0) + value

    def gauge(self, name: str, value: float,
              node: Optional[int] = None) -> None:
        self._gauges.setdefault(name, {})[node] = value

    def observe(self, name: str, value: float,
                node: Optional[int] = None) -> None:
        self._hists.setdefault(name, {}).setdefault(node, []).append(value)

    # -- readers -----------------------------------------------------------
    def counter(self, name: str, node: Optional[int] = None) -> float:
        return self._counters.get(name, {}).get(node, 0)

    def counter_total(self, name: str) -> float:
        return sum(self._counters.get(name, {}).values())

    def gauge_value(self, name: str, node: Optional[int] = None) -> float:
        return self._gauges.get(name, {}).get(node, 0)

    def gauge_max(self, name: str) -> float:
        series = self._gauges.get(name, {})
        return max(series.values()) if series else 0

    def by_node(self, name: str) -> dict:
        merged: dict = {}
        merged.update(self._counters.get(name, {}))
        merged.update(self._gauges.get(name, {}))
        return {k: v for k, v in sorted(merged.items(),
                                        key=lambda kv: (kv[0] is None, kv[0]))
                if k is not None}

    def histogram(self, name: str, node: Optional[int] = None) -> list[float]:
        return self._hists.get(name, {}).get(node, [])

    # -- absorption from a finished run ------------------------------------
    @classmethod
    def from_cluster(cls, cluster) -> "Metrics":
        """Absorb the loop / network / per-node protocol counters of a
        finished (or running) cluster. Reading counters never perturbs
        the simulation."""
        m = cls()
        loop = cluster.loop
        m.inc("events_popped", value=loop.events_popped)
        m.inc("timers_scheduled", value=loop.timers_scheduled)
        m.inc("timers_reaped", value=loop.timers_reaped)
        m.gauge("pending", len(loop._heap))
        m.gauge("peak_heap", loop.peak_heap)
        m.gauge("now", loop.now)
        net = cluster.net
        m.inc("messages_sent", value=net.messages_sent)
        m.inc("messages_delivered", value=net.messages_delivered)
        m.inc("messages_dropped", value=net.messages_dropped)
        m.inc("bytes_sent", value=net.bytes_sent)
        for nid, n in sorted(cluster.nodes.items()):
            m.gauge("term", n.term, node=nid)
            for name in _RAFT_COUNTERS:
                m.inc(name, node=nid, value=getattr(n, name))
        return m

    # -- compatibility accessors (the historical dicts, key-for-key) -------
    def loop_stats(self) -> dict:
        return {
            "events_popped": self.counter_total("events_popped"),
            "timers_scheduled": self.counter_total("timers_scheduled"),
            "timers_reaped": self.counter_total("timers_reaped"),
            "pending": self.gauge_value("pending"),
            "peak_heap": self.gauge_value("peak_heap"),
            "now": self.gauge_value("now"),
        }

    def net_stats(self) -> dict:
        return {
            "messages_sent": self.counter_total("messages_sent"),
            "messages_delivered": self.counter_total("messages_delivered"),
            "messages_dropped": self.counter_total("messages_dropped"),
            "bytes_sent": self.counter_total("bytes_sent"),
        }

    def raft_stats(self) -> dict:
        out = {"max_term": self.gauge_max("term")}
        for name in _RAFT_COUNTERS:
            out[name] = self.counter_total(name)
        return out

    def raft_stats_by_node(self) -> dict:
        """{node_id: {"term": ..., counter: ...}} — the per-node
        attribution the summed raft_stats lose."""
        out: dict = {}
        for nid, term in self.by_node("term").items():
            row = {"term": term}
            for name in _RAFT_COUNTERS:
                row[name] = self.counter(name, node=nid)
            out[nid] = row
        return out


# ------------------------------------------------------------------ series


def leader_timeline(events: list, t_end: Optional[float] = None) -> list:
    """Leadership spans [{node, term, t0, t1}] from role events. A span
    opens at a ``role=leader`` event and closes at that node's next role
    event (deposed/stepped down/crashed) or ``t_end``."""
    spans: list[dict] = []
    open_by_node: dict[int, dict] = {}
    last_t = 0.0
    for e in events:
        last_t = e["t"]
        if e["type"] != "role":
            continue
        node = e["node"]
        cur = open_by_node.pop(node, None)
        if cur is not None:
            cur["t1"] = e["t"]
            spans.append(cur)
        if e["role"] == "leader":
            open_by_node[node] = {"node": node, "term": e["term"],
                                  "t0": e["t"], "t1": None}
    end = last_t if t_end is None else t_end
    for cur in open_by_node.values():
        cur["t1"] = max(end, cur["t0"])
        spans.append(cur)
    spans.sort(key=lambda s: (s["t0"], s["node"]))
    return spans


def _union(intervals: list, t0: float, t1: float) -> float:
    """Total length of the union of [a, b] intervals clipped to [t0, t1]."""
    clipped = sorted((max(a, t0), min(b, t1)) for a, b in intervals)
    covered, cursor = 0.0, t0
    for a, b in clipped:
        if b <= cursor:
            continue
        covered += b - max(a, cursor)
        cursor = b
    return covered


def leader_uptime_fraction(events: list, t0: float, t1: float) -> float:
    """Fraction of [t0, t1] during which some node held leadership."""
    if t1 <= t0:
        return 0.0
    spans = leader_timeline(events, t_end=t1)
    return _union([(s["t0"], s["t1"]) for s in spans], t0, t1) / (t1 - t0)


def lease_coverage(events: list, t0: float, t1: float) -> float:
    """Fraction of [t0, t1] covered by some lease window: each
    acquire/extend event opens [t, until]. An upper bound on when local
    reads could be served without a round trip — the paper's
    '99% of reads' claim is this series staying near 1 across failovers."""
    if t1 <= t0:
        return 0.0
    windows = [(e["t"], e["until"]) for e in events
               if e["type"] == "lease" and e["op"] in ("acquire", "extend")]
    return _union(windows, t0, t1) / (t1 - t0)


def read_stall_histogram(events: list) -> dict:
    """Distribution of read stall durations (start→done/fail) in seconds.
    ``bins`` are cumulative ("le" = upper bound in seconds)."""
    stalls = sorted(e["stall"] for e in events
                    if e["type"] == "read" and e["op"] in ("done", "fail"))
    bounds = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0,
              float("inf"))
    bins = [{"le": b, "count": 0} for b in bounds]
    for s in stalls:
        for b in bins:
            if s <= b["le"]:
                b["count"] += 1

    def pct(q: float) -> float:
        if not stalls:
            return float("nan")
        return stalls[min(len(stalls) - 1, int(q * len(stalls)))]

    return {"count": len(stalls),
            "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
            "max": stalls[-1] if stalls else float("nan"),
            "bins": bins}


def election_to_first_commit(events: list) -> list:
    """Per leadership: latency from winning the election to the first
    commit advancement at that term — the write-unavailability window a
    failover costs (LeaseGuard's commit gate makes it visible)."""
    out = []
    pending: dict[int, dict] = {}
    for e in events:
        if e["type"] == "role" and e["role"] == "leader":
            pending[e["node"]] = e
        elif e["type"] == "role":
            pending.pop(e["node"], None)
        elif e["type"] == "commit":
            start = pending.pop(e["node"], None)
            if start is not None and e["term"] == start["term"]:
                out.append({"node": e["node"], "term": e["term"],
                            "t_elected": start["t"],
                            "latency": e["t"] - start["t"]})
    return out


def fault_detection_latency(events: list) -> list:
    """For each fault activation, the lag until the cluster visibly
    reacted: the first CheckQuorum step-down, eviction, or new campaign
    after the fault started. None = never detected within the trace."""
    reactions = [e for e in events if e["type"] == "role"
                 and (e["role"] == "candidate"
                      or e["reason"] in ("check_quorum", "deposed"))]
    out = []
    for e in events:
        if e["type"] != "fault" or e["op"] != "start":
            continue
        hit = next((r for r in reactions if r["t"] >= e["t"]), None)
        out.append({"fault": e["label"], "t": e["t"],
                    "detected_t": hit["t"] if hit else None,
                    "lag": (hit["t"] - e["t"]) if hit else None,
                    "via": (f"node {hit['node']} "
                            f"{hit['role']}/{hit['reason']}" if hit
                            else None)})
    return out


def derive_headline_series(events: list, t0: float, t1: float) -> dict:
    """The bundle the benchmarks and the explain CLI report."""
    return {
        "leader_timeline": leader_timeline(events, t_end=t1),
        "leader_uptime_fraction": leader_uptime_fraction(events, t0, t1),
        "lease_coverage": lease_coverage(events, t0, t1),
        "read_stalls": read_stall_histogram(events),
        "election_to_first_commit": election_to_first_commit(events),
        "fault_detection": fault_detection_latency(events),
    }
