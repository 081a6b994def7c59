"""Offline invariant probes over recorded traces.

:func:`at_most_one_lease_holder` re-derives LeaseGuard's safety argument
(paper §3) from lease events alone — a second, independent check beside
the omniscient linearizability checker. The linearizability checker
looks at client histories; this probe looks at the *mechanism*: the
serving windows the lease machinery actually granted.

Window model
------------

Every ``lease`` event with op ``acquire``/``extend`` opens a serving
window ``[t, until]``: the emitting leader may serve local reads from
event time ``t`` until true time ``until = entry.interval.latest + Δ``
(an upper bound — the node's own bounded clock forces it to stop no
later than that). A window is **exclusive** when ``entry_term == term``:
it is backed by an entry of the holder's own term, so the holder may
also commit new writes under it. Inherited windows (``entry_term <
term``, §3.3) are backed by the *prior* leadership's entry — both
leaders serve the identical committed prefix, so their overlap is safe
by construction and exempt.

Invariants checked:

1. **one leader per term**: two different nodes never emit lease windows
   at the same term;
2. **exclusive windows never overlap across terms on different nodes**:
   the first own-term-backed window of term T2 must open strictly after
   every earlier term's serving deadline — exactly what the commit gate
   (Fig. 2) enforces via ``definitelyOlderThan`` — unless the earlier
   leadership *relinquished* (committed END_LEASE, §5.1 planned
   handover) before T2's window opened.

On traces of expect-safe scenarios with a consistent policy the probe
must return no violations; under unsafe faults (lying clocks, disk
wipes) a violation is a *finding* that localizes exactly which two
leaderships' windows overlapped and by how much.
"""

from __future__ import annotations


def at_most_one_lease_holder(events: list) -> list[dict]:
    """Return the list of violations (empty = invariant holds).

    Each violation dict carries ``check``, the two (node, term) pairs
    involved, and the overlap evidence.
    """
    violations: list[dict] = []
    nodes_by_term: dict[int, set] = {}
    # term -> [t_first_exclusive, until_max, node]
    excl: dict[int, list] = {}
    relinquished: dict[int, float] = {}

    for e in events:
        if e["type"] != "lease":
            continue
        op = e["op"]
        if op == "relinquish":
            t = relinquished.get(e["term"])
            relinquished[e["term"]] = e["t"] if t is None else min(t, e["t"])
            continue
        if op not in ("acquire", "extend"):
            continue
        term = e["term"]
        nodes_by_term.setdefault(term, set()).add(e["node"])
        if e["entry_term"] == term:
            w = excl.get(term)
            if w is None:
                excl[term] = [e["t"], e["until"], e["node"]]
            else:
                w[0] = min(w[0], e["t"])
                w[1] = max(w[1], e["until"])

    for term, nodes in sorted(nodes_by_term.items()):
        if len(nodes) > 1:
            violations.append({
                "check": "one_leader_per_term", "term": term,
                "nodes": sorted(nodes),
                "detail": f"lease windows at term {term} emitted by "
                          f"{len(nodes)} different nodes"})

    terms = sorted(excl)
    for i, t2 in enumerate(terms):
        start2, _, node2 = excl[t2]
        for t1 in terms[:i]:
            start1, until1, node1 = excl[t1]
            if node1 == node2:
                continue        # one process cannot serve concurrently
            if relinquished.get(t1) is not None \
                    and relinquished[t1] <= start2:
                continue        # planned handover: window ended early
            if start2 < until1 - 1e-9:
                violations.append({
                    "check": "exclusive_window_overlap",
                    "holder_a": {"node": node1, "term": t1,
                                 "window": [start1, until1]},
                    "holder_b": {"node": node2, "term": t2,
                                 "opened_at": start2},
                    "overlap": until1 - start2,
                    "detail": f"node {node2} opened an own-term lease "
                              f"window at t={start2:.6f} (term {t2}) while "
                              f"node {node1}'s term-{t1} window was still "
                              f"valid until t={until1:.6f}"})
    return violations
