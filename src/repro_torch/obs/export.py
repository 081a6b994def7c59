"""Trace exporters: JSONL dumps and Chrome ``trace_event`` JSON.

JSONL is the canonical on-disk format: one header line (schema name +
version + free-form run metadata) followed by one event per line, each
serialized with sorted keys and minimal separators — so the same seed
always produces a byte-identical file (the determinism contract
``tests/test_obs.py`` enforces).

:func:`to_chrome_trace` converts a trace to the Chrome ``trace_event``
format (the JSON-array flavor) so any run opens directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``: one "process" per
node (threads: roles / leases / reads / writes / barriers), plus a
faults process and a fleet process. Durations are reconstructed from
the event stream — leadership spans from role transitions, lease
windows from acquire/extend events, read spans from their recorded
stalls, fault windows from start/stop pairs.
"""

from __future__ import annotations

import json
from typing import Optional

from .metrics import leader_timeline
from .schema import header

_US = 1e6                       # trace_event timestamps are microseconds
_FAULT_PID = 1000
_FLEET_PID = 1001
_TIDS = {"role": 0, "lease": 1, "read": 2, "write": 3, "barrier": 4,
         "protocol": 5}


def dumps_event(e: dict) -> str:
    return json.dumps(e, sort_keys=True, separators=(",", ":"))


def write_jsonl(events: list, path, **meta) -> None:
    """Write header + events; byte-identical for identical traces."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps_event(header(**meta)) + "\n")
        for e in events:
            fh.write(dumps_event(e) + "\n")


def read_jsonl(path) -> tuple[dict, list]:
    """(header, events) from a JSONL trace file."""
    with open(path, "r", encoding="utf-8") as fh:
        head = json.loads(fh.readline())
        events = [json.loads(line) for line in fh if line.strip()]
    return head, events


def _instant(name: str, t: float, pid: int, tid: int,
             args: Optional[dict] = None) -> dict:
    ev = {"ph": "i", "name": name, "ts": round(t * _US, 3),
          "pid": pid, "tid": tid, "s": "t"}
    if args:
        ev["args"] = args
    return ev


def _span(name: str, t0: float, t1: float, pid: int, tid: int,
          args: Optional[dict] = None) -> dict:
    ev = {"ph": "X", "name": name, "ts": round(t0 * _US, 3),
          "dur": round(max(0.0, t1 - t0) * _US, 3), "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def to_chrome_trace(events: list, t_end: Optional[float] = None) -> dict:
    out: list[dict] = []
    nodes = sorted({e["node"] for e in events if e["node"] is not None})
    for nid in nodes:
        out.append({"ph": "M", "name": "process_name", "pid": nid,
                    "args": {"name": f"node {nid}"}})
        for tname, tid in _TIDS.items():
            out.append({"ph": "M", "name": "thread_name", "pid": nid,
                        "tid": tid, "args": {"name": tname}})
    out.append({"ph": "M", "name": "process_name", "pid": _FAULT_PID,
                "args": {"name": "faults"}})
    out.append({"ph": "M", "name": "process_name", "pid": _FLEET_PID,
                "args": {"name": "fleet"}})

    last_t = events[-1]["t"] if events else 0.0
    end = last_t if t_end is None else t_end

    # leadership spans
    for s in leader_timeline(events, t_end=end):
        out.append(_span(f"leader term {s['term']}", s["t0"], s["t1"],
                         s["node"], _TIDS["role"], {"term": s["term"]}))

    # merged lease windows per (node, term)
    lease: dict[tuple, list] = {}
    for e in events:
        if e["type"] == "lease" and e["op"] in ("acquire", "extend"):
            key = (e["node"], e["term"], e["entry_term"])
            w = lease.get(key)
            if w is None or e["t"] > w[1]:      # disjoint: new window
                lease[key] = w = [e["t"], e["until"]]
            else:
                w[1] = max(w[1], e["until"])
    for (nid, term, entry_term), (t0, t1) in sorted(lease.items()):
        kind = "lease" if entry_term == term else "inherited lease"
        out.append(_span(f"{kind} t{term}", t0, min(t1, end + 1.0), nid,
                         _TIDS["lease"], {"term": term,
                                          "entry_term": entry_term,
                                          "until": t1}))

    # fault windows (start/stop pairs by label; unpaired start -> to end)
    open_faults: dict[str, float] = {}
    for e in events:
        if e["type"] != "fault":
            continue
        if e["op"] == "start":
            open_faults.setdefault(e["label"], e["t"])
        elif e["op"] == "stop":
            t0 = open_faults.pop(e["label"], None)
            if t0 is not None:
                out.append(_span(e["label"], t0, e["t"], _FAULT_PID, 0))
            else:
                out.append(_instant(f"stop {e['label']}", e["t"],
                                    _FAULT_PID, 0))
        else:
            out.append(_instant(e["label"], e["t"], _FAULT_PID, 0))
    for label, t0 in sorted(open_faults.items()):
        out.append(_span(label, t0, end, _FAULT_PID, 0))

    for e in events:
        etype, nid = e["type"], e["node"]
        if etype == "read" and e["op"] in ("done", "fail"):
            name = "read" if e["op"] == "done" else f"read:{e['error']}"
            out.append(_span(name, e["t"] - e["stall"], e["t"], nid,
                             _TIDS["read"], {"key": e["key"]}))
        elif etype == "write" and e["op"] in ("done", "fail"):
            name = "write" if e["op"] == "done" else \
                f"write:{e.get('error', '?')}"
            out.append(_instant(name, e["t"], nid, _TIDS["write"],
                                {"key": e["key"]}))
        elif etype == "barrier" and e["op"] in ("ok", "fail"):
            out.append(_instant(f"barrier:{e['op']}", e["t"], nid,
                                _TIDS["barrier"]))
        elif etype in ("role", "term_bump", "election", "vote", "commit"):
            if etype == "role":
                name = f"{e['role']} ({e['reason']})"
            elif etype == "term_bump":
                name = f"term {e['prev']}->{e['term']}"
            elif etype == "election":
                name = f"{e['kind']} t{e['term']}"
            elif etype == "vote":
                name = (f"{'pre' if e['prevote'] else ''}vote "
                        f"{'granted' if e['granted'] else 'denied'} "
                        f"-> {e['candidate']}")
            else:
                name = f"commit {e['index']}"
            out.append(_instant(name, e["t"], nid, _TIDS["protocol"],
                                {"term": e["term"]}))
        elif etype == "lease" and e["op"] in ("relinquish", "gate_blocked"):
            out.append(_instant(f"lease {e['op']}", e["t"], nid,
                                _TIDS["lease"], {"term": e["term"]}))
        elif etype == "fleet":
            if e["op"] == "note":
                name = e["label"]
            elif e["op"] == "manifest":
                name = (f"manifest step {e['step']} "
                        f"{'ok' if e['ok'] else 'failed'}")
            elif e["op"] == "restore":
                name = f"restore {e['wid']} ({e['kind']})"
            elif e["op"] == "claim":
                name = f"chief {e['wid']} epoch {e['epoch']}"
            else:
                name = f"chief {e['wid']} deposed"
            out.append(_instant(name, e["t"], _FLEET_PID, 0))

    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"format": "repro.obs chrome export"}}


def write_chrome_trace(events: list, path,
                       t_end: Optional[float] = None) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_chrome_trace(events, t_end=t_end), fh, sort_keys=True)
