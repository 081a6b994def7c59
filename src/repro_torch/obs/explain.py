"""Failure forensics: reconstruct *why* a read stalled, failed, or went
stale from a recorded trace's causal chain.

CLI::

    python -m repro.obs.explain TRACE.jsonl [TRACE2.jsonl ...]
    python -m repro.obs.explain traces/            # every *.jsonl inside
    options:
      --validate      validate against the trace schema (exit 1 on error)
      --probe         run the at-most-one-lease-holder probe (exit 1 on
                      violation)
      --failures N    explain up to N failed/stalled reads (default 5)
      --stale N       explain up to N suspected stale reads (default 3)
      --json          machine-readable output

The same analysis feeds :func:`trace_digest`, the compact JSON blob the
benchmark matrices embed in flagged artifact rows — so a violation in
``BENCH_fault_matrix.json`` names the causal election/partition inline.

Causal reconstruction works two ways at once:

* **parent chain**: every read/write/lease event parents to the
  emitting node's role-transition context, and role events chain
  backwards — walking ``parent`` links from a failed read reaches the
  election (or crash) that put the node in the state that refused it;
* **time-window joins**: fault activation windows (``fault`` events)
  and elections are matched to the moment of the failure, naming the
  partition/crash that was active when it happened.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from .metrics import derive_headline_series
from .probes import at_most_one_lease_holder
from .schema import validate_jsonl


# ----------------------------------------------------------- causal helpers
def index_by_id(events: list) -> dict:
    return {e["id"]: e for e in events}


def causal_chain(by_id: dict, event: dict, max_depth: int = 32) -> list:
    """The event plus its ancestors, root first."""
    chain = [event]
    seen = {event["id"]}
    cur = event
    while len(chain) < max_depth:
        pid = cur.get("parent")
        if pid is None or pid in seen:
            break
        cur = by_id.get(pid)
        if cur is None:
            break
        seen.add(cur["id"])
        chain.append(cur)
    chain.reverse()
    return chain


def active_faults(events: list, t: float) -> list[str]:
    """Fault labels whose [start, stop) window contains t (no stop seen =
    active to the end of the trace)."""
    open_at: dict[str, float] = {}
    active: set[str] = set()
    for e in events:
        if e["type"] != "fault" or e["t"] > t:
            continue
        if e["op"] == "start":
            open_at[e["label"]] = e["t"]
            active.add(e["label"])
        elif e["op"] == "stop":
            active.discard(e["label"])
    return sorted(active)


def election_of_term(events: list, term: int) -> Optional[dict]:
    """The role=leader event that won ``term`` (None if never won)."""
    for e in events:
        if e["type"] == "role" and e["role"] == "leader" \
                and e["term"] == term:
            return e
    return None


def _fmt_cause(events: list, by_id: dict, ev: dict) -> str:
    """One-line causal narrative for a read event (fail or slow done)."""
    node, t = ev["node"], ev["t"]
    chain = causal_chain(by_id, ev)
    role_ev = next((c for c in reversed(chain) if c["type"] == "role"), None)
    bits = []
    if ev["op"] == "fail":
        bits.append(f"read {ev['key']!r} on node {node} failed "
                    f"({ev['error']}) at t={t:.3f}")
    else:
        bits.append(f"read {ev['key']!r} on node {node} at t={t:.3f} "
                    f"(stall {ev.get('stall', 0) * 1e3:.1f} ms)")
    if role_ev is not None:
        bits.append(f"node {node} was {role_ev['role']} since "
                    f"t={role_ev['t']:.3f} ({role_ev['reason']}, "
                    f"term {role_ev['term']})")
    # which leadership superseded this node's view?
    max_term = max((e["term"] for e in events
                    if e["t"] <= t and e["term"] is not None), default=None)
    if max_term is not None and ev["term"] is not None \
            and max_term > ev["term"]:
        win = election_of_term(events, max_term)
        if win is not None:
            bits.append(f"caused by the term-{max_term} election won by "
                        f"node {win['node']} at t={win['t']:.3f} while "
                        f"node {node} still believed term {ev['term']}")
        else:
            bits.append(f"term had moved on to {max_term} without a "
                        f"winner yet")
    faults = active_faults(events, t)
    if faults:
        bits.append("active fault(s): " + ", ".join(faults))
    return "; ".join(bits)


def failed_reads(events: list) -> list:
    return [e for e in events if e["type"] == "read" and e["op"] == "fail"]


def stalled_reads(events: list, min_stall: float = 0.01) -> list:
    return sorted((e for e in events if e["type"] == "read"
                   and e["op"] == "done" and e["stall"] >= min_stall),
                  key=lambda e: -e["stall"])


def stale_read_suspects(events: list) -> list:
    """Reads *served* by a node whose term lagged the cluster maximum at
    serve time — the deposed-leader / lagging-replica signature of the
    inconsistent policy's stale reads. Over-approximate on purpose: a
    suspect is somewhere a stale read COULD have been served; the
    linearizability checker says whether one actually was."""
    suspects = []
    max_term = 0
    for e in events:
        if e["term"] is not None and e["term"] > max_term:
            max_term = e["term"]
        if e["type"] == "read" and e["op"] == "done" \
                and e["term"] is not None and e["term"] < max_term:
            suspects.append(e)
    return suspects


def explain_reads(events: list, n_failures: int = 5,
                  n_stale: int = 3) -> dict:
    by_id = index_by_id(events)
    fails = failed_reads(events)
    stale = stale_read_suspects(events)
    return {
        "failed_reads": len(fails),
        "stale_suspects": len(stale),
        "failure_causes": [_fmt_cause(events, by_id, e)
                           for e in fails[:n_failures]],
        "stale_causes": [_fmt_cause(events, by_id, e)
                         for e in stale[:n_stale]],
        "slowest_reads": [_fmt_cause(events, by_id, e)
                          for e in stalled_reads(events)[:3]],
    }


# ------------------------------------------------------------------ digest
def trace_digest(events: list, t0: float, t1: float,
                 max_items: int = 6) -> dict:
    """The compact forensic summary flagged matrix rows embed: elections,
    fault windows, lease-probe verdict, and up-to-three causal narratives
    for suspect stale / failed reads. Deterministic and small (~1 KB)."""
    by_id = index_by_id(events)
    elections = [{"t": round(e["t"], 6), "node": e["node"],
                  "term": e["term"]}
                 for e in events
                 if e["type"] == "role" and e["role"] == "leader"]
    faults = []
    open_at: dict[str, float] = {}
    for e in events:
        if e["type"] != "fault":
            continue
        if e["op"] == "start":
            open_at[e["label"]] = e["t"]
        elif e["op"] == "stop" and e["label"] in open_at:
            faults.append({"fault": e["label"],
                           "t0": round(open_at.pop(e["label"]), 6),
                           "t1": round(e["t"], 6)})
    for label, t in sorted(open_at.items()):
        faults.append({"fault": label, "t0": round(t, 6), "t1": None})
    probe = at_most_one_lease_holder(events)
    series = derive_headline_series(events, t0, t1)
    stale = stale_read_suspects(events)
    fails = failed_reads(events)
    return {
        "schema": 1,
        "events": len(events),
        "elections": elections[:max_items],
        "n_elections": len(elections),
        "faults": faults[:max_items],
        "lease_probe_violations": len(probe),
        "leader_uptime": round(series["leader_uptime_fraction"], 4),
        "lease_coverage": round(series["lease_coverage"], 4),
        "failed_reads": len(fails),
        "stale_suspects": len(stale),
        "causes": ([_fmt_cause(events, by_id, e) for e in stale[:3]]
                   or [_fmt_cause(events, by_id, e) for e in fails[:3]]),
    }


# --------------------------------------------------------------------- CLI
def _collect_paths(args: list[str]) -> list[Path]:
    paths: list[Path] = []
    for a in args:
        p = Path(a)
        if p.is_dir():
            paths.extend(sorted(p.glob("*.jsonl")))
        else:
            paths.append(p)
    return paths


def explain_file(path: Path, validate: bool = False, probe: bool = False,
                 n_failures: int = 5, n_stale: int = 3) -> dict:
    from .export import read_jsonl
    out: dict = {"trace": str(path)}
    if validate:
        problems = validate_jsonl(path)
        out["schema_problems"] = problems
    head, events = read_jsonl(path)
    out["header"] = head
    t0 = events[0]["t"] if events else 0.0
    t1 = events[-1]["t"] if events else 0.0
    out["series"] = derive_headline_series(events, t0, t1)
    out["reads"] = explain_reads(events, n_failures, n_stale)
    if probe:
        out["lease_probe"] = at_most_one_lease_holder(events)
    return out


def _print_human(r: dict) -> None:
    print(f"== {r['trace']}")
    head = r.get("header", {})
    meta = {k: v for k, v in head.items() if k not in ("schema", "version")}
    if meta:
        print(f"   run: {meta}")
    if "schema_problems" in r:
        ok = not r["schema_problems"]
        print(f"   schema: {'OK' if ok else 'INVALID'}")
        for p in r["schema_problems"][:10]:
            print(f"     ! {p}")
    s = r["series"]
    spans = s["leader_timeline"]
    print(f"   leaderships: {len(spans)}  "
          f"uptime {s['leader_uptime_fraction']:.1%}  "
          f"lease coverage {s['lease_coverage']:.1%}")
    for sp in spans[:8]:
        print(f"     node {sp['node']} term {sp['term']}: "
              f"t={sp['t0']:.3f} -> {sp['t1']:.3f}")
    efc = s["election_to_first_commit"]
    if efc:
        lat = ", ".join(f"t{x['term']}: {x['latency'] * 1e3:.0f}ms"
                        for x in efc[:6])
        print(f"   election -> first commit: {lat}")
    det = [d for d in s["fault_detection"] if d["lag"] is not None]
    for d in det[:6]:
        print(f"   fault {d['fault']} at t={d['t']:.3f} detected "
              f"+{d['lag'] * 1e3:.0f}ms via {d['via']}")
    rd = r["reads"]
    print(f"   reads: {rd['failed_reads']} failed, "
          f"{rd['stale_suspects']} stale suspects")
    for line in rd["failure_causes"]:
        print(f"     fail: {line}")
    for line in rd["stale_causes"]:
        print(f"     stale: {line}")
    for line in rd["slowest_reads"]:
        print(f"     slow: {line}")
    if "lease_probe" in r:
        v = r["lease_probe"]
        print(f"   lease probe: "
              f"{'OK (at most one holder)' if not v else 'VIOLATED'}")
        for x in v[:5]:
            print(f"     ! {x['detail']}")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.obs.explain",
        description="Reconstruct why reads stalled/failed from a trace.")
    ap.add_argument("paths", nargs="+",
                    help="trace .jsonl files or directories of them")
    ap.add_argument("--validate", action="store_true",
                    help="validate against the trace schema")
    ap.add_argument("--probe", action="store_true",
                    help="run the at-most-one-lease-holder probe")
    ap.add_argument("--failures", type=int, default=5, metavar="N")
    ap.add_argument("--stale", type=int, default=3, metavar="N")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    paths = _collect_paths(args.paths)
    if not paths:
        print("no trace files found", file=sys.stderr)
        return 2
    rc = 0
    results = []
    for path in paths:
        r = explain_file(path, validate=args.validate, probe=args.probe,
                         n_failures=args.failures, n_stale=args.stale)
        results.append(r)
        if r.get("schema_problems"):
            rc = 1
        if r.get("lease_probe"):
            rc = 1
    if args.json:
        json.dump(results, sys.stdout, indent=1, default=str)
        print()
    else:
        for r in results:
            _print_human(r)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
