"""Trace event schema (version 1) and a dependency-free validator.

The schema is expressed twice from one table: :func:`validate_events`
(pure-Python structural validation used by tests and CI) and
:func:`json_schema` (a JSON-Schema document for external tooling).

Reserved keys on every event — stamped by :meth:`Tracer.emit`:
``id`` (int ≥ 1), ``t`` (seconds, float), ``type`` (str), ``node``
(int | null), ``term`` (int | null), ``parent`` (int | null).

Event types and their payload fields:

========== ============================================================
type       payload
========== ============================================================
role       ``role`` ∈ {follower, candidate, leader, down}, ``reason``
term_bump  ``prev`` (the term before the bump; ``term`` is the new one)
election   ``kind`` ∈ {campaign, prevote}
vote       ``candidate``, ``granted``, ``prevote`` (voter-side record)
lease      ``op`` ∈ {acquire, extend, relinquish, gate_blocked};
           acquire/extend/gate_blocked carry ``entry_term`` + ``until``
           (the lease window's true-time serving deadline,
           ``entry.interval.latest + Δ``)
commit     ``index`` (leader commit advancement)
read       ``op`` ∈ {start, done, fail}; ``key``; done/fail carry
           ``stall`` (seconds from start); fail carries ``error``
write      ``op`` ∈ {start, done, fail}; ``key``; fail carries ``error``
barrier    ``op`` ∈ {start, ok, fail} (policy read barriers, e.g. the
           quorum policy's empty-AppendEntries confirmation round)
fault      ``op`` ∈ {start, stop, note}; ``label`` (fault name / note)
fleet      ``op`` ∈ {claim, deposed, manifest, restore, note} with
           op-specific fields (``wid``, ``epoch``, ``step``, ``ok``,
           ``kind``, ``label``)
========== ============================================================
"""

from __future__ import annotations

import json
from typing import Optional

SCHEMA_NAME = "leaseguard-trace"
SCHEMA_VERSION = 1

_NUM = (int, float)

#: type -> required payload fields -> allowed python types
EVENT_TYPES: dict = {
    "role": {"role": (str,), "reason": (str,)},
    "term_bump": {"prev": (int,)},
    "election": {"kind": (str,)},
    "vote": {"candidate": (int,), "granted": (bool,), "prevote": (bool,)},
    "lease": {"op": (str,)},
    "commit": {"index": (int,)},
    "read": {"op": (str,), "key": (str,)},
    "write": {"op": (str,), "key": (str,)},
    "barrier": {"op": (str,)},
    "fault": {"op": (str,), "label": (str,)},
    "fleet": {"op": (str,)},
}

#: (type, op) -> extra required fields
_OP_FIELDS: dict = {
    ("lease", "acquire"): {"entry_term": (int,), "until": _NUM},
    ("lease", "extend"): {"entry_term": (int,), "until": _NUM},
    ("lease", "gate_blocked"): {"entry_term": (int,), "until": _NUM},
    ("read", "done"): {"stall": _NUM},
    ("read", "fail"): {"stall": _NUM, "error": (str,)},
    ("write", "fail"): {"error": (str,)},
    ("fleet", "claim"): {"wid": (str,), "epoch": (int,)},
    ("fleet", "deposed"): {"wid": (str,)},
    ("fleet", "manifest"): {"step": (int,), "ok": (bool,)},
    ("fleet", "restore"): {"wid": (str,), "kind": (str,)},
    ("fleet", "note"): {"label": (str,)},
}

_OPS: dict = {
    "role": None,  # validated via the "role" field instead
    "lease": {"acquire", "extend", "relinquish", "gate_blocked"},
    "read": {"start", "done", "fail"},
    "write": {"start", "done", "fail"},
    "barrier": {"start", "ok", "fail"},
    "fault": {"start", "stop", "note"},
    "fleet": {"claim", "deposed", "manifest", "restore", "note"},
}

_ROLES = {"follower", "candidate", "leader", "down"}


def header(**meta) -> dict:
    """The first line of every JSONL trace file."""
    h = {"schema": SCHEMA_NAME, "version": SCHEMA_VERSION}
    h.update(meta)
    return h


def _check(e: dict, key: str, types, problems: list, where: str) -> bool:
    if key not in e:
        problems.append(f"{where}: missing field {key!r}")
        return False
    v = e[key]
    # bool is an int subclass; require exact intent
    if bool in types:
        ok = isinstance(v, bool)
    else:
        ok = isinstance(v, types) and not isinstance(v, bool)
    if not ok:
        problems.append(f"{where}: field {key!r} has type "
                        f"{type(v).__name__}, wanted {types}")
        return False
    return True


def validate_event(e: dict, where: str = "event") -> list[str]:
    problems: list[str] = []
    if not isinstance(e, dict):
        return [f"{where}: not an object"]
    _check(e, "id", (int,), problems, where)
    _check(e, "t", _NUM, problems, where)
    for key in ("node", "term", "parent"):
        if key not in e:
            problems.append(f"{where}: missing field {key!r}")
        elif e[key] is not None and (not isinstance(e[key], int)
                                     or isinstance(e[key], bool)):
            problems.append(f"{where}: field {key!r} must be int or null")
    if not _check(e, "type", (str,), problems, where):
        return problems
    etype = e["type"]
    spec = EVENT_TYPES.get(etype)
    if spec is None:
        problems.append(f"{where}: unknown event type {etype!r}")
        return problems
    for key, types in spec.items():
        _check(e, key, types, problems, where)
    if etype == "role" and e.get("role") not in _ROLES:
        problems.append(f"{where}: bad role {e.get('role')!r}")
    ops = _OPS.get(etype)
    if ops and "op" in e:
        op = e["op"]
        if op not in ops:
            problems.append(f"{where}: bad {etype} op {op!r}")
        for key, types in _OP_FIELDS.get((etype, op), {}).items():
            _check(e, key, types, problems, where)
    return problems


def validate_events(events: list, max_problems: int = 50) -> list[str]:
    """Structural validation plus cross-event invariants (ids strictly
    increasing, sim time monotone, parents refer to earlier events)."""
    problems: list[str] = []
    last_id, last_t = 0, float("-inf")
    seen: set = set()
    for i, e in enumerate(events):
        where = f"event[{i}]"
        problems.extend(validate_event(e, where))
        if isinstance(e, dict):
            eid, t, parent = e.get("id"), e.get("t"), e.get("parent")
            if isinstance(eid, int):
                if eid <= last_id:
                    problems.append(f"{where}: id {eid} not increasing")
                last_id = eid
                seen.add(eid)
            if isinstance(t, _NUM) and not isinstance(t, bool):
                if t < last_t:
                    problems.append(f"{where}: time went backwards")
                last_t = t
            if parent is not None and parent not in seen:
                problems.append(f"{where}: parent {parent} not an "
                                f"earlier event id")
        if len(problems) >= max_problems:
            problems.append("... (truncated)")
            break
    return problems


def validate_jsonl(path) -> list[str]:
    """Validate a JSONL trace file: header line + every event line."""
    problems: list[str] = []
    events: list[dict] = []
    with open(path, "r", encoding="utf-8") as fh:
        first = fh.readline()
        try:
            h = json.loads(first)
        except ValueError:
            return [f"{path}: header line is not JSON"]
        if not isinstance(h, dict) or h.get("schema") != SCHEMA_NAME:
            problems.append(f"{path}: bad header schema "
                            f"{h.get('schema') if isinstance(h, dict) else h!r}")
        elif h.get("version") != SCHEMA_VERSION:
            problems.append(f"{path}: unsupported version {h.get('version')}")
        for lineno, line in enumerate(fh, start=2):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                problems.append(f"{path}:{lineno}: not JSON")
    problems.extend(validate_events(events))
    return problems


def json_schema() -> dict:
    """A JSON-Schema (draft-07) document for one trace event — generated
    from the same table the validator uses."""
    def jt(types) -> list:
        out = []
        for t in types:
            out.append({int: "integer", float: "number", str: "string",
                        bool: "boolean"}[t])
        if "number" in out and "integer" in out:
            out.remove("integer")
        return out

    variants = []
    for etype, spec in sorted(EVENT_TYPES.items()):
        props = {k: {"type": jt(v)} for k, v in spec.items()}
        props["type"] = {"const": etype}
        variants.append({"properties": props,
                         "required": ["type"] + sorted(spec)})
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "title": f"{SCHEMA_NAME} event (version {SCHEMA_VERSION})",
        "type": "object",
        "properties": {
            "id": {"type": "integer", "minimum": 1},
            "t": {"type": "number"},
            "type": {"enum": sorted(EVENT_TYPES)},
            "node": {"type": ["integer", "null"]},
            "term": {"type": ["integer", "null"]},
            "parent": {"type": ["integer", "null"]},
        },
        "required": ["id", "t", "type", "node", "term", "parent"],
        "anyOf": variants,
    }


def first_problem(events: list) -> Optional[str]:
    problems = validate_events(events)
    return problems[0] if problems else None
