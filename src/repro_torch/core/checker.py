"""Omniscient linearizability checker (paper §6.2).

The simulator knows the true time of every event. Each ``ListAppend``'s
``execution_ts`` is when the write was committed on the leader; each
``Read``'s is when it executed. Checking:

1. every successful op's execution time lies in ``[start_ts, end_ts]``
   (a failed-but-actually-committed append only needs ``exec >= start``);
2. sort by execution time — this IS the linearization (it respects real
   time by construction), so keys can be checked independently;
3. replay per-key append-only-list semantics: every successful read must
   observe exactly the list of preceding appends;
4. ties (identical execution times) are checked exactly: within a tie
   group the reads' observed lists must form a prefix chain extending the
   incoming state, using only that group's appends (equivalent to trying
   all orderings, but linear time);
5. a failed append with no execution time never took effect (the
   simulator is omniscient: any entry committed anywhere gets a commit
   timestamp), so the paper's two-way ambiguity collapses.

General linearizability checking is NP-complete [18]; omniscience makes
it tractable.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable

from .client import ClientLogEntry


class LinearizabilityError(AssertionError):
    pass


def check_linearizability(history: Iterable[ClientLogEntry]) -> int:
    """Raise LinearizabilityError on violation; return #ops checked."""
    per_key: dict[str, list[ClientLogEntry]] = defaultdict(list)
    n = 0
    for op in history:
        if op.op_type == "ListAppend":
            if op.success:
                if op.execution_ts is None:
                    raise LinearizabilityError(
                        f"acked append has no commit time: {op}")
                if not (op.start_ts <= op.execution_ts <= op.end_ts):
                    raise LinearizabilityError(
                        f"append executed outside [start, end]: {op}")
                per_key[op.key].append(op)
                n += 1
            elif op.execution_ts is not None:
                # failed at the client but actually committed
                if op.execution_ts < op.start_ts:
                    raise LinearizabilityError(
                        f"append committed before invocation: {op}")
                per_key[op.key].append(op)
                n += 1
        elif op.op_type == "Read" and op.success:
            if op.execution_ts is None or \
                    not (op.start_ts <= op.execution_ts <= op.end_ts):
                raise LinearizabilityError(
                    f"read executed outside [start, end]: {op}")
            per_key[op.key].append(op)
            n += 1
    for key, ops in per_key.items():
        _check_key(key, ops)
    return n


def _check_key(key: str, ops: list[ClientLogEntry]) -> None:
    ops.sort(key=lambda o: o.execution_ts)
    state: list = []
    i = 0
    while i < len(ops):
        # tie group: identical execution timestamps
        j = i
        ts = ops[i].execution_ts
        while j < len(ops) and ops[j].execution_ts == ts:
            j += 1
        group = ops[i:j]
        if len(group) == 1 and group[0].op_type == "Read":
            if list(group[0].value) != state:
                raise LinearizabilityError(
                    f"key {key}: read at t={ts} observed {group[0].value}, "
                    f"expected {state}")
        elif len(group) == 1:
            state.append(group[0].value)
        else:
            state = _check_tie_group(key, state, group)
        i = j


def _check_tie_group(key: str, state: list, group: list[ClientLogEntry]) -> list:
    appends = [o.value for o in group if o.op_type == "ListAppend"]
    reads = sorted((o for o in group if o.op_type == "Read"),
                   key=lambda o: len(o.value))
    # reads must form a prefix chain: state ⊑ r1 ⊑ r2 ⊑ ... using only this
    # group's appends for the extensions
    prev = list(state)
    used: list = []
    for r in reads:
        obs = list(r.value)
        if obs[:len(prev)] != prev or len(obs) < len(prev):
            raise LinearizabilityError(
                f"key {key}: tied read observed {obs}, incompatible with "
                f"{prev}")
        ext = obs[len(prev):]
        for v in ext:
            if v not in appends or v in used:
                raise LinearizabilityError(
                    f"key {key}: tied read observed unknown/duplicate "
                    f"append {v}")
            used.append(v)
        prev = obs
    final = list(prev) + [v for v in appends if v not in used]
    return final
