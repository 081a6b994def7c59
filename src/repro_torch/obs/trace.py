"""The Tracer: a flight recorder for the deterministic simulator.

One :class:`Tracer` attaches to one :class:`~repro.core.simulate.EventLoop`
(``loop.tracer``). Every instrumentation site in the simulator follows the
same contract:

* **default-off**: the site costs one attribute load + ``is not None``
  check when tracing is disabled — no allocation, no draw, no branch into
  tracer code. Untraced runs replay bit-identically to a build without
  the tracer at all.
* **draw-order-neutral when enabled**: ``emit`` only appends to a Python
  list. It never touches a PRNG, never schedules loop callbacks, never
  mutates simulation state — so a traced run produces the exact same
  history as the untraced run of the same seed.

Events are plain dicts (directly JSON-serializable) with six reserved
keys stamped by ``emit``:

* ``id`` — 1-based emission-order id (deterministic per seed),
* ``t`` — simulated time of emission,
* ``type`` — one of :data:`~repro.obs.schema.EVENT_TYPES`,
* ``node`` — emitting node id (``None`` for fault/fleet-level events),
* ``term`` — the emitting node's Raft term at emission,
* ``parent`` — causal parent event id (``None`` for roots).

plus per-type payload fields (see :mod:`repro.obs.schema`). The causal
parent convention: each node carries ``_trace_ctx``, the id of its latest
role-transition event; everything the node does (reads, writes, lease
transitions, commits, votes) parents to that leadership/followership
context, and role events chain to the previous role event — so walking
``parent`` links from a failed read reaches the exact election (and, via
time-window joins on fault events, the exact partition) that caused it.
"""

from __future__ import annotations

from typing import Optional


class Tracer:
    """Typed, schema-versioned event recorder (see module docstring)."""

    __slots__ = ("loop", "events", "_next_id")

    def __init__(self, loop=None) -> None:
        self.loop = loop
        self.events: list[dict] = []
        self._next_id = 0
        if loop is not None:
            loop.tracer = self

    def attach(self, loop) -> "Tracer":
        self.loop = loop
        loop.tracer = self
        return self

    def detach(self) -> None:
        if self.loop is not None:
            self.loop.tracer = None
            self.loop = None

    def emit(self, etype: str, node: Optional[int] = None,
             term: Optional[int] = None, parent: Optional[int] = None,
             **fields) -> int:
        """Record one event; returns its id (for use as a causal parent).

        Must stay allocation-cheap and side-effect-free w.r.t. the
        simulation: callers pass only already-computed values.
        """
        self._next_id += 1
        e = {"id": self._next_id, "t": self.loop.now, "type": etype,
             "node": node, "term": term, "parent": parent}
        if fields:
            e.update(fields)
        self.events.append(e)
        return self._next_id

    def __len__(self) -> int:
        return len(self.events)
