"""Simulated message-passing network with delays, partitions, and node I/O.

Two latency components model the paper's experiments:

* **network delay**: lognormal one-way latency per message (paper §6.4 uses
  mean 1–10 ms for the latency study; §6.5 uses AWS same-subnet stats,
  mean 191 µs, variance 391 µs²-scaled).
* **I/O service time**: each node serializes outgoing message processing
  through a single queue with a per-message service time. This models the
  disk/NIC contention that makes quorum reads fight with replication for
  I/O — the effect behind the paper's ~10x write-throughput gap (Figs. 9-11)
  and the queueing blow-up in Fig. 10.

RPC layer: ``call()`` returns a Future for the reply, with timeout. One-way
``send()`` is also available.

Fault injection (the nemesis engine, ``repro.faults``) drives three knobs:

* **directional cuts**: partitions are stored per directed link, so
  asymmetric (one-way) partitions are expressible; the classic
  ``partition(a, b)`` cuts both directions.
* **message faults**: composable :class:`MessageFault` rules add extra
  delay, reorder jitter, probabilistic loss, and duplication, globally or
  per directed link.
* **I/O slowdown**: per-node extra service time on top of
  ``NetParams.io_service_time``.

With no faults installed the PRNG draw sequence is exactly the historical
one (one lognormal per transmission), so pre-nemesis seeds replay
bit-identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .prob import PRNG
from .simulate import EventLoop, Future, Timer, TimeoutError_, wait_for


@dataclass(slots=True)
class NetParams:
    one_way_latency_mean: float = 191e-6
    one_way_latency_variance: float = 391e-6 ** 2
    io_service_time: float = 0.0       # per outgoing message, serialized per node
    rpc_timeout: float = 0.5


@dataclass(slots=True)
class MessageFault:
    """One active message-perturbation rule.

    ``src``/``dst`` of ``None`` match any sender/receiver; both set
    restricts the rule to that directed link. Multiple installed rules
    compose: delays and jitter add, drop/duplicate draws are independent.
    """

    extra_delay: float = 0.0    # deterministic added one-way latency
    jitter: float = 0.0         # uniform extra in [0, jitter] -> reordering
    drop_prob: float = 0.0      # iid loss per message
    dup_prob: float = 0.0       # iid duplication per message
    src: Optional[int] = None
    dst: Optional[int] = None

    def matches(self, src: int, dst: int) -> bool:
        return (self.src is None or self.src == src) and \
               (self.dst is None or self.dst == dst)


class Network:
    __slots__ = ("loop", "prng", "params", "_handlers", "_cut", "_down",
                 "_io_busy_until", "_io_slow", "_faults", "_fault_seq",
                 "_intercept", "_intercept_seq",
                 "_rpc_seq", "_pending", "_reaps", "messages_sent",
                 "bytes_sent", "messages_delivered", "messages_dropped",
                 "_lat_mu", "_lat_sigma")

    def __init__(self, loop: EventLoop, prng: PRNG, params: NetParams) -> None:
        self.loop = loop
        self.prng = prng
        self.params = params
        self._handlers: dict[int, Callable[[int, Any], Any]] = {}
        self._cut: set[tuple[int, int]] = set()   # directed blocked links
        self._down: set[int] = set()
        self._io_busy_until: dict[int, float] = {}
        self._io_slow: dict[int, float] = {}      # per-node extra service time
        self._faults: dict[int, MessageFault] = {}
        self._fault_seq = 0
        # delivery interceptors: fn(src, dst, msg) -> msg' (possibly a
        # mutated copy) or None to drop. Applied at delivery time to both
        # requests and replies; with none installed the delivery path is
        # untouched (zero extra PRNG draws).
        self._intercept: dict[int, Callable[[int, int, Any], Any]] = {}
        self._intercept_seq = 0
        self._rpc_seq = 0
        self._pending: dict[int, Future] = {}
        self._reaps: dict[int, "Timer"] = {}      # rid -> pending-reap timer
        self.messages_sent = 0
        self.bytes_sent = 0
        self.messages_delivered = 0
        self.messages_dropped = 0                 # unreachable at delivery
        # the latency distribution is fixed per run: precompute the
        # underlying normal's (mu, sigma) once instead of per message (the
        # draw itself is unchanged — same lognormvariate call, same stream)
        mean, var = params.one_way_latency_mean, params.one_way_latency_variance
        if mean > 0:
            sigma2 = math.log(1.0 + var / (mean * mean))
            self._lat_mu = math.log(mean) - sigma2 / 2.0
            self._lat_sigma = math.sqrt(sigma2)
        else:
            self._lat_mu = None
            self._lat_sigma = 0.0

    # -- topology ----------------------------------------------------------
    def register(self, node_id: int, handler: Callable[[int, Any], Any]) -> None:
        """handler(src, msg) -> reply or None; called on delivery."""
        self._handlers[node_id] = handler

    def partition(self, a: int, b: int) -> None:
        self._cut.add((a, b))
        self._cut.add((b, a))

    def partition_oneway(self, src: int, dst: int) -> None:
        """Cut only src -> dst; dst can still reach src."""
        self._cut.add((src, dst))

    def heal(self, a: int = -1, b: int = -1) -> None:
        if a < 0:
            self._cut.clear()
        else:
            self._cut.discard((a, b))
            self._cut.discard((b, a))

    def heal_oneway(self, src: int, dst: int) -> None:
        self._cut.discard((src, dst))

    def set_down(self, node_id: int, down: bool = True) -> None:
        if down:
            self._down.add(node_id)
        else:
            self._down.discard(node_id)

    def reachable(self, src: int, dst: int) -> bool:
        return (
            src not in self._down
            and dst not in self._down
            and (src, dst) not in self._cut
        )

    # -- fault knobs ---------------------------------------------------------
    def add_fault(self, fault: MessageFault) -> int:
        """Install a message-perturbation rule; returns a removal handle."""
        self._fault_seq += 1
        self._faults[self._fault_seq] = fault
        return self._fault_seq

    def remove_fault(self, handle: int) -> None:
        self._faults.pop(handle, None)

    def add_interceptor(self, fn: Callable[[int, int, Any], Any]) -> int:
        """Install a delivery interceptor ``fn(src, dst, msg) -> msg|None``;
        returning a different object substitutes it (field-level corruption),
        returning None drops the message. Returns a removal handle."""
        self._intercept_seq += 1
        self._intercept[self._intercept_seq] = fn
        return self._intercept_seq

    def remove_interceptor(self, handle: int) -> None:
        self._intercept.pop(handle, None)

    def _apply_interceptors(self, src: int, dst: int, msg: Any) -> Any:
        for handle in sorted(self._intercept):
            msg = self._intercept[handle](src, dst, msg)
            if msg is None:
                return None
        return msg

    def set_io_slowdown(self, node_id: int, extra_service_time: float) -> None:
        """Extra per-message I/O service time for one node (0 clears)."""
        if extra_service_time > 0.0:
            self._io_slow[node_id] = extra_service_time
        else:
            self._io_slow.pop(node_id, None)

    # -- I/O serialization ---------------------------------------------------
    def _io_delay(self, node_id: int) -> float:
        """Serialize a node's message processing through one I/O queue."""
        svc = self.params.io_service_time + self._io_slow.get(node_id, 0.0)
        if svc <= 0:
            return 0.0
        start = max(self.loop.now, self._io_busy_until.get(node_id, 0.0))
        self._io_busy_until[node_id] = start + svc
        return (start + svc) - self.loop.now

    def _latency_draw(self) -> float:
        """One lognormal network-latency sample (precomputed mu/sigma)."""
        if self._lat_mu is None:
            return 0.0
        return self.prng.lognormvariate(self._lat_mu, self._lat_sigma)

    def _delivery_delays(self, src: int, dst: int) -> list[float]:
        """One delay per delivered copy of a message on src -> dst; empty
        list = dropped in flight. Matches the historical single-lognormal
        draw exactly when no fault rules are installed."""
        io = self._io_delay(src)
        base = io + self._latency_draw()
        if not self._faults:
            return [base]
        copies = 1
        extra = 0.0
        jitter = 0.0
        for handle in sorted(self._faults):
            f = self._faults[handle]
            if not f.matches(src, dst):
                continue
            if f.drop_prob > 0.0 and self.prng.random() < f.drop_prob:
                return []
            if f.dup_prob > 0.0 and self.prng.random() < f.dup_prob:
                copies += 1
            extra += f.extra_delay
            jitter += f.jitter
        delays = []
        for i in range(copies):
            d = base if i == 0 else io + self._latency_draw()
            d += extra
            if jitter > 0.0:
                d += self.prng.uniform(0.0, jitter)
            delays.append(d)
        return delays

    # -- messaging -----------------------------------------------------------
    def send(self, src: int, dst: int, msg: Any, size: int = 256) -> None:
        """Fire-and-forget delivery (reply, if any, is discarded)."""
        self._transmit(src, dst, msg, size, reply_to=None)

    def call(self, src: int, dst: int, msg: Any, size: int = 256,
             timeout: Optional[float] = None) -> "Future":
        """RPC: deliver msg; handler's return value resolves the future."""
        self._rpc_seq += 1
        rid = self._rpc_seq
        fut = Future(self.loop)
        self._pending[rid] = fut
        # reap the pending entry well after every caller has timed out, so
        # dropped messages (partitions, loss faults) don't leak futures;
        # the reap timer is cancelled on the fast path (reply delivered)
        self._reaps[rid] = self.loop.call_later_cancelable(
            4 * self.params.rpc_timeout, lambda: self._reap_rpc(rid))
        self._transmit(src, dst, msg, size, reply_to=rid)
        return fut

    def _reap_rpc(self, rid: int) -> None:
        self._pending.pop(rid, None)
        self._reaps.pop(rid, None)

    async def call_wait(self, src: int, dst: int, msg: Any, size: int = 256,
                        timeout: Optional[float] = None) -> Any:
        t = timeout if timeout is not None else self.params.rpc_timeout
        return await wait_for(self.call(src, dst, msg, size), t)

    def _transmit(self, src: int, dst: int, msg: Any, size: int,
                  reply_to: Optional[int]) -> None:
        self.messages_sent += 1
        self.bytes_sent += size

        def deliver() -> None:
            if not self.reachable(src, dst):
                self.messages_dropped += 1
                return  # dropped; RPC future times out at caller
            handler = self._handlers.get(dst)
            if handler is None:
                return
            m = msg
            if self._intercept:
                m = self._apply_interceptors(src, dst, m)
                if m is None:
                    self.messages_dropped += 1
                    return
            self.messages_delivered += 1
            reply = handler(src, m)
            if reply_to is not None and reply is not None:
                # reply travels back with its own I/O + network delay (and
                # is subject to the same loss/duplication faults)
                for rdelay in self._delivery_delays(dst, src):
                    def deliver_reply() -> None:
                        if not self.reachable(dst, src):
                            self.messages_dropped += 1
                            return
                        r = reply
                        if self._intercept:
                            r = self._apply_interceptors(dst, src, r)
                            if r is None:
                                self.messages_dropped += 1
                                return
                        fut = self._pending.pop(reply_to, None)
                        timer = self._reaps.pop(reply_to, None)
                        if timer is not None:
                            timer.cancel()
                        if fut is not None and not fut.done():
                            self.messages_delivered += 1
                            fut.set_result(r)

                    self.loop.call_later(rdelay, deliver_reply)

        for delay in self._delivery_delays(src, dst):
            self.loop.call_later(delay, deliver)
