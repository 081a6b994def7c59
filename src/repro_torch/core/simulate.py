"""Deterministic discrete-event simulator (paper §6.1, ``simulate.py``).

An event loop with callbacks scheduled at future simulated times, plus a
task/future/coroutine layer similar to Python's asyncio — but fully
deterministic: given a seed and parameters, every run executes the same
events in the same order.

Time is a float in **seconds** of simulated "true time". Nodes never read
this directly; they use :class:`repro.core.clock.BoundedClock`, which wraps
true time in an uncertainty interval.

Fast-path design notes (the simulator is the sweep bottleneck — see
``benchmarks/simperf.py`` for the tracked baseline):

* **Lazy-cancel timers**: :meth:`EventLoop.call_later_cancelable` returns a
  :class:`Timer` whose ``cancel()`` marks the heap entry dead in O(1); dead
  entries are skipped (reaped) when they reach the heap head instead of
  churning through a full event dispatch. RPC timeouts, reply-reaping and
  heartbeat parks all cancel their timers on the common (fast) path, which
  keeps the heap small and skips their no-op callbacks entirely.
* **Allocation-light wakeups**: ``Future._fire`` schedules ONE bound method
  per resolution instead of one closure per callback, and ``sleep`` uses
  ``Future._wake`` instead of a fresh lambda per sleep.
* **Instrumentation**: cheap counters (events popped, timers reaped, peak
  heap size) are maintained inline and exposed via :meth:`EventLoop.stats`
  so optimizations are measured, not guessed.

Everything above is *order-preserving*: the same (seed, params) pair pops
the same live events in the same sequence as the unoptimized loop, so PRNG
draw order — and therefore every simulated history — is unchanged.
"""

from __future__ import annotations

import heapq
import inspect
from typing import Any, Callable, Coroutine, Iterable, Optional


class Timer:
    """Handle for a cancelable heap entry.

    ``cancel()`` is O(1): it clears the callback; the entry itself is
    reaped lazily when it surfaces at the heap head (removing an arbitrary
    heap element would be O(n))."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], None]) -> None:
        self._fn = fn

    def cancel(self) -> None:
        self._fn = None

    @property
    def cancelled(self) -> bool:
        return self._fn is None


class EventLoop:
    """A deterministic event loop over simulated time."""

    __slots__ = ("_heap", "_seq", "now", "_stopped",
                 "events_popped", "timers_scheduled", "timers_reaped",
                 "peak_heap", "tracer")

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = 0  # tie-breaker: FIFO among same-deadline callbacks
        self.now: float = 0.0
        self._stopped = False
        # -- instrumentation (cheap enough to keep always-on) --
        self.events_popped = 0     # live events dispatched
        self.timers_scheduled = 0  # cancelable timers created
        self.timers_reaped = 0     # cancelled entries skipped at pop
        self.peak_heap = 0         # high-water mark of pending entries
        # flight recorder (repro.obs.trace.Tracer) or None. Default-off:
        # instrumentation sites across the stack guard on
        # ``loop.tracer is not None`` and make zero PRNG draws, so
        # untraced runs replay bit-identically and traced runs are
        # draw-order-neutral.
        self.tracer = None

    # -- scheduling ------------------------------------------------------
    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        if when < self.now:
            when = self.now
        heap = self._heap
        heapq.heappush(heap, (when, self._seq, fn))
        self._seq += 1
        if len(heap) > self.peak_heap:
            self.peak_heap = len(heap)

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self.call_at(self.now + delay if delay > 0.0 else self.now, fn)

    def call_soon(self, fn: Callable[[], None]) -> None:
        self.call_at(self.now, fn)

    def call_at_cancelable(self, when: float, fn: Callable[[], None]) -> Timer:
        t = Timer(fn)
        self.call_at(when, t)
        self.timers_scheduled += 1
        return t

    def call_later_cancelable(self, delay: float,
                              fn: Callable[[], None]) -> Timer:
        return self.call_at_cancelable(
            self.now + delay if delay > 0.0 else self.now, fn)

    # -- running ---------------------------------------------------------
    def _next_time(self) -> Optional[float]:
        """Earliest *live* event time; reaps dead timers at the head."""
        heap = self._heap
        while heap:
            head = heap[0]
            fn = head[2]
            if fn.__class__ is Timer and fn._fn is None:
                heapq.heappop(heap)
                self.timers_reaped += 1
                continue
            return head[0]
        return None

    def _step(self) -> bool:
        heap = self._heap
        while heap:
            when, _, fn = heapq.heappop(heap)
            if fn.__class__ is Timer:
                fn = fn._fn
                if fn is None:
                    self.timers_reaped += 1
                    continue
            if when > self.now:
                self.now = when
            self.events_popped += 1
            fn()
            return True
        return False

    def run_until(self, deadline: float) -> None:
        """Run events with time <= deadline; advance clock to deadline."""
        while not self._stopped:
            t = self._next_time()
            if t is None or t > deadline:
                break
            self._step()
        if deadline > self.now:
            self.now = deadline

    def run_until_complete(self, fut: "Future", max_time: float = float("inf")):
        while not fut.done():
            t = self._next_time()
            if self._stopped or t is None or t > max_time:
                raise RuntimeError(
                    f"future not resolved by t={self.now:.6f} "
                    f"(heap={'empty' if t is None else 'future events'})"
                )
            self._step()
        return fut.result()

    def run(self, max_time: float = float("inf")) -> None:
        while not self._stopped:
            t = self._next_time()
            if t is None or t > max_time:
                break
            self._step()

    def stop(self) -> None:
        self._stopped = True

    def stats(self) -> dict:
        """Instrumentation snapshot (events dispatched, timer churn, heap
        high-water mark) — the raw inputs of ``benchmarks/simperf.py``."""
        return {
            "events_popped": self.events_popped,
            "timers_scheduled": self.timers_scheduled,
            "timers_reaped": self.timers_reaped,
            "pending": len(self._heap),
            "peak_heap": self.peak_heap,
            "now": self.now,
        }

    # -- coroutine layer --------------------------------------------------
    def create_task(self, coro: Coroutine) -> "Task":
        return Task(self, coro)

    def sleep(self, delay: float) -> "Future":
        f = Future(self)
        self.call_later(delay, f._wake)
        return f


class Future:
    """Awaitable one-shot result container bound to an :class:`EventLoop`."""

    __slots__ = ("loop", "_done", "_result", "_exc", "_callbacks")

    def __init__(self, loop: EventLoop) -> None:
        self.loop = loop
        self._done = False
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: list[Callable[["Future"], None]] = []

    def done(self) -> bool:
        return self._done

    def set_result(self, value: Any) -> None:
        if self._done:
            raise RuntimeError("future already resolved")
        self._done = True
        self._result = value
        if self._callbacks:
            self.loop.call_soon(self._run_callbacks)

    def set_exception(self, exc: BaseException) -> None:
        if self._done:
            raise RuntimeError("future already resolved")
        self._done = True
        self._exc = exc
        if self._callbacks:
            self.loop.call_soon(self._run_callbacks)

    def _wake(self) -> None:
        """Resolve with None unless already resolved (sleep/timeout path)."""
        if not self._done:
            self.set_result(None)

    def _run_callbacks(self) -> None:
        # One scheduled event runs every callback registered at resolution
        # time, in registration order — equivalent to scheduling each
        # callback individually (their seq numbers were contiguous), but
        # with a single heap entry and no per-callback closure.
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        if self._done:
            self.loop.call_soon(lambda: cb(self))
        else:
            self._callbacks.append(cb)

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("future not done")
        if self._exc is not None:
            raise self._exc
        return self._result

    def __await__(self):
        if not self._done:
            yield self
        return self.result()


class Task(Future):
    """Drives a coroutine on the event loop. Awaitable like a Future."""

    __slots__ = ("_coro", "_cancelled")

    def __init__(self, loop: EventLoop, coro: Coroutine) -> None:
        super().__init__(loop)
        assert inspect.iscoroutine(coro), coro
        self._coro = coro
        self._cancelled = False
        loop.call_soon(self._start)

    def cancel(self) -> None:
        self._cancelled = True

    def _start(self) -> None:
        self._advance(None, None)

    def _resume(self, fut: "Future") -> None:
        exc = fut._exc
        if exc is not None:
            self._advance(None, exc)
        else:
            self._advance(fut._result, None)

    def _advance(self, value: Any, exc: Optional[BaseException]) -> None:
        if self._done:
            return
        if self._cancelled:
            self._coro.close()
            if not self._done:
                self.set_exception(CancelledError())
            return
        try:
            if exc is not None:
                awaited = self._coro.throw(exc)
            else:
                awaited = self._coro.send(value)
        except StopIteration as stop:
            self.set_result(stop.value)
            return
        except BaseException as e:  # noqa: BLE001 - propagate into the future
            self.set_exception(e)
            return
        assert isinstance(awaited, Future), f"can only await Futures, got {awaited!r}"
        if awaited._done:
            self.loop.call_soon(lambda: self._resume(awaited))
        else:
            awaited._callbacks.append(self._resume)


class CancelledError(Exception):
    pass


class TimeoutError_(Exception):
    pass


def wait_for(fut: Future, timeout: float) -> Future:
    """Await ``fut`` with a simulated-time timeout.

    Returns a Future that resolves with ``fut``'s result, or raises
    :class:`TimeoutError_` after ``timeout`` simulated seconds. The
    timeout timer is *cancelled the moment the future resolves* — the
    common fast path — so resolved RPCs leave no dead heap entry parked
    until their deadline."""
    loop = fut.loop
    waiter = Future(loop)

    def _on_done(f: Future) -> None:
        if not waiter._done:
            timer.cancel()
            if f._exc is not None:
                waiter.set_exception(f._exc)
            else:
                waiter.set_result(f._result)

    def _on_timeout() -> None:
        if not waiter._done:
            waiter.set_exception(TimeoutError_(f"timed out after {timeout}s"))

    fut.add_done_callback(_on_done)
    timer = loop.call_later_cancelable(timeout, _on_timeout)
    return waiter


async def gather(futs: Iterable[Future]) -> list:
    return [await f for f in futs]


class Event:
    """An asyncio.Event lookalike over simulated time."""

    __slots__ = ("loop", "_set", "_waiters")

    def __init__(self, loop: EventLoop) -> None:
        self.loop = loop
        self._set = False
        self._waiters: list[Future] = []

    def is_set(self) -> bool:
        return self._set

    def set(self) -> None:
        self._set = True
        ws, self._waiters = self._waiters, []
        for w in ws:
            if not w.done():
                w.set_result(None)

    def clear(self) -> None:
        self._set = False

    async def wait(self) -> None:
        if self._set:
            return
        f = Future(self.loop)
        self._waiters.append(f)
        await f


class Condition:
    """Broadcast wakeup: tasks await a predicate re-checked on notify."""

    __slots__ = ("loop", "_waiters")

    def __init__(self, loop: EventLoop) -> None:
        self.loop = loop
        # (future, timeout Timer or None) pairs; the timer is cancelled on
        # notify so an idle leader's heartbeat parks don't pile dead
        # entries onto the heap
        self._waiters: list[tuple[Future, Optional[Timer]]] = []

    def notify_all(self) -> None:
        ws, self._waiters = self._waiters, []
        for w, timer in ws:
            if timer is not None:
                timer.cancel()
            if not w.done():
                w.set_result(None)

    async def wait(self, timeout: Optional[float] = None) -> None:
        """Wait for the next notify_all; with ``timeout``, give up after that
        much simulated time. The condition owns the timeout path so that a
        timed-out waiter is removed from the waiter list immediately — an
        idle leader parks here on every heartbeat tick, and leaving resolved
        futures behind until the next notify_all would grow the list without
        bound."""
        f = Future(self.loop)
        if timeout is None:
            self._waiters.append((f, None))
        else:
            def _expire() -> None:
                if not f.done():
                    try:
                        self._waiters.remove(entry)
                    except ValueError:
                        pass
                    f.set_result(None)
            entry = (f, self.loop.call_later_cancelable(timeout, _expire))
            self._waiters.append(entry)
        await f

    async def wait_until(self, predicate: Callable[[], bool]) -> None:
        while not predicate():
            await self.wait()
