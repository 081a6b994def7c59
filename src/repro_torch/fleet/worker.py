"""The training-worker actor: an async task on the *simulated* event
loop, sharing it with the Raft replica set it coordinates through.

Each worker models one data-parallel trainer (parameter-server style —
workers step at their own pace; there is no lockstep barrier):

* register + heartbeat through :class:`~repro.coord.registry.AsyncClusterRegistry`;
* restore from the latest **valid** checkpoint manifest before training
  (boot, rejoin after a crash, and chief takeover all restore — these
  reads are the lineage-critical ones the checker audits);
* every step: launch a non-blocking poll of the fleet log via the
  configured read policy (training never blocks on the control plane —
  the paper's point is that under LeaseGuard this per-step poll is free,
  while under quorum reads it is a cluster-wide message storm), train
  for ``step_time`` (jittered, times any straggler slowdown), report
  step times on a cadence;
* watch the chief: the lowest-indexed live worker claims chiefdom for
  ``epoch+1`` when the claimed chief falls out of the membership TTL.
  A claim is an ordinary fleet-log append; the claimant then *reads
  back* — the read both confirms the claim won (last claim is ours) and
  doubles as the takeover restore. The chief commits a manifest every
  ``ckpt_every`` of its own steps.

Crash/restart is modelled by a generation counter: data-plane faults
flip ``alive`` and bump ``generation``; in-flight tasks notice at their
next await and die. Restart spawns fresh tasks with the next generation
— and, like a real trainer losing local state, the worker re-registers
and restores from the registry before training again.
"""

from __future__ import annotations

from typing import Optional

from ..coord.kvstore import CoordClient
from ..coord.registry import AsyncClusterRegistry
from .lineage import FLEET_KEY, LogView


class Worker:
    def __init__(self, fleet, index: int, prng, client: CoordClient) -> None:
        self.fleet = fleet
        self.index = index
        self.wid = f"w{index}"
        self.prng = prng
        self.client = client
        self.registry = AsyncClusterRegistry(client)
        self.alive = False
        self.generation = 0
        self.slowdown = 1.0                 # straggler faults scale this
        self.local_step = 0
        self.observed_step = -1             # newest valid step this worker saw
        self.is_chief = False
        self.epoch = 0
        self.view = LogView()
        self._last_committed_step = -1
        self._last_hb = float("-inf")
        self._poll_inflight = False
        # counters
        self.steps = 0
        self.polls_ok = 0
        self.polls_failed = 0
        self.stale_polls = 0
        self.commits_ok = 0
        self.commits_failed = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.generation += 1
        self.alive = True
        self.slowdown = 1.0
        self.local_step = 0
        self.observed_step = -1
        self.is_chief = False
        self.view = LogView()
        self._last_committed_step = -1
        self._last_hb = float("-inf")
        self._poll_inflight = False
        gen = self.generation
        loop = self.fleet.loop
        loop.create_task(self._run(gen))
        loop.create_task(self._chief_watch(gen))

    def crash(self) -> None:
        self.alive = False
        self.is_chief = False
        self.generation += 1                # kills in-flight tasks

    def _ok(self, gen: int) -> bool:
        return self.alive and self.generation == gen

    @property
    def loop(self):
        return self.fleet.loop

    @property
    def p(self):
        return self.fleet.p

    # -- main loop ---------------------------------------------------------
    async def _run(self, gen: int) -> None:
        p = self.p
        kind = "boot" if self.loop.now <= self.fleet.t0 + 1e-9 else "rejoin"
        while self._ok(gen) and self.fleet.running:
            if await self.registry.register_worker(self.wid):
                break
            await self.loop.sleep(p.retry_delay)
        # a worker cannot train before it has a checkpoint to train from
        while self._ok(gen) and self.fleet.running:
            if await self._restore(gen, kind):
                break
            await self.loop.sleep(p.retry_delay)
        while self._ok(gen) and self.fleet.running:
            now = self.loop.now
            if now - self._last_hb >= p.heartbeat_period:
                self._last_hb = now
                self.loop.create_task(self._heartbeat(gen))
            if not self._poll_inflight:
                self._poll_inflight = True
                self.loop.create_task(self._poll(gen))
            dt = (p.step_time * (1.0 + p.step_jitter * self.prng.random())
                  * self.slowdown)
            await self.loop.sleep(dt)
            if not self._ok(gen):
                break
            self.local_step += 1
            self.steps += 1
            self.fleet.total_steps += 1
            if self.steps % p.report_every == 0:
                self.loop.create_task(self._report(gen, dt))
            if (self.is_chief and self.local_step - self._last_committed_step
                    >= self.fleet.ckpt_every()):
                await self._commit(gen)

    async def _heartbeat(self, gen: int) -> None:
        if self._ok(gen):
            await self.registry.heartbeat(self.wid)

    async def _report(self, gen: int, dt: float) -> None:
        if self._ok(gen):
            await self.registry.report_step_time(self.wid, self.local_step, dt)

    # -- reads -------------------------------------------------------------
    async def _restore(self, gen: int, kind: str) -> bool:
        t_start = self.loop.now
        res = await self.client.read_raw(FLEET_KEY, timeout=self.p.op_timeout)
        if not self._ok(gen) or not res.ok:
            return False
        view = LogView().feed_raw(res.value)    # exactly what THIS read saw
        man = view.latest
        self.fleet.record_restore(self.wid, kind, t_start, self.loop.now,
                                  man, gen)
        self.view = view
        self.local_step = man["step"] if man else 0
        self.observed_step = man["step"] if man else -1
        return True

    async def _poll(self, gen: int) -> None:
        """Per-step checkpoint poll — fire-and-forget so training never
        blocks on the control plane; at most one in flight per worker."""
        try:
            res = await self.client.read_raw(FLEET_KEY,
                                             timeout=self.p.poll_timeout)
            if not self._ok(gen):
                return
            if not res.ok:
                self.polls_failed += 1
                return
            self.polls_ok += 1
            if len(res.value) < self.view.n:
                self.stale_polls += 1       # saw less than we already did
                return
            self.view.feed_raw(res.value)
            man = self.view.latest
            if man is not None and man["step"] > self.observed_step:
                self.observed_step = man["step"]
        finally:
            self._poll_inflight = False

    # -- chief election & checkpointing ------------------------------------
    async def _chief_watch(self, gen: int) -> None:
        p = self.p
        # deterministic stagger: workers don't all probe at once
        await self.loop.sleep(0.5 * p.chief_check_period
                              + 0.03 * (self.index + 1))
        while self._ok(gen) and self.fleet.running:
            await self._chief_tick(gen)
            if not self._ok(gen):
                return
            await self.loop.sleep(p.chief_check_period)

    async def _chief_tick(self, gen: int) -> None:
        p = self.p
        res = await self.client.read_raw(FLEET_KEY, timeout=p.op_timeout)
        if not self._ok(gen) or not res.ok:
            return
        if len(res.value) < self.view.n:
            # a stale view — under the inconsistent policy we knowingly
            # act on it anyway; that is the hazard the positive control
            # exists to expose
            self.stale_polls += 1
            view = LogView().feed_raw(res.value)
        else:
            view = self.view.feed_raw(res.value)
        claim = view.last_claim
        if self.is_chief and (claim is None or claim["chief"] != self.wid
                              or claim["epoch"] != self.epoch):
            self.is_chief = False           # deposed by a newer claim
            tr = self.loop.tracer
            if tr is not None:
                tr.emit("fleet", op="deposed", wid=self.wid)
            self.fleet.note(f"chief {self.wid} deposed")
        if claim is not None and claim["chief"] == self.wid:
            if not self.is_chief:
                # the log still names us (e.g. we crashed and rejoined):
                # resume chiefdom, but only through a fresh takeover read
                await self._become_chief(gen, claim["epoch"])
            return
        live = await self.registry.live_workers(ttl=p.worker_ttl)
        if not self._ok(gen) or live is None:
            return
        chief_live = claim is not None and claim["chief"] in live
        if chief_live or not live:
            return
        cand = min(live, key=self.fleet.worker_order)
        if cand != self.wid:
            return
        epoch = (claim["epoch"] if claim is not None else 0) + 1
        await self.client.append(
            FLEET_KEY, {"kind": "claim", "epoch": epoch, "chief": self.wid,
                        "t": self.loop.now}, timeout=p.op_timeout)
        if not self._ok(gen):
            return
        # the read-back decides, whatever the append reported (an
        # ambiguous append may well have committed)
        await self._become_chief(gen, epoch)

    async def _become_chief(self, gen: int, epoch: int) -> None:
        """Confirm the last claim is ours AND restore from the same read
        — skipping this takeover restore is exactly how a resuming chief
        would fork the lineage."""
        t_start = self.loop.now
        res = await self.client.read_raw(FLEET_KEY, timeout=self.p.op_timeout)
        if not self._ok(gen) or not res.ok:
            return
        view = LogView().feed_raw(res.value)
        claim = view.last_claim
        if claim is None or claim["chief"] != self.wid \
                or claim["epoch"] != epoch:
            return                          # somebody else won the claim
        man = view.latest
        self.fleet.record_restore(self.wid, "takeover", t_start,
                                  self.loop.now, man, gen)
        step = man["step"] if man else -1
        self.local_step = max(self.local_step, step if step >= 0 else 0)
        self.observed_step = max(self.observed_step, step)
        self._last_committed_step = step
        self.epoch = epoch
        self.is_chief = True
        tr = self.loop.tracer
        if tr is not None:
            tr.emit("fleet", op="claim", wid=self.wid, epoch=epoch)
        self.fleet.note(f"chief {self.wid} claims epoch {epoch}")

    async def _commit(self, gen: int) -> None:
        step = self.local_step
        man = {"kind": "manifest", "epoch": self.epoch, "chief": self.wid,
               "step": step,
               "parent": max(self._last_committed_step, self.observed_step),
               "id": f"{self.wid}:{self.epoch}:{step}", "t": self.loop.now}
        res = await self.client.append(FLEET_KEY, man,
                                       timeout=self.p.op_timeout)
        if not self._ok(gen):
            return
        if res.ok:
            self.commits_ok += 1
            self._last_committed_step = step
            if step > self.observed_step:
                self.observed_step = step
            self.fleet.record_commit(self.loop.now, step, True)
        else:
            # ambiguous or failed: never retry the same id blindly — the
            # next poll / chief tick reveals whether it landed, and the
            # next manifest supersedes it either way
            self.commits_failed += 1
            self.fleet.record_commit(self.loop.now, step, False)
