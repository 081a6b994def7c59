"""The traced slice: ``torch.profiler`` over a few steady steps or batches
after the measured window, reduced to what the per-layer readers read.

``capture`` runs ``fn`` under the profiler inside a ``cardbench.traced``
range and returns a ``Trace``:

  window_s         the slice's length on the host's clock
  busy_s           the union of every device interval (kernels, copies,
                   sets) inside it: overlap counts once
  kernels          device kernels launched (copies and sets not counted)
  kernel_s         {kernel name: device seconds}
  ops              {operator name: {"calls", "device_s", "calls_shapes"}}
                   for every ``repro_torch::`` operator: the device time
                   of the kernels launched inside each call, read through
                   the profiler's correlation of a launch with the
                   operator that made it; calls_shapes holds each call's
                   (input shapes, input dtypes)
  gaps             the longest idle stretches of the device, each named by
                   what the host was doing at its start: the harness's
                   innermost ``cardbench.*`` range and the innermost
                   operator under it
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

OP_PREFIX = "repro_torch::"
RANGE_PREFIX = "cardbench."
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    kernel_s: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)
    units: int = 0          # steps or batches inside the slice

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}


def capture(fn, units: int, device) -> Trace:
    """Profile ``fn()`` (which runs ``units`` steps or batches) twice and
    reduce it. On the card the first pass records the device's activity
    alone, which costs the host little, for ``busy_s`` and ``window_s``
    (the host's clock around ``fn`` and a synchronisation); the second
    records the host's operators and ranges with their shapes too, which
    slows a host-paced step, for everything else. On the CPU only the
    second runs, and the trace holds no device interval."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .drivers import sync
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(device)
            window = time.perf_counter() - t0
        spans = _union([(e.start_ns(), e.end_ns()) for e in
                        prof.profiler.kineto_results.events()
                        if _is_device(e)])
        busy = sum(e - s for s, e in spans) / 1e9
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(RANGE_PREFIX + "traced"):
            fn()
            sync(device)
    tr = reduce(prof.profiler.kineto_results.events())
    if cuda:
        tr.busy_s, tr.window_s = busy, window
    tr.units = units
    return tr


def _is_device(e) -> bool:
    """A device activity: a kernel, copy or set; not the device-side
    image of a host range (the profiler's GPU user annotations)."""
    return e.device_type() != torch.autograd.DeviceType.CPU \
        and not e.is_user_annotation() \
        and "annotation" not in str(getattr(e, "activity_type",
                                            lambda: "")()) \
        and not e.name().startswith(RANGE_PREFIX)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> Trace:
    cpu = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU]
    dev = [e for e in events if _is_device(e)]
    traced = [e for e in cpu if e.name() == RANGE_PREFIX + "traced"]
    if not traced:
        raise RuntimeError("the profiler recorded no cardbench.traced range")
    t0, t1 = traced[0].start_ns(), traced[0].end_ns()
    main = traced[0].start_thread_id()
    inside = [e for e in dev if e.start_ns() < t1 and e.end_ns() > t0]
    segments = _union([(max(t0, e.start_ns()), min(t1, e.end_ns()))
                       for e in inside])
    busy = sum(e - s for s, e in segments)
    kernels = [e for e in inside
               if not e.name().startswith(("Memcpy", "Memset"))]
    kernel_s: dict = {}
    for e in kernels:
        kernel_s[e.name()] = kernel_s.get(e.name(), 0.0) \
            + e.duration_ns() / 1e9
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                 kernels=len(kernels), kernel_s=kernel_s,
                 ops=_ops(cpu, kernels), gaps=_gaps(cpu, main, segments,
                                                    t0, t1))


def _ops(cpu: list, kernels: list) -> dict:
    """Each ``repro_torch::`` operator's calls and the device time of the
    kernels launched inside them."""
    by_corr = {e.correlation_id(): e for e in cpu}
    calls: dict = {}            # thread -> sorted [(start, end, name)]
    ops: dict = {}
    for e in cpu:
        if e.name().startswith(OP_PREFIX):
            calls.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns(), e.name()))
            op = ops.setdefault(e.name(), {"calls": 0, "device_s": 0.0,
                                           "calls_shapes": []})
            op["calls"] += 1
            op["calls_shapes"].append((e.shapes(), e.dtypes()))
    for spans in calls.values():
        spans.sort()
    starts = {t: [s for s, _, _ in spans] for t, spans in calls.items()}
    for k in kernels:
        launcher = by_corr.get(k.linked_correlation_id())
        if launcher is None:
            continue
        name = launcher.name()
        if not name.startswith(OP_PREFIX):
            spans = calls.get(launcher.start_thread_id(), [])
            i = bisect.bisect_right(
                starts.get(launcher.start_thread_id(), []),
                launcher.start_ns()) - 1
            if i < 0 or spans[i][1] < launcher.end_ns():
                continue
            name = spans[i][2]
        ops[name]["device_s"] += k.duration_ns() / 1e9
    return ops


def _innermost(spans: list, starts: list, t: int, prefix: str = ""):
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e > t and name.startswith(prefix):
            return name
        i -= 1
    return None


def _gaps(cpu: list, main: int, segments: list, t0: int, t1: int) -> list:
    """The TOP longest idle stretches inside [t0, t1], longest first."""
    edges = [t0] + [x for seg in segments for x in seg] + [t1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                   if e.start_thread_id() == main)
    starts = [s for s, _, _ in spans]
    out = []
    for length, at in idle:
        rng = _innermost(spans, starts, at, RANGE_PREFIX) or "outside"
        op = _innermost(spans, starts, at)
        name = rng if op in (None, rng) else f"{rng} > {op}"
        out.append([name, length / 1e9])
    return out
