"""What the metric readers share: the traced slice's roofline shares by
operator, its kernel time by kind, and the window's rates."""

from __future__ import annotations

from . import bounds

# a dtype as the profiler names it -> its bytes
SIZES = (("BFloat16", 2), ("Half", 2), ("double", 8), ("float", 4),
         ("Float", 4), ("long", 8), ("int", 4), ("bool", 1))


def itemsize(dtype: str) -> int:
    return next((n for key, n in SIZES if key in dtype), 4)


def roofline(run: dict, ops: dict, call_bound):
    """The least time of the traced calls of ``ops`` ({operator: kind of
    call}) over the device time under them, in %; None where the trace
    holds no device time under them."""
    tr = run.get("trace")
    if tr is None:
        return None
    least, spent = 0.0, 0.0
    for name, kind in ops.items():
        op = tr.ops.get(name)
        if not op or op["device_s"] <= 0:
            continue
        spent += op["device_s"]
        for shapes, dtypes in op["calls_shapes"]:
            least += call_bound(kind, shapes, [itemsize(d) for d in dtypes])
    return 100 * least / spent if spent else None


def attention_roofline(run: dict, ops: dict):
    window = run["model"].sliding_window
    return roofline(run, ops, lambda kind, shapes, sizes:
                    bounds.attention_call_bound(kind, shapes, sizes, window))


def scan_roofline(run: dict, ops: dict):
    return roofline(run, ops, bounds.scan_call_bound)


def kind_ms_per_unit(run: dict, kinds: tuple):
    """Device ms a step or batch in kernels of ``kinds``."""
    tr = run.get("trace")
    if tr is None or not tr.kernel_s or not tr.units:
        return None
    s = sum(t for name, t in tr.kernel_s.items()
            if bounds.kind_of(name) in kinds)
    return 1e3 * s / tr.units


def idle_share(run: dict):
    tr = run.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100 * (1 - tr.busy_s / tr.window_s)


def is_kind(run: dict, kind: str) -> bool:
    return run.get("kind") == kind
