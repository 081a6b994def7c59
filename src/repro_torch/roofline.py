"""Roofline analysis of one step of the port, counted as it runs on meta
tensors. Ported from ``repro.roofline``.

JAX's analysis reads the compiled HLO: XLA has fused the step into a few
hundred kernels, whose operands and results it sums, multiplying each
while body by its trip count. An eager PyTorch step has no compiled
program to read (``parse_hlo``, ``analyze_hlo``, ``collective_inventory``
and ``hbm_inventory`` have no counterpart). Here the step itself runs,
on meta tensors (meta DTensors on a fake mesh: ``launch/mesh.py``), which
allocate nothing, under ``RooflineCounter``, a dispatch mode that sees
every operation the port dispatches on each rank's local shards, the
kernels' operators and DTensor's collectives among them:

* FLOPs per device: each operation's own work on its local shards (a
  replicated operation counts whole on every rank), by torch's flop
  formulas for the matrix products (2·M·N·K) and the kernels' own
  formulas (``register_flop_formula`` beside each operator: the visible
  (query, key) pairs, the recurrences' fp32 flops). Elementwise flops are
  not counted, as in JAX's analysis;
* HBM bytes: operand bytes plus result bytes of every dispatched
  operation. Eager PyTorch fuses nothing, so every operation is a kernel
  that reads its operands from HBM and writes its results there. Views,
  metadata and allocation are skipped, as ``_SKIP_BYTES_OPS`` skips the
  HLO's; a gather counts the rows it reads, a scatter the slots it writes
  (JAX's dynamic-slice rule). A kernel operator counts its own operands
  and results;
* kernel-region bytes: what the plain body of each kernel (JAX's
  reference inside its ``vmemkernel_*`` scope) would move beyond the
  kernel's own reads and writes, from each operator's
  ``reference_bytes``; so ``memory_ref_s`` is the step with the plain
  bodies and ``memory_s`` the step with the kernels, as in JAX;
* link bytes: each ``_c10d_functional`` collective that DTensor's
  redistributions dispatch, by JAX's ring model
  (``collective_link_bytes``), by kind into ``collective_breakdown``.

The counter also keeps the flops by dtype and by region (the forward
kernels' operators by name, a custom autograd Function's backward by its
node's name, the backward kernels' operators there too, "dense" for the
rest), each kernel's calls and the local shapes of
its first call, and the peak of the storage allocated while it counts.

Terms (seconds, per device, from ``roofline_terms``):
    compute    = flops_per_dev / PEAK_FLOPS_BF16
    memory     = hbm_bytes_per_dev / HBM_BW
    collective = link_bytes_per_dev / NVLINK_BW
and from ``typed_terms``, which the card's check reads:
    compute_typed = sum over dtypes of flops / that dtype's peak
    bound_typed   = max(compute_typed, memory, collective)
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def collective_link_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-device link bytes of one collective whose result is ``nbytes``
    over ``group`` ranks: JAX's ring model (``_collective_link_bytes``)."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * nbytes
    if kind == "all-gather":
        return (g - 1) / g * nbytes            # result is the gathered full
    if kind == "reduce-scatter":
        return (g - 1) * nbytes                 # operand = result * g
    if kind == "all-to-all":
        return (g - 1) / g * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    return 0.0


@dataclass
class RooflineCounts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    kernel_region_bytes: float = 0.0   # traffic of the kernels' plain
    #   bodies beyond the kernels' own reads and writes: what the step
    #   would move with the references in place of the kernels; reported
    #   separately so both memory terms are visible.
    collective_breakdown: dict = field(default_factory=dict)
    n_collectives: int = 0

    def add(self, other: "RooflineCounts", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.link_bytes += other.link_bytes * mult
        self.kernel_region_bytes += other.kernel_region_bytes * mult
        self.n_collectives += int(other.n_collectives * mult)
        for k, v in other.collective_breakdown.items():
            self.collective_breakdown[k] = \
                self.collective_breakdown.get(k, 0.0) + v * mult


@dataclass
class Counted:
    """What a ``RooflineCounter`` counted between two ``take``s: the
    roofline counts, flops by dtype and by region, and each kernel's
    calls (and the local shapes of its first call)."""
    counts: RooflineCounts
    flops_by_dtype: dict
    flops_by_region: dict
    kernels: dict


def roofline_terms(counts: RooflineCounts, *, peak_flops: float,
                   hbm_bw: float, ici_bw: float) -> dict:
    """Two memory terms are reported:
    * ``memory_ref_s`` — the kernels' plain bodies (kernel-region traffic,
      e.g. attention scores, hits HBM);
    * ``memory_s`` — with the kernels (their insides stay on chip; their
      own operands and results are counted).
    The dominant term / bound use the kernel-adjusted value (the port
    ships the kernels). ``ici_bw`` keeps JAX's name; the port passes the
    card's link rate."""
    compute = counts.flops / peak_flops
    memory = counts.hbm_bytes / hbm_bw
    memory_ref = (counts.hbm_bytes + counts.kernel_region_bytes) / hbm_bw
    collective = counts.link_bytes / ici_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda t: t[1])[0]
    total = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "memory_ref_s": memory_ref,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": total,
    }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors in ``tree`` (nested lists, tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for t in tree:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple, dict)):
            out.extend(_tensors(t))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under the tensor leaves of ``tree``
    (a DTensor's local shard)."""
    seen = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _aten(*names: str) -> set:
    ops = torch.ops.aten
    return {getattr(ops, n) for n in names if hasattr(ops, n)}


# no data moved: metadata and allocation
_SKIP_BYTES = _aten("detach", "alias", "lift_fresh", "empty", "empty_like",
                    "empty_strided", "new_empty", "new_empty_strided",
                    "_unsafe_view", "set_", "resize_", "sym_size",
                    "sym_stride", "sym_numel")
# a gather reads the rows it takes; a scatter writes the slots it puts
_GATHERS = _aten("index", "embedding", "index_select", "gather")
_PUTS = _aten("index_put_", "index_put", "_index_put_impl_")
_SCATTERS = _PUTS | _aten("index_copy_", "index_copy", "scatter_", "scatter")
_ACCUMULATES = _aten("index_add_", "index_add", "scatter_add_",
                     "scatter_add", "scatter_reduce_", "scatter_reduce")
# matrix products: 2 flops a multiply-add of their last two operands
_DOTS = _aten("mm", "bmm", "addmm", "baddbmm")


def _kernel_ops() -> dict:
    """{operator packet: (name, reference_bytes, the dtype its flops run
    in, or None for its first input's, whether its flops go to the
    autograd node running it)} of the kernels: the Mamba scan's recurrence
    runs in fp32 whatever its inputs' dtype; a training forward
    (``flash_attention_train``, ``wkv6_train``, ``mamba_scan_train``)
    counts as its forward kernel; a backward kernel's flops go to
    its Function's backward (``FlashAttentionFnBackward``,
    ``Wkv6FnBackward``, ``MambaScanFnBackward``), where the bounds count
    them."""
    from .kernels import decode_attention, flash_attention, mamba_scan, wkv6
    ops = torch.ops.repro_torch
    return {ops.flash_attention:
            ("flash_attention", flash_attention.reference_bytes, None, False),
            ops.flash_attention_train:
            ("flash_attention", flash_attention.reference_bytes, None, False),
            ops.decode_attention:
            ("decode_attention", decode_attention.reference_bytes, None,
             False),
            ops.wkv6: ("wkv6", wkv6.reference_bytes, None, False),
            ops.wkv6_train:
            ("wkv6", wkv6.train_reference_bytes, None, False),
            ops.mamba_scan:
            ("mamba_scan", mamba_scan.reference_bytes, torch.float32, False),
            ops.mamba_scan_train:
            ("mamba_scan", mamba_scan.train_reference_bytes, torch.float32,
             False),
            ops.flash_attention_backward:
            ("flash_attention_backward",
             flash_attention.backward_reference_bytes, None, True),
            ops.wkv6_backward:
            ("wkv6_backward", wkv6.backward_reference_bytes, None, True),
            ops.mamba_scan_backward:
            ("mamba_scan_backward", mamba_scan.backward_reference_bytes,
             torch.float32, True)}


def _group_size(args: tuple) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _region() -> str:
    """The backward of a custom autograd Function running now (its node's
    name: autograd's own nodes end in a digit), else "dense"."""
    node = torch._C._current_autograd_node()
    name = "" if node is None else node.name()
    return name if name and not name[-1].isdigit() else "dense"


class RooflineCounter(TorchDispatchMode):
    """Counts the roofline of the operations run under it (see the module
    docstring), on local shards: an operation on DTensors is left to
    DTensor (``NotImplemented``), whose local operations and collectives
    come back through this mode; the operations DTensor's sharding
    propagation runs on fake tensors (its inputs' global stand-ins too)
    are not counted.

    ``resident(tree)`` marks the storages that exist before the step (its
    arguments); every other storage an operation creates is tracked until
    it is freed, and ``peak_bytes`` is the most of them alive at once.
    ``take()`` returns what was counted since the last ``take`` and starts
    again; the memory tracking runs on."""

    def __init__(self) -> None:
        super().__init__()
        self._kernels = _kernel_ops()
        self._resident: set = set()
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._reset()

    def _reset(self) -> None:
        self.counts = RooflineCounts()
        self.flops_by_dtype: dict = {}
        self.flops_by_region: dict = {}
        self.kernels: dict = {}

    def take(self) -> "Counted":
        """What was counted so far; the counter starts again."""
        snap = Counted(self.counts, self.flops_by_dtype,
                       self.flops_by_region, self.kernels)
        self._reset()
        return snap

    def resident(self, tree) -> int:
        """Mark the storages of ``tree``'s tensors as existing before the
        step; returns their bytes."""
        for t in _tensors(tree):
            self._resident.add(_local(t).untyped_storage()._cdata)
        return storage_bytes(tree)

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._resident:
                continue
            n = st.nbytes()
            self._live[key] = weakref.ref(
                st, lambda ref, k=key, n=n: self._free(k, n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            return out
        self._track(out)
        self._count(func, args, kwargs, out)
        return out

    def _add_flops(self, flops: float, dtype: torch.dtype,
                   region: str) -> None:
        if not flops:
            return
        c = self.counts
        c.flops += flops
        key = str(dtype).replace("torch.", "")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + flops
        self.flops_by_region[region] = \
            self.flops_by_region.get(region, 0) + flops

    def _count(self, func, args, kwargs, out) -> None:
        c = self.counts
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func.name()
        base = name.split("::")[-1].split(".")[0]
        if name.startswith("_c10d_functional"):
            if base in _COLLECTIVES:
                kind = _COLLECTIVES[base]
                lb = collective_link_bytes(kind, sum(map(_nbytes, outs)),
                                           _group_size(args))
                c.link_bytes += lb
                c.n_collectives += 1
                c.collective_breakdown[kind] = \
                    c.collective_breakdown.get(kind, 0.0) + lb
                c.hbm_bytes += sum(map(_nbytes, ins + outs))
            return
        if packet in self._kernels:
            kname, reference_bytes, dtype, in_node = self._kernels[packet]
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            region = _region() if in_node else kname
            self._add_flops(flops, dtype or ins[0].dtype,
                            kname if region == "dense" else region)
            boundary = sum(map(_nbytes, ins + outs))
            c.hbm_bytes += boundary
            c.kernel_region_bytes += max(
                0, reference_bytes(*args, **kwargs) - boundary)
            k = self.kernels.setdefault(kname, {"calls": 0, "shapes": [
                list(t.shape) for t in ins]})
            k["calls"] += 1
            return
        if packet in _DOTS:
            a = ins[-2]
            self._add_flops(2 * outs[0].numel() * a.shape[-1], a.dtype,
                            _region())
        elif packet in flop_registry:
            self._add_flops(flop_registry[packet](
                *args, **kwargs, out_val=out), ins[0].dtype, _region())
        if func.is_view or packet in _SKIP_BYTES:
            return
        if packet in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:] if not
                      t.is_floating_point())
            c.hbm_bytes += 2 * sum(map(_nbytes, outs)) + idx
        elif packet in _SCATTERS or packet in _ACCUMULATES:
            # the values put (index_put_'s third argument, else the last
            # tensor), written, and read first where they accumulate
            vals = _nbytes(args[2] if packet in _PUTS else ins[-1])
            idx = sum(_nbytes(t) for t in ins if not t.is_floating_point())
            accumulate = packet in _ACCUMULATES or (
                packet in _PUTS and len(args) > 3 and args[3]) \
                or kwargs.get("accumulate", False)
            c.hbm_bytes += (3 if accumulate else 2) * vals + idx
        else:
            c.hbm_bytes += sum(map(_nbytes, ins + outs))


def over_depth(one: Counted, two: Counted, depth: int) -> Counted:
    """The counts of a step of ``depth`` identical layers from ``take()``s
    of the step at one and at two layers: one + (depth - 1) (two - one),
    as JAX's analysis multiplies the layer scan's body by its trips."""
    def lin(a: dict, b: dict) -> dict:
        return {k: a.get(k, 0) + (depth - 1) * (b.get(k, 0) - a.get(k, 0))
                for k in {**a, **b}}
    counts = RooflineCounts()
    counts.add(one.counts)
    counts.add(two.counts, depth - 1)
    counts.add(one.counts, 1 - depth)
    return Counted(counts, lin(one.flops_by_dtype, two.flops_by_dtype),
                   lin(one.flops_by_region, two.flops_by_region),
                   {k: {"calls": v} for k, v in lin(
                       {k: v["calls"] for k, v in one.kernels.items()},
                       {k: v["calls"] for k, v in two.kernels.items()}
                   ).items()})


def per_dtype_compute_s(flops_by_dtype: dict, peaks: dict) -> float:
    """Seconds of compute at each dtype's peak rate (``peaks``: dtype name
    -> flop/s; a dtype without one takes the fastest)."""
    fastest = max(peaks.values())
    return sum(f / peaks.get(d, fastest) for d, f in flops_by_dtype.items())


def typed_terms(terms: dict, flops_by_dtype: dict, peaks: dict) -> dict:
    """``roofline_terms``' ``terms`` (all flops at one peak, as JAX's) with
    ``compute_typed_s``: each dtype's flops at its own peak
    (``per_dtype_compute_s``), and ``bound_typed_s``: the larger of that,
    ``memory_s`` and ``collective_s``."""
    typed = per_dtype_compute_s(flops_by_dtype, peaks)
    return {**terms, "compute_typed_s": typed,
            "bound_typed_s": max(typed, terms["memory_s"],
                                 terms["collective_s"])}


