"""Activation-sharding context, ported from ``repro.sharding.ctx``: lets
model code place logical constraints (batch -> dp, feature -> tp, and
sequence -> tp under sequence parallelism) without knowing the mesh.

JAX's ``with_sharding_constraint`` becomes ``DTensor.redistribute``: a
constraint on a DTensor moves it to the roles' placements; on a plain
tensor, or with no axes set, it returns its input, so single-device runs
and the CPU tests are unaffected. The mesh is the DTensor's own (JAX reads
it from the ambient ``with mesh:``). The context is process-global, set by
whoever builds the mesh before the model runs.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from .rules import to_placements

_DP: Optional[Union[str, tuple]] = None
_TP: Optional[str] = None
_SP: bool = False    # Megatron-style sequence parallelism: the residual
#                      stream sharded over 'model' on the seq dim between
#                      blocks
_MOE_GROUPS: int = 1


def set_axes(dp, tp, sp: bool = False) -> None:
    global _DP, _TP, _SP
    _DP, _TP, _SP = dp, tp, sp


def clear() -> None:
    set_axes(None, None, False)


def sp_enabled() -> bool:
    return _SP and _TP is not None


def set_moe_groups(n: int) -> None:
    """Number of dispatch groups for group-local MoE (usually the dp
    extent; 1 = flat dispatch)."""
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, n)


def moe_groups() -> int:
    return _MOE_GROUPS


def axes_from_mesh(mesh) -> tuple:
    """(dp, tp) of a ``DeviceMesh`` with ``mesh_dim_names``, as JAX's
    reads them from ``Mesh.axis_names``."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp = "model" if "model" in names else None
    return dp, tp


def spec_of(ndim: int, roles: tuple) -> tuple:
    """The per-dim spec of ``roles``: one of 'dp' | 'tp' | 'sp' | None per
    dim, trailing dims omitted."""
    spec = []
    for i in range(ndim):
        role = roles[i] if i < len(roles) else None
        if role == "dp":
            spec.append(_DP)
        elif role == "tp":
            spec.append(_TP)
        elif role == "sp":
            spec.append(_TP if _SP else None)
        else:
            spec.append(None)
    return tuple(spec)


def _extent(entry, mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    names = (entry,) if isinstance(entry, str) else (entry or ())
    return math.prod(sizes[n] for n in names)


def _divides(shape, spec, mesh) -> bool:
    return all(d % _extent(a, mesh) == 0 for d, a in zip(shape, spec))


def fitted_spec(shape, roles: tuple, mesh) -> tuple:
    """``roles``' spec for a tensor of ``shape``, each dim the mesh does
    not divide replicated (the rules' fallback)."""
    return tuple(a if d % _extent(a, mesh) == 0 else None
                 for d, a in zip(shape, spec_of(len(shape), roles)))


def sharded(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t``, which every rank computes whole (RoPE tables, positions), as
    a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor, so that
    it mixes with ``x``, forward and backward; else ``t`` (a DTensor
    ``t`` too)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _axes(role: str) -> tuple:
    """The mesh axes of a role ("dp" or "tp")."""
    names = spec_of(1, (role,))[0]
    return (names,) if isinstance(names, str) else (names or ())


def dp_index(mesh) -> tuple[int, int]:
    """(this rank's index among the data-parallel ranks, their number):
    the order in which ``Shard`` over the dp axes lays out row blocks,
    major to minor."""
    index, size = 0, 1
    for name, extent, coord in zip(mesh.mesh_dim_names, mesh.shape,
                                   mesh.get_coordinate()):
        if name in _axes("dp"):
            index, size = index * extent + coord, size * extent
    return index, size


def summed_over(placements: tuple, mesh, *roles: str) -> tuple:
    """``placements`` with the mesh dims of ``roles`` ("dp", "tp")
    ``Partial``: a value of which each of those ranks holds its share of a
    sum (the gradient of a weight from that rank's rows or heads)."""
    from torch.distributed.tensor import Partial
    names = {n for r in roles for n in _axes(r)}
    return tuple(Partial() if n in names else p
                 for n, p in zip(mesh.mesh_dim_names, placements))


def assign(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``, in place; a DTensor ``dst`` keeps its own
    placements: ``src`` is moved to them first and each rank copies its
    shard."""
    if not sharded(dst):
        return dst.copy_(src)
    src = replicated_like(src, dst).redistribute(dst.device_mesh,
                                                 dst.placements)
    dst.to_local().copy_(src.to_local())
    return dst


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` (a view). A DTensor sharded on ``dim``
    over mesh dims whose extent does not divide ``sizes[0]`` is gathered
    on them first: DTensor cannot cut an uneven shard (8 KV heads in a
    projection sharded 16 ways), so those heads stay whole on every rank,
    as ``constrain`` leaves a dim the mesh does not divide (ROADMAP queue
    3, m)."""
    if sharded(x):
        from torch.distributed.tensor import Replicate, Shard
        dim %= x.ndim
        mesh = x.device_mesh
        extent = math.prod(n for p, n in zip(x.placements, mesh.shape)
                           if p == Shard(dim))
        if sizes[0] % extent:
            x = x.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                      for p in x.placements])
    return x.unflatten(dim, sizes)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last two dims merged (a view), the inverse of
    ``unflatten``. Under autograd a DTensor's gradient comes back in the
    merged tensor's placements (``_GradTo``), so the view's backward, an
    unflatten, never meets a shard of the merged dim that the leading one
    does not divide (a gradient sharded 16 ways over 40 heads' 2560
    channels)."""
    out = x.flatten(-2)
    if sharded(out) and torch.is_grad_enabled() and out.requires_grad:
        out = _GradTo.apply(out, tuple(out.placements))
    return out


class _GradTo(torch.autograd.Function):
    """The identity, whose backward moves the gradient to ``placements``:
    the transpose of JAX's sharding constraint constrains the cotangent to
    the same sharding, where DTensor's ``redistribute`` hands the gradient
    back in the input's placements. Without it a gradient that a sharded
    product leaves ``Partial`` (a column-parallel input's) stays partial
    down the residual stream, and DTensor meets it at the next row-parallel
    product's backward by gathering the saved activation and computing the
    product whole on every rank."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if sharded(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def constrain(x: torch.Tensor, *roles: Optional[str]) -> torch.Tensor:
    """roles: one of 'dp' | 'tp' | 'sp' | None per dim (trailing dims may
    be omitted). A DTensor is redistributed to the roles' placements, and
    under autograd so is its gradient (``_GradTo``); a plain tensor, a run
    with no axes set, or a dim the mesh does not divide (JAX's ``except``)
    leaves ``x`` as it is."""
    if _DP is None and _TP is None:
        return x
    if not sharded(x):
        return x
    mesh = x.device_mesh
    spec = spec_of(x.ndim, roles)
    if not _divides(x.shape, spec, mesh):
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _GradTo.apply(x, placements)
    return x
