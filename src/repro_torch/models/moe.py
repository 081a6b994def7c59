"""Mixture-of-Experts layer, ported from ``repro.models.moe``: fp32 top-k
routing, the Switch auxiliary loss, capacity-based dispatch into an
``(E, C, d)`` buffer, the experts' SwiGLU batched over experts, the gated
combine, and arctic's parallel dense residual.

Two dispatch layouts, which ``sharding.ctx.moe_groups()`` selects as in
JAX: the flat one (one capacity pool over all T tokens), and with G > 1
groups dividing T the group-local one: the tokens split into G contiguous
slices, each with a private capacity slice of ``max(1, int(cf * (T / G) *
k / E))`` rows of every expert, ranked within its group, so the dispatch
and the combine touch only the group's own rows. One body
(``_dispatch``, ``_experts``, ``_combine``) computes both, the flat one as
a single group, on plain tensors and, under ``local_map``, on DTensors. At
a drop-free capacity both layouts compute the same function; at cf 1.25
they drop different rows. The ``constrain`` calls on the expert buffers
stand where JAX's do.

The reference computes capacity from the call's own token count, so a
decode step of B tokens gets ``max(1, int(cf * B * k / E))`` slots per
expert (1 for moonshot at B = 4), and a row past it is dropped. The port
copies that (ROADMAP.md queue 3, j). Every expert's buffer goes through
its weights whatever it holds, so a call reads all E experts' weights, as
the reference's einsums do. No TPU kernel is involved: the JAX package
leaves the expert products to XLA, and here they are ``torch.bmm``.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import ctx
from ..sharding.ctx import constrain, moe_groups, sharded
from ..sharding.rules import to_placements
from .layers import dense_init


def _expert_init(gen: torch.Generator, shape: tuple,
                 dtype: torch.dtype) -> torch.Tensor:
    """A stacked ``(L, E, d_in, d_out)`` expert weight, drawn one expert at
    a time: a whole fp32 draw would need 35 GB beside moonshot's bf16
    result, and one layer's 18 GB beside arctic's. JAX's ``dense_init``
    takes the fan-in from the first axis of each layer's ``(E, d_in,
    d_out)`` leaf, which is E."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        for j in range(shape[1]):
            out[i, j] = dense_init(gen, shape[2:], dtype, fan_in=shape[1])
    return out


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype
             ) -> dict:
    """Layer-stacked MoE parameters in the JAX tree's layout; the router is
    fp32, as JAX keeps routing in fp32."""
    L, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (L, d, e), torch.float32),
        "w_gate": _expert_init(gen, (L, e, d, f), dtype),
        "w_up": _expert_init(gen, (L, e, d, f), dtype),
        "w_down": _expert_init(gen, (L, e, f, d), dtype),
    }
    if cfg.moe_dense_residual:
        p["dense"] = {"w_gate": dense_init(gen, (L, d, f), dtype),
                      "w_up": dense_init(gen, (L, d, f), dtype),
                      "w_down": dense_init(gen, (L, f, d), dtype)}
    return p


def route(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """(gates (T, k) renormalised, expert ids (T, k), router probabilities
    (T, E)): fp32 logits, softmax and top-k, as JAX's ``lax.top_k``."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return gates / gates.sum(dim=-1, keepdim=True), idx, probs


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) tokens (the caller flattens batch x seq). Returns (out,
    aux): out (T, d) in x's dtype, aux the fp32 Switch load-balancing loss.
    The flat dispatch is the group-local one with one group."""
    t = x.shape[0]
    groups = moe_groups()
    groups = groups if groups > 1 and t % groups == 0 else 1
    if sharded(x):
        return _apply_moe_sharded(p, x, cfg, groups)
    return _apply_moe_grouped(p, x, cfg, groups)


def _capacity(cfg: ArchConfig, t: int, groups: int) -> int:
    """Each expert's rows in a group: ``max(1, int(cf * (T / G) * k / E))``
    of the call's T tokens."""
    return max(1, int(cfg.capacity_factor * (t // groups)
                      * cfg.experts_per_token / cfg.n_experts))


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
              groups: int, capacity: int, offsets=None) -> tuple:
    """Route x's (T, d) tokens and scatter them into a (G, E, capacity, d)
    buffer, group g taking the g-th contiguous slice of tokens. Every step
    runs on the device without a host sync: ranks by a scan of one-hots in
    token-major order within the group, the scatter by ``index_put_`` with
    accumulation (a dropped row is zeroed first and lands on its expert's
    last slot, adding 0). ``offsets``, given each expert's picks here (E,),
    returns the picks of the tokens before these (the ranks before this
    one in a sharded flat dispatch). Returns (buffer, gates, expert ids,
    slots, kept, the router probabilities' and the first picks' sums over
    the tokens (E,)); ids, slots and kept are (G, T/G * k)."""
    e, k, d = cfg.n_experts, cfg.experts_per_token, x.shape[1]
    gates, idx, probs = route({"router": router}, x, cfg)
    flat_e = idx.reshape(groups, -1)                           # (G, Tg*k)
    # rank of each (token, choice) among the earlier ones of its expert:
    # a scan along the contiguous axis of the (G, E, Tg*k) one-hot
    # (PyTorch's scan along the other axis of (T*k, E) took 2.3 ms a call
    # at moonshot's 2048-token prefill on an H100)
    onehot = F.one_hot(flat_e, e).transpose(1, 2).contiguous()
    pos = onehot.cumsum(dim=2).gather(1, flat_e[:, None])[:, 0] - 1
    if offsets is not None:
        pos = pos + offsets(onehot[0].sum(dim=1))[flat_e]
    valid = (pos < capacity).to(x.dtype)[..., None]            # (G, Tg*k, 1)
    pos = pos.clamp(0, capacity - 1)
    x_rep = x.repeat_interleave(k, dim=0).view(groups, -1, d) * valid
    # one index over (group, expert): a third index costs ``index_put_``
    # its own bounds checks and offsets
    slot = flat_e if groups == 1 else flat_e + e * torch.arange(
        groups, device=x.device)[:, None]
    buf = x.new_zeros((groups * e, capacity, d))
    buf.index_put_((slot, pos), x_rep, accumulate=True)
    first = F.one_hot(idx[:, 0], e).to(torch.float32).sum(dim=0)
    return (buf.view(groups, e, capacity, d), gates, flat_e, pos, valid,
            probs.sum(dim=0), first)


def _combine(out_buf: torch.Tensor, flat_e: torch.Tensor, pos: torch.Tensor,
             gates: torch.Tensor, valid: torch.Tensor, k: int,
             first_e: int | None = None) -> torch.Tensor:
    """The experts' output rows of each token, gated and summed: (T, d).
    With ``first_e``, ``out_buf`` (G, E_l, C, d) holds only experts
    ``first_e`` on, and a row of another expert adds 0 (under a mesh the
    rank holding it adds it)."""
    local_e, d = out_buf.shape[1], out_buf.shape[-1]
    weight = gates.reshape(valid.shape).to(valid.dtype) * valid
    if first_e is not None:
        flat_e = flat_e - first_e
        weight = weight * ((flat_e >= 0) & (flat_e < local_e)).to(
            weight.dtype)[..., None]
        flat_e = flat_e.clamp(0, local_e - 1)
    if out_buf.shape[0] == 1:       # two indices, as in the dispatch
        rows = out_buf.squeeze(0)[flat_e, pos]
    else:
        gidx = torch.arange(out_buf.shape[0], device=pos.device)[:, None]
        rows = out_buf[gidx, flat_e, pos]
    return (rows * weight).view(-1, k, d).sum(dim=1)


def _aux_loss(prob_sum: torch.Tensor, first: torch.Tensor, t: int,
              e: int) -> torch.Tensor:
    """Switch auxiliary loss: E x sum over experts of the mean router
    probability x the share of first picks, from their sums over T."""
    return e * ((prob_sum / t) * (first / t)).sum()


def _experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on the (G, E, C, d) buffer, experts on ``model``
    and groups on the dp axes, constrained where JAX constrains them: one
    group (the flat dispatch) as (E, C, d) ``torch.bmm``s, more as JAX's
    4-D einsums on its (E, G, C, d) transpose."""
    if buf.shape[0] == 1:
        # squeeze, not buf[0]: a select's backward writes a zeroed copy of
        # the whole buffer
        layout = ("tp", None, None)
        buf = constrain(buf.squeeze(0), *layout)
        g = constrain(torch.bmm(buf, p["w_gate"]), *layout)
        u = constrain(torch.bmm(buf, p["w_up"]), *layout)
        return constrain(torch.bmm(F.silu(g) * u, p["w_down"]),
                         *layout).unsqueeze(0)
    layout = ("tp", "dp", None, None)
    buf = constrain(buf.transpose(0, 1), *layout)
    g = constrain(torch.einsum("egcd,edf->egcf", buf, p["w_gate"]), *layout)
    u = constrain(torch.einsum("egcd,edf->egcf", buf, p["w_up"]), *layout)
    return constrain(torch.einsum("egcf,efd->egcd", F.silu(g) * u,
                                  p["w_down"]), *layout).transpose(0, 1)


def _dense_residual(p: dict, x: torch.Tensor) -> torch.Tensor:
    dp = p["dense"]
    g = constrain(x @ dp["w_gate"], "dp", "tp")
    u = constrain(x @ dp["w_up"], "dp", "tp")
    return constrain((F.silu(g) * u) @ dp["w_down"], "dp", None)


def _apply_moe_grouped(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch on plain tensors: the T tokens split into ``groups``
    contiguous slices aligned with the data sharding, each with a private
    per-expert capacity slice ranked within the group, so the scatter and
    the combine gather touch only the group's own rows (one group: the
    flat dispatch). Without the dense residual."""
    t = x.shape[0]
    buf, gates, flat_e, pos, valid, prob_sum, first = _dispatch(
        x, p["router"], cfg, groups, _capacity(cfg, t, groups))
    out = _combine(_experts(p, buf), flat_e, pos, gates, valid,
                   cfg.experts_per_token)
    if cfg.moe_dense_residual:
        out = out + _dense_residual(p, x)
    return out, _aux_loss(prob_sum, first, t, cfg.n_experts)


# ============================================================ under a mesh
def _rank_offsets(counts: torch.Tensor, mesh, rank: int) -> torch.Tensor:
    """Each expert's picks on the dp ranks before ``rank``, from every
    rank's ``counts`` (E,): one (dp, E) all-gather of integers. The flat
    dispatch ranks over the global token order, which runs through the
    ranks' row blocks in turn."""
    from torch.distributed.tensor import DTensor
    every = DTensor.from_local(counts[None], mesh, to_placements(
        ctx.spec_of(1, ("dp",)), mesh), run_check=False).full_tensor()
    return every[:rank].sum(dim=0)


def _apply_moe_sharded(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_apply_moe_grouped`` with the tokens of DTensor ``x`` (T, d) on
    the dp axes, the same function as unsharded: capacity from the global
    T, and the flat dispatch's ranks over the global token order (each
    rank adds its experts' picks on the ranks before it). ``index_put_``,
    ``cumsum`` and ``one_hot`` have no DTensor rule on every torch version,
    so ``_dispatch`` runs on each rank's tokens (``local_map``): the flat
    dispatch's rows land in a partial (1, E, C, d) buffer that a sum over
    the dp ranks completes, the group-local one's in its own groups of
    (G, E, cap_g, d). The experts' products run on DTensors, experts on
    ``model``; ``_combine`` then gathers each rank's rows from its local
    experts, summed over ``model``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    t = x.shape[0]
    split = ctx.fitted_spec(x.shape, ("dp",), mesh)[0] is not None
    rank, ranks = ctx.dp_index(mesh) if split else (0, 1)
    if groups > 1 and groups % ranks:
        raise ValueError(f"{groups} dispatch groups do not divide over "
                         f"{ranks} data-parallel ranks")
    whole = [Replicate()] * mesh.ndim

    def placed(*roles):
        return to_placements(ctx.spec_of(len(roles), roles) if split
                             else (None,) * len(roles), mesh)

    summed = ctx.summed_over(whole, mesh, "dp") if split else whole
    offsets = (lambda counts: _rank_offsets(counts, mesh, rank)) \
        if groups == 1 and split else None
    dispatch = partial(_dispatch, cfg=cfg, groups=max(1, groups // ranks),
                       capacity=_capacity(cfg, t, groups), offsets=offsets)
    rows = placed("dp", None)
    buf, gates, flat_e, pos, valid, prob_sum, first = local_map(
        dispatch, out_placements=(
            summed if groups == 1 else placed("dp", None, None, None),
            rows, rows, rows, placed("dp", None, None), summed, summed),
        in_placements=(rows, whole), in_grad_placements=(rows, summed),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])
    prob_sum, first = (v.redistribute(mesh, whole) for v in (prob_sum, first))
    aux = _aux_loss(prob_sum, first, t, cfg.n_experts)

    if groups == 1:
        # the sum over dp completes the flat buffer, experts then on model
        buf = buf.redistribute(mesh, to_placements(ctx.fitted_spec(
            buf.shape, (None, "tp", None, None), mesh), mesh))
    out_buf = _experts(p, buf)
    spec = ctx.fitted_spec(out_buf.shape, ("dp" if groups > 1 else None,
                                           "tp", None, None), mesh)
    experts = to_placements(spec, mesh)
    on_model = spec[1]          # the experts' mesh dim, or None

    def combine(out_buf, flat_e, pos, gates, valid):
        # the rows whose experts this rank holds; the others come from the
        # ranks that hold theirs, in the sum over ``model``
        first_e = mesh.get_coordinate()[mesh.mesh_dim_names.index(
            on_model)] * out_buf.shape[1] if on_model else None
        return _combine(out_buf, flat_e, pos, gates, valid,
                        cfg.experts_per_token, first_e)

    out_rows = ctx.summed_over(rows, mesh, "tp") if on_model else rows
    ins = (experts, rows, rows, rows, placed("dp", None, None))
    # gradients: each dp rank's rows give its share of the flat buffer's,
    # and each model rank's experts their share of the gates'
    buf_grad = ctx.summed_over(experts, mesh, "dp") if split and groups == 1 \
        else experts
    out = local_map(combine, out_placements=list(out_rows),
                    in_placements=ins,
                    in_grad_placements=(buf_grad, rows, rows, out_rows,
                                        ins[4]),
                    device_mesh=mesh, redistribute_inputs=True)(
        out_buf, flat_e, pos, gates, valid)
    out = out.redistribute(mesh, placed("dp", None))
    if cfg.moe_dense_residual:
        out = out + _dense_residual(p, x)
    return out, aux
