"""Mixture-of-Experts layer, ported from ``repro.models.moe``: fp32 top-k
routing, the Switch auxiliary loss, capacity-based dispatch into an
``(E, C, d)`` buffer, the experts' SwiGLU batched over experts, the gated
combine, and arctic's parallel dense residual.

Two dispatch layouts, which ``sharding.ctx.moe_groups()`` selects as in
JAX: the flat one (one capacity pool over all T tokens), and with G > 1
groups dividing T the group-local one (``_apply_moe_grouped``): the tokens
split into G contiguous slices, each with a private capacity slice of
``max(1, int(cf * (T / G) * k / E))`` rows of every expert, ranked within
its group, so the dispatch and the combine touch only the group's own rows.
At a drop-free capacity both compute the same function; at cf 1.25 they
drop different rows. The ``constrain`` calls stand where JAX's do.

The reference computes capacity from the call's own token count, so a
decode step of B tokens gets ``max(1, int(cf * B * k / E))`` slots per
expert (1 for moonshot at B = 4), and a row past it is dropped. The port
copies that (ROADMAP.md queue 3, j). Every expert's buffer goes through
its weights whatever it holds, so a call reads all E experts' weights, as
the reference's einsums do. No TPU kernel is involved: the JAX package
leaves the expert products to XLA, and here they are ``torch.bmm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding.ctx import constrain, moe_groups
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

    Every step runs on the device without a host sync: ranks by a scan of
    one-hots in token-major order, the scatter by ``index_put_`` with
    accumulation (a dropped row is zeroed first and lands on its expert's
    last slot, adding 0), the combine by a gather."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    groups = moe_groups()
    if groups > 1 and t % groups == 0:
        return _apply_moe_grouped(p, x, cfg, groups)
    gates, idx, probs = route(p, x, cfg)
    aux = _aux_loss(probs, idx, e)

    capacity = max(1, int(cfg.capacity_factor * t * k / e))
    flat_e = idx.reshape(-1)                                   # (T*k,)
    # rank of each (token, choice) among the earlier ones of its expert,
    # in token-major order: a scan of the (E, T*k) one-hot along its
    # contiguous axis (PyTorch's scan along the other axis of (T*k, E)
    # took 2.3 ms a call at moonshot's 2048-token prefill on an H100)
    onehot = F.one_hot(flat_e, e).T.contiguous()               # (E, T*k)
    pos = onehot.cumsum(dim=1).gather(0, flat_e[None])[0] - 1
    valid = (pos < capacity).to(x.dtype)[:, None]
    pos = pos.clamp(0, capacity - 1)
    x_rep = x.repeat_interleave(k, dim=0) * valid
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, pos), x_rep, accumulate=True)
    # expert dim on the model axis (EP)
    buf = constrain(buf, "tp", None, None)

    g = constrain(torch.bmm(buf, p["w_gate"]), "tp", None, None)
    u = constrain(torch.bmm(buf, p["w_up"]), "tp", None, None)
    out_buf = constrain(torch.bmm(F.silu(g) * u, p["w_down"]),
                        "tp", None, None)                     # (E, C, d)
    gathered = out_buf[flat_e, pos] * (
        gates.reshape(-1, 1).to(x.dtype) * valid)
    out = gathered.view(t, k, d).sum(dim=1)
    if cfg.moe_dense_residual:
        out = out + _dense_residual(p, x)
    return out, aux


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: int
              ) -> torch.Tensor:
    """Switch auxiliary loss: E x sum over experts of the mean router
    probability x the share of first picks."""
    first = F.one_hot(idx[:, 0], e).to(torch.float32)
    return e * (probs.mean(dim=0) * first.mean(dim=0)).sum()


def _dense_residual(p: dict, x: torch.Tensor) -> torch.Tensor:
    dp = p["dense"]
    g = constrain(x @ dp["w_gate"], "dp", "tp")
    u = constrain(x @ dp["w_up"], "dp", "tp")
    return constrain((F.silu(g) * u) @ dp["w_down"], "dp", None)


def _apply_moe_grouped(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-local dispatch: the T tokens split into ``groups`` contiguous
    slices aligned with the data sharding; each group has a private
    per-expert capacity slice of ``cap_g`` rows, ranked in token-major
    order within the group, so the scatter and the combine gather touch
    only group-local rows. The buffer is (G, E, cap_g, d); the expert
    products run on its (E, G, cap_g, d) transpose, experts on tp and
    groups on dp, as JAX's 4-D einsums do."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    tg = t // groups
    gates, idx, probs = route(p, x, cfg)
    aux = _aux_loss(probs, idx, e)

    cap_g = max(1, int(cfg.capacity_factor * tg * k / e))
    flat_e = idx.reshape(groups, tg * k)                       # (G, Tg*k)
    # rank within the group: a scan along the contiguous axis of the
    # (G, E, Tg*k) one-hot, as the flat dispatch scans (E, T*k)
    onehot = F.one_hot(flat_e, e).transpose(1, 2).contiguous()
    pos = onehot.cumsum(dim=2).gather(1, flat_e[:, None])[:, 0] - 1
    valid = (pos < cap_g).to(x.dtype)[..., None]               # (G, Tg*k, 1)
    pos = pos.clamp(0, cap_g - 1)
    x_rep = constrain(x.view(groups, tg, d).repeat_interleave(k, dim=1)
                      * valid, "dp", None, None)               # (G, Tg*k, d)
    buf = torch.zeros((groups, e, cap_g, d), dtype=x.dtype, device=x.device)
    gidx = torch.arange(groups, device=x.device)[:, None].expand(
        groups, tg * k)
    buf.index_put_((gidx, flat_e, pos), x_rep, accumulate=True)
    buf = constrain(buf.transpose(0, 1), "tp", "dp", None, None)

    g = constrain(torch.einsum("egcd,edf->egcf", buf, p["w_gate"]),
                  "tp", "dp", None, None)
    u = constrain(torch.einsum("egcd,edf->egcf", buf, p["w_up"]),
                  "tp", "dp", None, None)
    out_buf = constrain(torch.einsum("egcf,efd->egcd", F.silu(g) * u,
                                     p["w_down"]), "tp", "dp", None, None)
    gathered = out_buf.transpose(0, 1)[gidx, flat_e, pos] * (
        gates.reshape(groups, tg * k, 1).to(x.dtype) * valid)
    out = constrain(gathered.view(groups, tg, k, d).sum(dim=2).reshape(t, d),
                    "dp", None)
    if cfg.moe_dense_residual:
        out = out + _dense_residual(p, x)
    return out, aux
