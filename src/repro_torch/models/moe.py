"""Mixture-of-Experts layer, ported from ``repro.models.moe``: fp32 top-k
routing, the Switch auxiliary loss, capacity-based dispatch into an
``(E, C, d)`` buffer, the experts' SwiGLU batched over experts, the gated
combine, and arctic's parallel dense residual.

Only the flat dispatch (one capacity pool) is ported. JAX's group-local
dispatch (``_apply_moe_grouped``) runs only when its sharding context gives
more than one group, which needs the sharding port (ROADMAP.md queue 1,
"Sharding").

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
from .layers import dense_init, swiglu


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
    gates, idx, probs = route(p, x, cfg)
    # Switch auxiliary loss: mean router probability x share of first picks
    first = F.one_hot(idx[:, 0], e).to(torch.float32)
    aux = e * (probs.mean(dim=0) * first.mean(dim=0)).sum()

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

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])                       # (E, C, d)
    gathered = out_buf[flat_e, pos] * (
        gates.reshape(-1, 1).to(x.dtype) * valid)
    out = gathered.view(t, k, d).sum(dim=1)
    if cfg.moe_dense_residual:
        out = out + _dense_residual(p, x)
    return out, aux


def _dense_residual(p: dict, x: torch.Tensor) -> torch.Tensor:
    dp = p["dense"]
    return swiglu(x, dp["w_gate"], dp["w_up"], dp["w_down"])
