"""Optimizers, ported from ``repro.train.optimizer``: AdamW (fp32 states)
and Adafactor (factored second moment), with global-norm clipping,
warmup + cosine LR, and optional int8 gradient compression with error
feedback.

Trees are nested dicts of tensors, as the model's parameters. Unlike the
JAX functions, which return new trees, these update the parameters and
the optimizer state in place under ``torch.no_grad`` (no second copy of
either at full width) and return them. The arithmetic is JAX's, in its
order, including what it decays: every leaf with two or more axes, so
the layer-stacked (L, d) norm weights are decayed and the (d,) final
norm is not, and Adafactor factors a stacked (L, d) norm across layers
(ROADMAP.md queue 3, f). ``torch.optim`` is not used: its AdamW decays
differently and its schedules differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: str = "none"           # none | int8_ef


def lr_schedule(cfg: OptConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, cfg.warmup_steps))
    t = min(max((step - cfg.warmup_steps)
                / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


# ----------------------------------------------------------------- trees
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts), each with the
    matching entries of ``rest``, which may be dicts at those leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ compression
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads_int8_ef(grads, ef):
    """Quantize each leaf to int8 with error feedback. Returns
    (dequantized grads, error buffers); the buffers are updated in place."""
    def one(g, e):
        gf = g.float() + e
        q, scale = quantize_int8(gf)
        deq = q.float() * scale
        e.copy_(gf - deq)
        return deq
    return tree_map(one, grads, ef), ef


# ------------------------------------------------------------------ adamw
def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params, cfg: OptConfig) -> dict:
    state = {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params)}
    if cfg.compress == "int8_ef":
        state["ef"] = tree_map(_zeros, params)
    return state


def _apply(p: torch.Tensor, upd: torch.Tensor, cfg: OptConfig,
           lr: float) -> None:
    """p <- p - lr * (upd + wd * p) for a leaf of 2+ axes, p - lr * upd
    otherwise, in fp32 and cast back to p's dtype; ``upd`` is overwritten."""
    if p.dim() >= 2:
        upd.add_(p, alpha=cfg.weight_decay)
    p.copy_(upd.mul_(-lr).add_(p))


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: OptConfig, step: int):
    if cfg.compress == "int8_ef":
        grads, state["ef"] = compress_grads_int8_ef(grads, state["ef"])
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step + 1.0)
    bc2 = 1 - b2 ** (step + 1.0)

    def one(g, m, v, p):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.div(bc2).sqrt_().add_(cfg.eps)
        upd = m.div(bc1).div_(denom)
        del denom
        _apply(p, upd, cfg, lr)

    tree_map(one, grads, state["m"], state["v"], params)
    return params, state


# -------------------------------------------------------------- adafactor
def adafactor_init(params, cfg: OptConfig) -> dict:
    def one(p):
        if p.dim() >= 2:
            return {"row": _zeros(p[..., 0]), "col": _zeros(p[..., 0, :])}
        return {"v": _zeros(p)}
    state = {"f": tree_map(one, params)}
    if cfg.compress == "int8_ef":
        state["ef"] = tree_map(_zeros, params)
    return state


@torch.no_grad()
def adafactor_update(grads, state: dict, params, cfg: OptConfig, step: int):
    if cfg.compress == "int8_ef":
        grads, state["ef"] = compress_grads_int8_ef(grads, state["ef"])
    lr = lr_schedule(cfg, step)
    decay = 1.0 - (step + 1.0) ** -0.8

    def one(g, f, p):
        g = g.float()
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            row = f["row"].mul_(decay).add_(g2.mean(dim=-1), alpha=1 - decay)
            col = f["col"].mul_(decay).add_(g2.mean(dim=-2), alpha=1 - decay)
            denom = torch.sqrt(row[..., None] * col[..., None, :]
                               / (row.mean(dim=-1, keepdim=True)[..., None]
                                  + 1e-30)) + 1e-30
        else:
            v = f["v"].mul_(decay).add_(g2, alpha=1 - decay)
            denom = torch.sqrt(v) + 1e-30
        del g2
        upd = g / denom
        del denom
        # update clipping (Adafactor RMS trick)
        rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
        upd.div_(torch.clamp(rms, min=1.0))
        _apply(p, upd, cfg, lr)

    tree_map(one, grads, state["f"], params)   # f: a dict at each leaf
    return params, state


# ------------------------------------------------------------------ public
def init_opt_state(params, cfg: OptConfig) -> dict:
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    return adamw_init(params, cfg)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32; the
    norm before scaling). fp32 leaves are scaled in place, others copied
    to fp32 first: the values are JAX's, without a second fp32 copy of the
    fp32 accumulator."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float().mul_(scale), grads), norm


def apply_updates(grads, opt_state: dict, params, cfg: OptConfig, step: int):
    """Clip, then update ``params`` and ``opt_state`` in place. Returns
    (params, opt_state, the grads' global norm before clipping)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.name == "adafactor":
        params, opt_state = adafactor_update(grads, opt_state, params, cfg,
                                             step)
    else:
        params, opt_state = adamw_update(grads, opt_state, params, cfg, step)
    return params, opt_state, gnorm
