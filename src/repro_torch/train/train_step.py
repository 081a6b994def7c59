"""Training step, ported from ``repro.train.train_step``: microbatched
gradient accumulation, clipping, optimizer update.

The state is ``{"params", "opt", "step"}`` as in JAX (``step`` a Python
int). ``train_step`` updates it in place and returns it with the step's
metrics: one backward per microbatch, each microbatch's gradients in the
parameters' dtype summed into fp32 buffers, then divided by the number of
microbatches, JAX's order.

A state laid out on a mesh (``sharding.rules.shard_tree`` by
``state_specs``) trains as it is: every gradient buffer takes its
parameter's placements (``zeros_like``, and the per-layer slices of
``loss_and_grads``), the optimizer updates each rank's local shards in
place, and the global norm and the loss are reduced across ranks.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import forward_train, init_params
from ..sharding.ctx import sharded
from .optimizer import OptConfig, apply_updates, init_opt_state, leaves, \
    tree_map


def whole(t: torch.Tensor) -> torch.Tensor:
    """A scalar metric every rank holds whole: a DTensor's full value (a
    partial sum is reduced), else ``t``."""
    return t.full_tensor() if sharded(t) else t


def init_train_state(gen: torch.Generator, cfg: ArchConfig,
                     opt_cfg: OptConfig) -> dict:
    params = init_params(gen, cfg)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": 0}


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """Row block i of every array is microbatch i, as JAX's reshape to
    (accum, B // accum, ...) cuts it."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by accum {accum}")
    n = b // accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(accum)]


def _leaf(p: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``p``'s storage whose gradient autograd adds into
    ``grad`` in place."""
    t = p.detach().requires_grad_(True)
    t.grad = grad
    return t


def loss_and_grads(params: dict, cfg: ArchConfig, batch: dict,
                   impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """``forward_train``'s loss and its gradient for every leaf of
    ``params``, in the parameters' dtypes, as ``jax.value_and_grad`` gives
    them. Each layer runs on views of its slice of the stacked leaves, whose
    gradients autograd writes into the matching slice of the gradient tree,
    so no layer's backward builds a gradient of the whole stack."""
    grads = tree_map(torch.zeros_like, params)
    tree = {k: tree_map(_leaf, v, grads[k]) for k, v in params.items()
            if k != "layers"}
    tree["layers"] = [
        tree_map(lambda p, g, i=i: _leaf(p[i], g[i]), params["layers"],
                 grads["layers"])
        for i in range(cfg.n_layers)]
    loss = forward_train(tree, cfg, batch, impl)
    loss.backward()
    return whole(loss.detach()), grads


def to_device(batch: dict, device) -> dict:
    """numpy or tensor batch -> tensors on ``device``: ids and labels as
    int64, a stub frontend's float embeds in their own dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, t.dtype if t.is_floating_point()
                      else torch.long)
    return out


def train_step(state: dict, batch: dict, cfg: ArchConfig,
               opt_cfg: OptConfig, impl: str = "kernel") -> tuple[dict, dict]:
    """One optimizer step over a global batch (with grad accumulation).
    Returns (state, {"loss", "grad_norm"}), both fp32 0-d tensors."""
    params = state["params"]
    batch = to_device(batch, params["embed"].device)
    accum = max(1, cfg.grad_accum)
    if accum == 1:
        loss, grads = loss_and_grads(params, cfg, batch, impl)
    else:
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        loss = torch.zeros((), dtype=torch.float32, device=grads["embed"].device)
        for mb in _split_microbatches(batch, accum):
            mb_loss, mb_grads = loss_and_grads(params, cfg, mb, impl)
            loss += mb_loss
            tree_map(torch.Tensor.add_, grads, mb_grads)
            del mb_grads
        loss /= accum
        for g in leaves(grads):
            g.div_(accum)
    _, _, gnorm = apply_updates(grads, state["opt"], params, opt_cfg,
                                state["step"])
    state["step"] += 1
    return state, {"loss": loss, "grad_norm": whole(gnorm)}
