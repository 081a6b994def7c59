"""The reference's training steps: the mean of the microbatches' losses,
the gradient summed over microbatches and divided by their number, one
global-norm clip, AdamW with bias correction and decoupled weight decay on
every leaf of two or more axes, warmup then cosine learning rate, in fp32.
Leaves the configuration stores in bf16 are rounded to bf16 after each
update, as the configuration stores them; the arithmetic stays fp32.
"""

from __future__ import annotations

import math

import torch

from .. import traffic, weights
from . import model as ref


def lr_at(opt: dict, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    t = min(max((step - opt["warmup_steps"])
                / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def steps(cell, seed: int, device, n_steps: int, prec=ref.FP32,
          half_batch: bool = False) -> dict:
    """``n_steps`` optimizer steps from the seed's weights on the batches
    the program trains on first. Returns {"loss": [per step], "grad":
    {leaf: norm of the first step's clipped gradient}, "change": {leaf:
    norm of the parameters' change over the steps}}. ``half_batch``: the
    fault that leaves out the second half of every batch."""
    m, mix = cell.model, cell.mix
    opt = mix["optimizer"]
    params = weights.make(cell, seed, device, dtype=torch.float32)
    flat = weights.flat_leaves(params)
    stored = {".".join(path): dt
              for path, (_, dt) in weights.layout(cell).items()}
    grads = {k: torch.zeros_like(p) for k, p in flat.items()}
    state = {k: (torch.zeros_like(p), torch.zeros_like(p))
             for k, p in flat.items()}
    # each microbatch's gradient lands in ``mb`` and is kept in the
    # precision's store before it is summed, as the program keeps it in
    # the parameters' dtype
    mb_grads = {k: torch.zeros_like(p) for k, p in flat.items()}
    tree = _grad_tree(params, mb_grads, m.n_layers)
    out = {"loss": []}
    for step in range(n_steps):
        batch = traffic.train_batch(mix, m.vocab_size, seed, step)
        rows = batch["tokens"].shape[0] // (2 if half_batch else 1)
        tokens = torch.as_tensor(batch["tokens"][:rows]).long().to(device)
        labels = torch.as_tensor(batch["labels"][:rows]).long().to(device)
        accum = mix["microbatches"]
        per = rows // accum
        total = 0.0
        for i in range(accum):
            sl = slice(i * per, (i + 1) * per)
            mb = ref.loss(tree, m, tokens[sl], labels[sl], prec)
            mb.backward()
            total += float(mb.detach())
            with torch.no_grad():
                for k, g in mb_grads.items():
                    grads[k].add_(prec.store(g))
                    g.zero_()
        for g in grads.values():
            g.div_(accum)
        out["loss"].append(total / accum)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-12), max=1.0)
            for g in grads.values():
                g.mul_(scale)
            if step == 0:
                out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            _adamw(flat, grads, state, stored, opt, step)
            for g in grads.values():
                g.zero_()
    with torch.no_grad():
        start = weights.flat_leaves(weights.make(cell, seed, device,
                                                 dtype=torch.float32))
        out["change"] = {k: float((flat[k] - start[k]).norm())
                         for k in flat}
    return out


def _leaf(p: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """A leaf on ``p``'s storage whose gradient autograd adds into
    ``grad`` in place."""
    t = p.detach().requires_grad_(True)
    t.grad = grad
    return t


def _grad_tree(params: dict, grads: dict, n_layers: int) -> dict:
    """The model's tree with each layer's slice of the stacked leaves a
    leaf of its own, its gradient landing in its slice of ``grads``: the
    backward of a slice of a stacked leaf would build a gradient of the
    whole stack for every layer."""
    def walk(tree, prefix, i=None):
        out = {}
        for k, v in tree.items():
            name = prefix + k
            if isinstance(v, dict):
                out[k] = walk(v, name + ".", i)
            elif i is None:
                out[k] = _leaf(v, grads[name])
            else:
                out[k] = _leaf(v[i], grads[name][i])
        return out
    tree = walk({k: v for k, v in params.items() if k != "layers"}, "")
    tree["layers"] = [walk(params["layers"], "layers.", i)
                      for i in range(n_layers)]
    return tree


def _adamw(flat, grads, state, stored, opt, step) -> None:
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for k, p in flat.items():
        g = grads[k]
        mom, var = state[k]
        mom.mul_(b1).add_(g, alpha=1 - b1)
        var.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (mom / bc1) / ((var / bc2).sqrt() + opt["eps"])
        if p.dim() >= 2:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
        if stored[k] != torch.float32:
            p.copy_(p.to(stored[k]).float())
