"""The model's weights, made by the benchmark from ``--seed``.

The tree's layout (keys, shapes, dtypes) is the port's interface, read from
``repro_torch.models.init_params`` on the meta device, which allocates and
draws nothing. The values are the benchmark's: every leaf the config's
"init" rules do not name is drawn from N(0, 1 / fan_in), fan_in the
leaf's second-to-last size (1 for a vector), as the port's ``dense_init``
scales them; those of one dtype come from one ``torch.randn`` call on the
device into one buffer, each leaf a view of it, aligned as the caching
allocator aligns a block. The rules name leaves by their last key:
"ones", "zeros", "log_arange" (log 1..n along the last axis, Mamba's
``a_log``) and "scale" ({key: factor on the std}).

The same seed gives the same weights, bit for bit, so the reference draws
them again after the program's state is freed.
"""

from __future__ import annotations

import math

import torch

ALIGN = 256          # elements between leaf starts: 512-byte blocks


def layout(cell) -> dict:
    """{path tuple: (shape, dtype)} of the port's parameter tree."""
    from repro_torch.models import init_params
    meta = init_params(torch.Generator("cpu"), cell.arch(), device="meta")
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[path + (k,)] = (tuple(v.shape), v.dtype)
    walk(meta, ())
    return out


def census(lay: dict) -> dict:
    """Parameter and byte counts the prefill bound reads: the layer
    stack's, and the LM head's (the embedding table if tied)."""
    layer = [(math.prod(s), d.itemsize) for p, (s, d) in lay.items()
             if p[0] == "layers"]
    head = lay.get(("lm_head",), lay[("embed",)])
    n = math.prod(head[0])
    return {"layer_params": sum(a for a, _ in layer),
            "layer_bytes": sum(a * b for a, b in layer),
            "head_params": n, "head_bytes": n * head[1].itemsize}


def make(cell, seed: int, device, dtype=None) -> dict:
    """The weights of ``seed`` on ``device`` in the port's tree; with
    ``dtype``, every leaf cast to it afterwards (the reference's fp32
    copy of the same values)."""
    rules = cell.config["init"]
    lay = layout(cell)
    gen = torch.Generator(device).manual_seed(seed)
    leaves = {}
    drawn: dict = {}
    for path, (shape, dt) in lay.items():
        key = path[-1]
        if key in rules.get("ones", ()):
            leaves[path] = torch.ones(shape, dtype=dt, device=device)
        elif key in rules.get("zeros", ()):
            leaves[path] = torch.zeros(shape, dtype=dt, device=device)
        elif key in rules.get("log_arange", ()):
            n = shape[-1]
            row = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                         device=device))
            leaves[path] = row.expand(shape).to(dt).contiguous()
        else:
            drawn.setdefault(dt, []).append(path)
    for dt, paths in drawn.items():
        sizes = [math.prod(lay[p][0]) for p in paths]
        starts, total = [], 0
        for n in sizes:
            starts.append(total)
            total += -(-n // ALIGN) * ALIGN
        flat = torch.randn(total, generator=gen, dtype=dt, device=device)
        for p, n, at in zip(paths, sizes, starts):
            shape = lay[p][0]
            fan_in = shape[-2] if len(shape) > 1 else 1
            std = rules.get("scale", {}).get(p[-1], 1.0) / math.sqrt(fan_in)
            leaves[p] = flat[at:at + n].view(shape).mul_(std)
    tree: dict = {}
    for path in lay:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        leaf = leaves[path]
        node[path[-1]] = leaf if dtype is None else leaf.to(dtype)
    return tree


def flat_leaves(tree: dict, prefix: str = "") -> dict:
    """{"a.b.c": tensor} of a nested tree, in its order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_leaves(v, name + "."))
        else:
            out[name] = v
    return out
