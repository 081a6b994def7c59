"""Logical-axis -> mesh-axis sharding rules, ported from
``repro.sharding.rules``.

Strategy:
* ``model`` axis: tensor parallelism -- attention/MLP projections sharded
  on the flattened head/ffn dim; MoE experts sharded on the expert dim
  (EP); vocab-parallel embedding + LM head.
* ``data`` axis: FSDP -- the other weight dim + optimizer states sharded;
  the batch dim of activations.
* ``pod`` axis (multi-pod): pure data parallelism -- params replicated
  across pods, batch sharded over (pod, data).

Any dim not divisible by its mesh-axis extent falls back to replication
for that dim (e.g. hymba's vocab 32001).

A spec is JAX's ``PartitionSpec`` as a tuple: one entry per tensor dim, a
mesh axis name, a tuple of names (major to minor) or None. Leaves are
anything with ``.shape`` (meta tensors too), in the port's nested-dict
trees, whose key paths are ``train/checkpoint.py``'s. A mesh is a
``DeviceMesh``, or anything with its ``mesh_dim_names`` and ``shape``.
``to_placements`` turns a spec into DTensor placements and ``shard_tree``
lays a tree out by its specs, the torch form of JAX's ``to_named`` and
``device_put``.
"""

from __future__ import annotations

from typing import Any, Optional

# name-keyed rules: (dim_roles...) where each role is one of
#   "tp"   -> model axis
#   "fsdp" -> data axis
#   None   -> replicated
_RULES: dict[str, tuple] = {
    # embeddings (vocab-parallel)
    "embed": ("tp", "fsdp"),
    "lm_head": ("fsdp", "tp"),
    # attention (flat head dims)
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    # dense mlp
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp"),
    # rwkv time/channel mix
    "w_r": ("fsdp", "tp"), "w_k": ("fsdp", "tp"), "w_v": ("tp", "fsdp"),
    "w_g": ("fsdp", "tp"), "w_o": ("tp", "fsdp"),
    "w_lora_a": (None, None), "w_lora_b": (None, None),
    # mamba
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "dt_a": ("fsdp", None), "dt_b": (None, "fsdp"),
    "w_bc": ("fsdp", None), "conv_w": (None, "tp"),
    "a_log": ("tp", None), "bonus_u": (None, None),
    # moe (expert-parallel)
    "router": ("fsdp", None),
}
# MoE expert tensors are rank-3 and share names with dense mlp weights;
# disambiguated by rank below.
_MOE_RULES = {
    "w_gate": ("tp", "fsdp", None),
    "w_up": ("tp", "fsdp", None),
    "w_down": ("tp", None, "fsdp"),
}
_DP_AXES = ("data", ("pod", "data"), "pod")


def _axis(role: Optional[str], *, dp_axis="data", tp_axis="model"):
    if role == "tp":
        return tp_axis
    if role == "fsdp":
        return dp_axis
    return None


def axis_sizes(mesh) -> dict:
    """{axis name: extent}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _dp(mesh) -> tuple[Any, int]:
    """(the data-parallel axes as a spec entry, their product)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    size = 1
    for a in dp:
        size *= sizes[a]
    return (dp if len(dp) > 1 else (dp[0] if dp else None)), size


def _spec_for(path_keys: list[str], leaf_shape: tuple, mesh_axes: dict,
              stacked: bool) -> tuple:
    name = path_keys[-1] if path_keys else ""
    in_moe = "moe" in path_keys and "dense" not in path_keys
    base_rank = len(leaf_shape) - (1 if stacked else 0)
    if in_moe and name in _MOE_RULES and base_rank == 3:
        roles = _MOE_RULES[name]
    else:
        roles = _RULES.get(name)
    if roles is None or len(roles) != base_rank:
        roles = (None,) * base_rank
    axes = [_axis(r) for r in roles]
    # divisibility fallback: replicate dims the mesh doesn't divide
    dims = leaf_shape[1:] if stacked else leaf_shape
    fixed = []
    for d, a in zip(dims, axes):
        if a is not None and d % mesh_axes.get(a, 1) != 0:
            a = None
        fixed.append(a)
    if stacked:
        fixed = [None] + fixed
    return tuple(fixed)


def _map_with_path(fn, tree, path=()):
    """``fn(key path, leaf)`` over a nested dict; a non-dict is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(list(path), tree)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def param_specs(params_tree: Any, mesh, mode: str = "train") -> Any:
    """Spec tree mirroring ``params_tree``.

    ``mode="serve"``: TP-only -- the FSDP ('data') dim is replicated, so a
    decode step does not all-gather every layer's weights per token."""
    mesh_axes = axis_sizes(mesh)

    def one(names, leaf):
        stacked = "layers" in names
        spec = _spec_for(names, tuple(leaf.shape), mesh_axes, stacked)
        if mode == "serve":
            spec = tuple(None if a in _DP_AXES else a for a in spec)
        return spec

    return _map_with_path(one, params_tree)


def opt_specs(opt_tree: Any, params_spec_tree: Any, mesh) -> Any:
    """Optimizer-state specs: adam m/v/ef mirror the param spec;
    adafactor's factored row/col stats are replicated, as JAX's are."""
    mesh_axes = axis_sizes(mesh)

    def one(names, leaf):
        # strip the leading container key ("m"/"v"/"ef"/"f") and any
        # trailing factored key ("row"/"col"/"v")
        inner = [n for n in names
                 if n not in ("m", "v", "ef", "f", "row", "col")]
        if names[-1] in ("row", "col"):
            return (None,) * _ndim(leaf)
        return _spec_for(inner, tuple(leaf.shape), mesh_axes,
                         "layers" in inner)

    return _map_with_path(one, opt_tree)


def batch_specs(batch_tree: Any, mesh) -> Any:
    """Batch dim over all data-parallel axes (pod, data)."""
    dp_axes, dp_size = _dp(mesh)

    def one(_, leaf):
        if _ndim(leaf) == 0 or leaf.shape[0] % dp_size != 0:
            return ()
        return (dp_axes,) + (None,) * (_ndim(leaf) - 1)

    return _map_with_path(one, batch_tree)


def cache_specs(cache_tree: Any, mesh) -> Any:
    """Decode caches: (L, B, ...) -- B over the dp axes when divisible,
    plus one feature dim over 'model': for 5-D KV caches (L, B, S, Hkv,
    hd) the kv-head dim, falling back to the head dim."""
    dp_axes, dp_size = _dp(mesh)
    tp = axis_sizes(mesh).get("model", 1)

    def one(_, leaf):
        nd, shape = _ndim(leaf), tuple(leaf.shape)
        spec = [None] * nd
        if nd >= 2 and shape[1] % dp_size == 0:
            spec[1] = dp_axes
        if nd >= 4:
            if nd >= 5 and shape[3] % tp == 0:
                spec[3] = "model"
            elif shape[-1] % tp == 0:
                spec[-1] = "model"
        return tuple(spec)

    return _map_with_path(one, cache_tree)


def state_specs(state_shapes: dict, mesh) -> dict:
    """Specs for a full train state {params, opt, step}."""
    pspecs = param_specs(state_shapes["params"], mesh)
    return {"params": pspecs,
            "opt": opt_specs(state_shapes["opt"], pspecs, mesh),
            "step": ()}


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a tensor dim over one
    axis is ``Shard(dim)`` on that mesh dim; over a tuple of axes it is
    ``Shard(dim)`` on each, which DTensor splits in mesh-dim order, so the
    tuple must name them in that order (JAX's major to minor); every other
    mesh dim is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        index = [names.index(a) for a in axes]
        if index != sorted(index):
            raise ValueError(f"spec {spec}: {axes} is not in the mesh's "
                             f"order {names}")
        for i in index:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]} "
                                 f"shards two tensor dims")
            out[i] = Shard(dim)
    return tuple(out)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` laid out on ``mesh`` by ``specs``: each tensor leaf a
    DTensor (``distribute_tensor``, every rank passing the same full
    tensor; a meta leaf, which holds no data, is cut into meta shards
    without a collective); a non-tensor leaf (the state's int step) passes
    through."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        src = {"src_data_rank": None} if leaf.is_meta else {}
        return distribute_tensor(leaf, mesh, to_placements(spec, mesh),
                                 **src)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return one(t, s)

    return walk(tree, specs)
