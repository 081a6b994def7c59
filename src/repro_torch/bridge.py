"""Parameter and state bridge between the JAX checkpoint layout and the
port.

Keys are the ``/``-joined key paths that ``repro.train.checkpoint._flatten``
writes (``embed``, ``layers/attn/wq``, ``final_norm``, ...), with the
layer-stacked ``(L, ...)`` leading axis of the JAX parameter tree. Arrays
cross as float32 numpy: ``torch.from_numpy`` cannot take a numpy bfloat16
array, and ``_flatten`` already upcasts bf16 leaves losslessly.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig

# kept in float32 whatever the model's dtype, as the JAX init does
FP32_LEAVES = frozenset({"ln1", "ln2", "final_norm", "q_norm", "k_norm",
                         # RWKV time-mix and channel-mix (repro.models.ssm)
                         "mu", "w0", "w_lora_a", "w_lora_b", "bonus_u",
                         "ln_w", "ln_b"})


def leaf_dtype(key: str, cfg: ArchConfig) -> torch.dtype:
    if key.rsplit("/", 1)[-1] in FP32_LEAVES:
        return torch.float32
    return getattr(torch, cfg.param_dtype)


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ArchConfig,
                      device) -> dict:
    """Flat ``{key path: float32 array}`` -> nested dict of tensors on
    ``device``, each cast to the dtype the port's ``init_params`` gives it."""
    params: dict = {}
    for key, arr in flat.items():
        if arr.dtype != np.float32:
            raise TypeError(f"{key}: expected float32, got {arr.dtype}")
        *path, leaf = key.split("/")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.tensor(arr, device=device).to(
            leaf_dtype(key, cfg))
    return params


def tree_to_numpy(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """The reverse, for parameters or a whole train state: nested tensors ->
    flat ``{key path: array}`` as ``_flatten`` writes it: bf16 upcast to
    fp32, other dtypes kept, and the state's int ``step`` as a 0-d int32
    array (JAX's step is an int32 scalar)."""
    flat: dict[str, np.ndarray] = {}
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            flat.update(tree_to_numpy(value, key + "/"))
        elif isinstance(value, int):
            flat[key] = np.asarray(value, np.int32)
        else:
            t = value.detach().cpu()
            flat[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return flat


def tree_from_numpy(flat, template: dict, prefix: str = "") -> dict:
    """Flat arrays (a dict, or an open ``.npz``) -> a new tree shaped like
    ``template``, each leaf cast to the template leaf's dtype and device,
    an int leaf read back as an int."""
    out: dict = {}
    for name, leaf in template.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out[name] = tree_from_numpy(flat, leaf, key + "/")
        elif isinstance(leaf, int):
            out[name] = int(flat[key])
        else:
            arr = np.asarray(flat[key])
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape}, expected "
                                 f"{tuple(leaf.shape)}")
            out[name] = torch.tensor(arr).to(leaf.device, leaf.dtype)
    return out
