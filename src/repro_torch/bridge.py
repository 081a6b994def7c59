"""Parameter bridge between the JAX checkpoint layout and the port.

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


def params_to_numpy(params: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """The reverse: nested tensors -> flat ``{key path: float32 array}``."""
    flat: dict[str, np.ndarray] = {}
    for name, value in params.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            flat.update(params_to_numpy(value, key + "/"))
        else:
            flat[key] = value.detach().to("cpu", torch.float32).numpy()
    return flat
