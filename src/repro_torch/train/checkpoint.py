"""Checkpointing with coordinator-committed manifests, ported from
``repro.train.checkpoint``.

Layout: ``<dir>/step_N/arrays.npz`` (flattened state leaves) +
``<dir>/step_N/manifest.json``, the JAX package's: the same key paths
(``params/layers/attn/wq``, ``opt/m/embed``, ``step``) and bf16 leaves
upcast to fp32, so a checkpoint of either package restores into the
other. The manifest is authoritative only once it is committed through
the coordinator's Raft log (``coord.registry``); on restart,
``latest_checkpoint()`` is a leased read.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..bridge import tree_from_numpy, tree_to_numpy


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def save_checkpoint(directory: str, step: int, state: dict,
                    extra: Optional[dict] = None, registry=None) -> dict:
    """Write arrays + manifest; commit the manifest via the registry
    (LeaseGuard Raft) if one is provided. Returns the manifest."""
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    flat = tree_to_numpy(state)
    npz_path = os.path.join(path, "arrays.npz")
    np.savez(npz_path, **flat)
    manifest = {
        "step": step,
        "path": path,
        "n_arrays": len(flat),
        "sha256": _sha256(npz_path),
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if registry is not None:
        res = registry.commit_checkpoint(manifest)
        if not res:
            raise RuntimeError("coordinator rejected checkpoint commit")
    return manifest


def restore_checkpoint(state_template: dict, manifest: dict) -> dict:
    """A new state from a committed manifest, each leaf in the template's
    dtype and on its device."""
    with np.load(os.path.join(manifest["path"], "arrays.npz")) as npz:
        return tree_from_numpy(npz, state_template)


def verify_checkpoint(manifest: dict) -> bool:
    npz_path = os.path.join(manifest["path"], "arrays.npz")
    if not os.path.exists(npz_path):
        return False
    return _sha256(npz_path) == manifest["sha256"]
