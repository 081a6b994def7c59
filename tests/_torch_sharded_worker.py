"""The port's sharded execution on a 2 x 2 (data, model) mesh of four gloo
processes on the CPU, for ``tests/test_torch_sharding.py``.

  python tests/_torch_sharded_worker.py DIR

reads ``DIR/state_adamw.npz`` and ``DIR/state_adafactor.npz`` (a reduced
qwen3-8b train state in the checkpoint layout, one per optimizer), spawns
four ranks that meet through a ``FileStore`` in DIR, and runs every case
on every rank (a collective that one rank skips would hang the others):

* ``train`` and ``train_sp``: ``STEPS`` AdamW train steps of the state
  laid out by ``state_specs``, the batch by ``batch_specs``, without and
  with sequence parallelism; ``train_adafactor``: Adafactor's, whose
  factored statistics the rules replicate;
* ``serve``: a prefill of ``PROMPT`` tokens and ``DECODE`` greedy decode
  steps on ``param_specs(mode="serve")``, the caches by ``cache_specs``;
* ``mutant``: the same prefill with the attention operands' heads placed
  on hd, which must change the logits.

Rank 0 writes each case's full tensors to ``DIR/results.npz``. It imports
no JAX; the test compares these results with the unsharded port and JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import whole  # noqa: E402

WORLD, MESH = 4, (2, 2)
STEPS, ACCUM, TRAIN_SHAPE = 2, 2, ShapeConfig("t", "train", 16, 4)
PROMPT, DECODE = 11, 3
RANK_TIMEOUT_S = 240


# case: (sequence parallelism, optimizer)
TRAIN_CASES = {"train": (False, "adamw"), "train_sp": (True, "adamw"),
               "train_adafactor": (False, "adafactor")}


def configs(optimizer: str = "adamw"):
    """(model config, optimizer config) of every case."""
    cfg = dataclasses.replace(ARCHS["qwen3-8b"].reduced(),
                              param_dtype="float32", grad_accum=ACCUM)
    return cfg, topt.OptConfig(name=optimizer, warmup_steps=2,
                               total_steps=10, lr=1e-2)


def prompt_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (4, PROMPT),
                                             dtype=np.int64)


def _train(state, mesh, sp: bool, optimizer: str) -> tuple[dict, dict]:
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.sharding import ctx, rules
    from repro_torch.train import data
    from repro_torch.train.train_step import train_step, to_device
    cfg, opt_cfg = configs(optimizer)
    ctx.set_axes(*ctx.axes_from_mesh(mesh), sp=sp)
    state = rules.shard_tree(state, rules.state_specs(state, mesh), mesh)
    out = {}
    for step in range(STEPS):
        batch = to_device(data.synth_batch(cfg, TRAIN_SHAPE, step), "cpu")
        batch = rules.shard_tree(batch, rules.batch_specs(batch, mesh), mesh)
        state, m = train_step(state, batch, cfg, opt_cfg)
        out[f"loss/{step}"] = m["loss"].numpy()
        out[f"grad_norm/{step}"] = m["grad_norm"].numpy()
    placed = {"wq": str(tuple(
        state["params"]["layers"]["attn"]["wq"].placements))}
    params = topt.tree_map(whole, state["params"])
    out.update((f"params/{k}", v) for k, v in tree_to_numpy(params).items())
    ctx.clear()
    return out, placed


def _serve(params, mesh) -> dict:
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    from repro_torch.sharding import ctx, rules
    cfg, _ = configs()
    ctx.set_axes(*ctx.axes_from_mesh(mesh))
    params = rules.shard_tree(params, rules.param_specs(params, mesh,
                                                        mode="serve"), mesh)

    def batch_sharded(tree):
        return rules.shard_tree(tree, rules.batch_specs(tree, mesh), mesh)

    tokens = batch_sharded({"t": torch.from_numpy(prompt_tokens(cfg))})["t"]
    out = {}
    with torch.no_grad():
        logits, caches, pos = prefill(params, cfg, {"tokens": tokens})
        caches = preallocate_cache(cfg, caches, PROMPT + DECODE)
        out["cache_placements"] = np.array(
            str(tuple(caches["kv"]["k"].placements)))
        for step in range(DECODE + 1):
            out[f"logits/{step}"] = whole(logits).numpy()
            if step == DECODE:
                break
            ids = whole(logits).argmax(-1)
            out[f"ids/{step}"] = ids.numpy()
            fed = batch_sharded({"t": ids, "p": pos + step})
            logits, caches = decode_step(params, cfg, fed["t"], caches,
                                         fed["p"])
    ctx.clear()
    return out


def _mutant_prefill(params, mesh) -> dict:
    """The prefill with the attention operands' head shard moved to hd."""
    from repro_torch.kernels import ops
    from repro_torch.models import prefill
    from repro_torch.sharding import ctx, rules
    cfg, _ = configs()
    ctx.set_axes(*ctx.axes_from_mesh(mesh))
    params = rules.shard_tree(params, rules.param_specs(params, mesh), mesh)
    tokens = torch.from_numpy(prompt_tokens(cfg))
    tokens = rules.shard_tree({"t": tokens}, rules.batch_specs(
        {"t": tokens}, mesh), mesh)["t"]
    real = ops.SEQ_ROLES
    ops.SEQ_ROLES = ("dp", None, None, "tp")
    try:
        with torch.no_grad():
            logits = prefill(params, cfg, {"tokens": tokens})[0]
    finally:
        ops.SEQ_ROLES = real
        ctx.clear()
    return {"logits/0": whole(logits).numpy()}


def _state(directory: str, optimizer: str) -> dict:
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.train.train_step import init_train_state
    cfg, opt_cfg = configs(optimizer)
    flat = np.load(os.path.join(directory, f"state_{optimizer}.npz"))
    return tree_from_numpy(flat, init_train_state(torch.Generator(), cfg,
                                                  opt_cfg))


def run(rank: int, directory: str) -> None:
    signal.alarm(RANK_TIMEOUT_S)      # a hung collective ends the rank
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    store = dist.FileStore(os.path.join(directory, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_local_mesh(*MESH, device="cpu")
        results, placements = {}, {}
        for case, (sp, optimizer) in TRAIN_CASES.items():
            got, placements[case] = _train(_state(directory, optimizer),
                                           mesh, sp, optimizer)
            results.update((f"{case}/{k}", v) for k, v in got.items())
        params = _state(directory, "adamw")["params"]
        results.update((f"serve/{k}", v)
                       for k, v in _serve(params, mesh).items())
        results.update((f"mutant/{k}", v)
                       for k, v in _mutant_prefill(params, mesh).items())
        for case, p in placements.items():
            results.update((f"{case}/placements/{k}", np.array(v))
                           for k, v in p.items())
        if rank == 0:
            np.savez(os.path.join(directory, "results.npz"), **results)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(directory: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(run, args=(directory,), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
