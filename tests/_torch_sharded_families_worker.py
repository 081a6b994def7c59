"""The RWKV6, hybrid, MoE and stub-frontend families on a 2 x 2 (data,
model) mesh of four gloo processes on the CPU, for
``tests/test_torch_sharding_families.py``.

  python tests/_torch_sharded_families_worker.py DIR

reads ``DIR/state_<case>.npz`` (a reduced fp32 train state of each case
in the checkpoint layout), spawns four ranks that meet through a
``FileStore`` in DIR, and runs every case of ``CASES`` on every rank (a
collective that one rank skips would hang the others):

* ``train``: ``STEPS`` train steps of the state laid out by
  ``state_specs``, the batch by ``batch_specs``, with the config's own
  optimizer (arctic-480b's Adafactor);
* ``serve``: a prefill of ``PROMPT`` positions (token ids, or a stub
  frontend's embeddings) and ``DECODE`` greedy decode steps on
  ``param_specs(mode="serve")``; after the prefill and after each step
  every cache and recurrent state is read whole, and its placements are
  checked against ``cache_specs``';
* mutants: rwkv6-3b's and hymba-1.5b's serving with the recurrences' final
  states not written back from ``local_map``'s temporary
  (``ops.write_back`` a no-op), and moonshot's flat dispatch at cf 1.25
  ranked on each rank's own tokens (``moe._rank_offsets`` zero).

Every kernel wrapper is wrapped to count its calls and to fail on a
DTensor (``counting``): the kernels, and on the CPU their plain versions,
see only local shards. Rank 0 writes each case's full tensors to
``DIR/results.npz``. It imports no JAX; the test compares these results
with the unsharded port and JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.bridge import flatten_tree as flat_tree  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

WORLD, MESH = 4, (2, 2)
STEPS, TRAIN_SHAPE = 2, ShapeConfig("t", "train", 16, 4)
PROMPT, DECODE = 11, 3
RANK_TIMEOUT_S = 300
ADAM_EPS = 1e-3

# case: (arch, fields replaced in its reduced config (MoE: the reduced
# drop-free capacity unless given), MoE dispatch groups); a moonshot case
# with 2 groups runs the group-local dispatch, one group on each data
# rank; hymba with one KV head has its K/V cache sharded on hd (the head
# does not divide) and its attention heads whole on every rank
CASES = {"rwkv6": ("rwkv6-3b", {}, 1),
         "hymba": ("hymba-1.5b", {}, 1),
         "hymba_kv1": ("hymba-1.5b", {"n_kv_heads": 1}, 1),
         "moonshot": ("moonshot-v1-16b-a3b", {}, 1),
         "moonshot_cf": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.25},
                         1),
         "moonshot_grouped": ("moonshot-v1-16b-a3b",
                              {"capacity_factor": 1.25}, 2),
         "arctic": ("arctic-480b", {}, 1),
         "pixtral": ("pixtral-12b", {}, 1)}
# mutant: (case, what it breaks)
MUTANTS = {"rwkv6": "write_back", "hymba": "write_back",
           "moonshot_cf": "rank_offsets"}


def configs(case: str):
    """(model config, optimizer config) of a case: the reduced arch in
    fp32. AdamW's eps is ``ADAM_EPS``: with the default 1e-8 its first
    steps move an element by about lr x sign(g), so an element whose
    gradient is rounding noise (two paths that sum in different orders
    give it either sign) moves by up to 2 lr either way, and the updated
    parameters could not be held to 1e-4; with eps above that noise the
    update is a smooth function of the gradient."""
    arch, fields, _ = CASES[case]
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype="float32",
                              **fields)
    return cfg, topt.OptConfig(name=cfg.optimizer, warmup_steps=2,
                               total_steps=10, lr=1e-2, eps=ADAM_EPS)


def prompt(cfg) -> np.ndarray:
    """(B, PROMPT + DECODE) ids, or embeddings (scale 0.02, as
    train/data.py makes them) of which a stub frontend's decode steps
    take the last DECODE positions."""
    rng = np.random.default_rng(3)
    shape = (4, PROMPT + DECODE)
    if cfg.embedding_stub:
        return (rng.standard_normal(shape + (cfg.d_model,))
                * 0.02).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape, dtype=np.int64)


def decode_input(cfg, prompts: torch.Tensor, logits: torch.Tensor,
                 step: int) -> torch.Tensor:
    """Decode step ``step``'s input: the greedy ids, or the stub
    frontend's next embeddings."""
    if cfg.embedding_stub:
        return prompts[:, PROMPT + step]
    return logits.argmax(-1)


@contextlib.contextmanager
def moe_groups(n: int):
    from repro_torch.sharding import ctx
    ctx.set_moe_groups(n)
    try:
        yield
    finally:
        ctx.set_moe_groups(1)


@contextlib.contextmanager
def counting():
    """Each kernel wrapper counts its calls in the yielded dict and raises
    on a DTensor argument."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import decode_attention, flash_attention, \
        mamba_scan, wkv6
    modules = {"flash_attention": flash_attention,
               "decode_attention": decode_attention, "wkv6": wkv6,
               "mamba_scan": mamba_scan}
    counts = dict.fromkeys(modules, 0)
    real = {name: getattr(m, name) for name, m in modules.items()}

    def guarded(name):
        def call(*args, **kwargs):
            if any(isinstance(a, DTensor) for a in args):
                raise AssertionError(f"{name}: a DTensor reached the "
                                     f"kernel wrapper")
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name, m in modules.items():
        setattr(m, name, guarded(name))
    try:
        yield counts
    finally:
        for name, m in modules.items():
            setattr(m, name, real[name])


def misplaced(tree: dict, specs: dict, mesh) -> list:
    """The leaves of DTensor ``tree`` not laid out by ``specs``."""
    from repro_torch.sharding.rules import to_placements
    want = flat_tree(specs)
    return [f"{k}: {tuple(v.placements)}"
            for k, v in flat_tree(tree).items()
            if tuple(v.placements) != to_placements(want[k], mesh)]


def _train(case: str, state, mesh) -> dict:
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.sharding import ctx, rules
    from repro_torch.train import data
    from repro_torch.train.train_step import to_device, train_step, whole
    cfg, opt_cfg = configs(case)
    ctx.set_axes(*ctx.axes_from_mesh(mesh))
    specs = rules.state_specs(state, mesh)
    state = rules.shard_tree(state, specs, mesh)
    out = {}
    with moe_groups(CASES[case][2]), counting() as counts:
        for step in range(STEPS):
            batch = to_device(data.synth_batch(cfg, TRAIN_SHAPE, step), "cpu")
            batch = rules.shard_tree(batch, rules.batch_specs(batch, mesh),
                                     mesh)
            state, m = train_step(state, batch, cfg, opt_cfg)
            out[f"loss/{step}"] = m["loss"].numpy()
            out[f"grad_norm/{step}"] = m["grad_norm"].numpy()
    out["misplaced"] = np.array(misplaced(
        {k: state[k] for k in ("params", "opt")},
        {k: specs[k] for k in ("params", "opt")}, mesh), dtype=str)
    out.update((f"calls/{k}", np.array(v)) for k, v in counts.items())
    params = topt.tree_map(whole, state["params"])
    out.update((f"params/{k}", v) for k, v in tree_to_numpy(params).items())
    ctx.clear()
    return out


def serve(case: str, params, mesh=None) -> dict:
    """The prefill and DECODE decode steps: {"logits/i", "ids/i",
    "cache/i/<leaf>", "calls/<kernel>"}, and under a mesh "misplaced/i",
    the cache leaves not laid out by ``cache_specs``. Unsharded (no mesh)
    it is the test's reference run."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import whole
    cfg, _ = configs(case)
    key = "embeds" if cfg.embedding_stub else "tokens"
    prompts = torch.from_numpy(prompt(cfg))
    if mesh is not None:
        ctx.set_axes(*ctx.axes_from_mesh(mesh))
        params = rules.shard_tree(params, rules.param_specs(
            params, mesh, mode="serve"), mesh)

    def fed(tree):
        if mesh is None:
            return tree
        return rules.shard_tree(tree, rules.batch_specs(tree, mesh), mesh)

    def record(step, caches):
        for name, leaf in flat_tree(caches).items():
            out[f"cache/{step}/{name}"] = whole(leaf).clone().numpy()
        if mesh is not None:
            out[f"misplaced/{step}"] = np.array(misplaced(
                caches, rules.cache_specs(caches, mesh), mesh), dtype=str)

    out = {}
    with torch.no_grad(), moe_groups(CASES[case][2]), counting() as counts:
        logits, caches, pos = prefill(params, cfg, fed(
            {key: prompts[:, :PROMPT]}))
        caches = preallocate_cache(cfg, caches, PROMPT + DECODE)
        record(0, caches)
        for step in range(DECODE + 1):
            out[f"logits/{step}"] = whole(logits).numpy()
            if step == DECODE:
                break
            x = decode_input(cfg, prompts, whole(logits), step)
            out[f"ids/{step}"] = whole(logits).argmax(-1).numpy()
            step_in = fed({"x": x, "p": pos + step})
            logits, caches = decode_step(params, cfg, step_in["x"], caches,
                                         step_in["p"])
            record(step + 1, caches)
    out.update((f"calls/{k}", np.array(v)) for k, v in counts.items())
    ctx.clear()
    return out


@contextlib.contextmanager
def mutant(what: str):
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    if what == "write_back":
        target, name = ops, "write_back"
        broken = lambda state, final: state  # noqa: E731
    else:
        target, name = moe, "_rank_offsets"
        broken = lambda counts, mesh, rank: torch.zeros_like(counts)  # noqa
    real = getattr(target, name)
    setattr(target, name, broken)
    try:
        yield
    finally:
        setattr(target, name, real)


def state_of(directory: str, case: str) -> dict:
    from repro_torch.bridge import tree_from_numpy
    from repro_torch.train.train_step import init_train_state
    cfg, opt_cfg = configs(case)
    flat = np.load(os.path.join(directory, f"state_{case}.npz"))
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
        results = {}
        for case in CASES:
            got = _train(case, state_of(directory, case), mesh)
            results.update((f"{case}/train/{k}", v) for k, v in got.items())
            params = state_of(directory, case)["params"]
            got = serve(case, params, mesh)
            results.update((f"{case}/serve/{k}", v) for k, v in got.items())
            if case in MUTANTS:
                with mutant(MUTANTS[case]):
                    got = serve(case, params, mesh)
                results.update((f"{case}/mutant/{k}", v)
                               for k, v in got.items() if "logits" in k)
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
