"""Multi-pod dry run: build and count every (arch x shape x mesh) cell
without allocating. Ported from ``repro.launch.dryrun``.

JAX lowers and compiles each cell on 512 forced host devices and reads
the compiled program. The port has nothing to compile: for every cell it

  1. builds the inputs (``input_specs``) and the state, parameters or
     caches as meta tensors (``init_params`` and the rest take a meta
     ``device`` with a CPU generator), laid out as meta DTensors on the
     production mesh by the sharding rules (``lower_cell``);
  2. runs the whole step (``train_step`` with all its microbatches,
     ``prefill`` or ``decode_step``) on them under
     ``roofline.RooflineCounter``, on the ``fake`` process group
     (``launch/mesh.py``): every rank's local shard has its shape and
     holds no data, the kernels run their operators' fake
     implementations, and DTensor's collectives move nothing. All layers
     run: on a mesh they are not all alike (DTensor's placements can
     differ from layer to layer, and a serving cell's placements follow
     its full size), so one layer's count does not stand for the rest;
  3. reports, per device, the flops, HBM bytes, kernel-region bytes and
     link bytes counted on the local shards, their roofline terms on the
     H100 (``roofline_terms``), the local bytes of the arguments and
     outputs and the peak of the storage the step allocates, and the
     placement of each dim that ``model`` does not divide.

The meshes keep JAX's shapes and axis names, so the rules give JAX's
placements; the collective term is optimistic for them (``launch/mesh.py``).
A row has ``run_cell``'s JSON keys, so ``benchmarks/roofline_bench.py``
reads it: ``lower_s`` and ``compile_s`` are the seconds to build the cell
and to run it, and ``xla_cost_flops_uncorrected`` is null.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Callable

import torch

from ..configs import ARCHS, SHAPES, get_arch, get_shape, shape_applicable
from ..configs.base import ArchConfig, ShapeConfig
from ..models import decode_step, init_decode_cache, init_params, prefill
from ..roofline import (RooflineCounter, roofline_terms, storage_bytes,
                        typed_terms)
from ..sharding import ctx as shard_ctx
from ..sharding.rules import (batch_specs, cache_specs, param_specs,
                              shard_tree, state_specs)
from ..train.optimizer import OptConfig
from ..train.train_step import init_train_state, train_step
from .mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_BY_DTYPE,
                   make_dryrun_mesh)


# ------------------------------------------------------------ input specs
def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta stand-ins for every model input of this cell: JAX's shapes and
    dtypes (int32 ids)."""
    b, s = shape.global_batch, shape.seq_len
    i32, meta = torch.int32, "meta"

    def empty(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device=meta)

    if shape.kind in ("train", "prefill"):
        d = {"labels": empty(b, s)} if shape.kind == "train" else {}
        if cfg.embedding_stub:
            d["embeds"] = empty(b, s, cfg.d_model, dtype=torch.float32)
        else:
            d["tokens"] = empty(b, s)
        return d
    # decode: one new token against a seq_len-deep cache
    caches = init_decode_cache(cfg, b, max_len=s, device=meta)
    tok = empty(b, cfg.d_model, dtype=torch.float32) if cfg.embedding_stub \
        else empty(b)
    return {"tokens": tok, "caches": caches, "pos": empty(b)}


def opt_config(cfg: ArchConfig) -> OptConfig:
    return OptConfig(name=cfg.optimizer)


# ------------------------------------------------------------- building
@dataclasses.dataclass
class Cell:
    """One cell's step and its arguments, laid out on the mesh: ``run()``
    runs the step once; ``args`` are its inputs (their storages exist
    before it runs); ``microbatches``: the microbatches one run counts of
    the step's ``grad_accum`` (train), else None."""
    run: Callable
    args: tuple
    microbatches: int = None


def _meta_gen() -> torch.Generator:
    """Initializers draw from a generator: a CPU one (no meta generator
    exists), which a meta draw leaves untouched."""
    return torch.Generator().manual_seed(0)


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Cell:
    """The cell's step on ``mesh`` with its meta inputs, JAX's placements
    and serving choices. Nothing runs yet."""
    dp, tp = shard_ctx.axes_from_mesh(mesh)
    shard_ctx.set_axes(dp, tp, sp=False)
    # JAX's flat dispatch (group-local measured worse under GSPMD)
    shard_ctx.set_moe_groups(1)
    if shape.kind == "train":
        ocfg = opt_config(cfg)
        state = init_train_state(_meta_gen(), cfg, ocfg, device="meta")
        state = shard_tree(state, state_specs(state, mesh), mesh)
        batch = input_specs(cfg, shape)
        batch = shard_tree(batch, batch_specs(batch, mesh), mesh)
        return Cell(lambda: train_step(state, batch, cfg, ocfg),
                    (state, batch), cfg.grad_accum)

    params = init_params(_meta_gen(), cfg, device="meta")
    # serving: TP-only params (no per-token FSDP gathers, JAX's iteration
    # 5) unless the TP-sharded weights alone would blow per-device HBM
    # (arctic-480b: 960 GB bf16 / 16 = 60 GB a device: keep FSDP sharding)
    tp_size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    tp_only_fits = cfg.param_count() * 2 / tp_size < 8e9
    mode = "serve" if (shape.kind == "decode" and tp_only_fits) else "train"
    params = shard_tree(params, param_specs(params, mesh, mode=mode), mesh)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        batch = shard_tree(batch, batch_specs(batch, mesh), mesh)
        return Cell(lambda: prefill(params, cfg, batch), (params, batch))

    spec_in = input_specs(cfg, shape)
    caches = shard_tree(spec_in["caches"],
                        cache_specs(spec_in["caches"], mesh), mesh)
    feed = {"t": spec_in["tokens"], "p": spec_in["pos"]}
    feed = shard_tree(feed, batch_specs(feed, mesh), mesh)
    return Cell(lambda: decode_step(params, cfg, feed["t"], caches,
                                    feed["p"]), (params, caches, feed))


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference,
    plus attention score/value flops."""
    n = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        flops = 6.0 * n * tokens
        if not cfg.attn_free:
            win = cfg.sliding_window or s
            ctx = min(win, s)
            flops += 3 * 4.0 * b * s * ctx / 2 * cfg.n_heads * cfg.hd
        return flops
    if shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n * tokens
        if not cfg.attn_free:
            win = cfg.sliding_window or s
            ctx = min(win, s)
            flops += 4.0 * b * s * ctx / 2 * cfg.n_heads * cfg.hd
        return flops
    # decode: one token each
    flops = 2.0 * n * b
    if not cfg.attn_free:
        ctx = min(cfg.sliding_window or s, s)
        flops += 4.0 * b * ctx * cfg.n_heads * cfg.hd
    return flops


def count(cell: Cell) -> tuple:
    """Run ``cell`` once under a ``RooflineCounter``: (what it counted, its
    peak storage, the arguments' bytes, the outputs' bytes). A train step
    runs under autograd, a serving step under ``no_grad``."""
    counter = RooflineCounter()
    arg_bytes = counter.resident(cell.args)
    grad = torch.enable_grad() if cell.microbatches else torch.no_grad()
    with grad, counter:
        out = cell.run()
    return counter.take(), counter.peak_bytes, arg_bytes, storage_bytes(out)


# ------------------------------------------------------ undivided dims
def undivided_dims(cfg: ArchConfig, mesh, kernels: dict) -> dict:
    """Each dim that the mesh's ``model`` axis does not divide (a head
    count; the Mamba channels where a rank's slice is no multiple of the
    scan kernel's CHANNEL_MULTIPLE): the placement the port gives it, as
    the kernels saw it on this run (their first call's local shapes), and
    its per-rank bytes there, beside ``jax``: the placement that GSPMD
    gives it in the JAX package's compiled dry run on its own mesh, over
    gcd(dim, model) ranks. ``jax`` is this module's statement of that
    rule; ``tests/test_torch_reference_placements.py`` observes it in
    JAX's compiled prefill for arctic-480b's 56 heads (8 ways) and
    hymba-1.5b's 25 heads (whole) and 1600 Mamba channels (16 ways)
    (ROADMAP queue 3, m)."""
    from ..kernels.mamba_scan import CHANNEL_MULTIPLE
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)

    def placement(ways):
        return "replicated over model" if ways == 1 else f"sharded {ways} ways"

    out = {}
    for kname, call in kernels.items():
        shapes = call["shapes"]
        if kname in ("flash_attention", "decode_attention"):
            # q: (B, S, H, hd) or decode's (B, Hkv, grp, hd)
            q = shapes[0]
            heads = q[2] if kname == "flash_attention" else q[1] * q[2]
            kv = shapes[1][2]
            dims = {"n_heads": (cfg.n_heads, heads),
                    "n_kv_heads": (cfg.n_kv_heads, kv)}
            nbytes = math.prod(q) * (2 if cfg.param_dtype == "bfloat16"
                                     else 4)
            multiple = 1
        elif kname == "mamba_scan":
            dims = {"mamba_channels": (cfg.n_heads * cfg.hd, shapes[0][2])}
            nbytes = math.prod(shapes[0]) * (2 if cfg.param_dtype ==
                                             "bfloat16" else 4)
            multiple = CHANNEL_MULTIPLE
        else:
            continue
        if all(g % tp == 0 and (g // tp) % multiple == 0
               for g, _ in dims.values()):
            continue
        for name, (whole, local) in dims.items():
            mine = placement(whole // local)
            jax_side = placement(math.gcd(whole, tp))
            out.setdefault(f"{name}={whole}", {
                "kernel": kname, "model": tp, "per_rank": local,
                "placement": mine, "per_rank_bytes": nbytes,
                "jax": jax_side, "matches_jax": mine == jax_side})
    return out


def run_cell(arch_name: str, shape_name: str, mesh, mesh_name: str,
             verbose: bool = True, arch_override: ArchConfig = None) -> dict:
    cfg = arch_override or get_arch(arch_name)
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    shape_name = shape.name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    t0 = time.time()
    cell = lower_cell(cfg, shape, mesh)
    t_lower = time.time() - t0
    t0 = time.time()
    counter, peak, arg_bytes, out_bytes = count(cell)
    t_run = time.time() - t0
    counts = counter.counts
    n_dev = math.prod(mesh.shape)
    terms = typed_terms(roofline_terms(counts, peak_flops=PEAK_FLOPS_BF16,
                                       hbm_bw=HBM_BW, ici_bw=NVLINK_BW),
                        counter.flops_by_dtype, PEAK_FLOPS_BY_DTYPE)
    mf = model_flops(cfg, shape)
    mf_per_dev = mf / n_dev
    hlo_flops = max(counts.flops, 1.0)
    row = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "n_devices": n_dev,
        "lower_s": round(t_lower, 2), "compile_s": round(t_run, 2),
        # per-device numbers, counted on the local shards
        "hlo_flops_per_dev": counts.flops,
        "hbm_bytes_per_dev": counts.hbm_bytes,
        "kernel_region_bytes_per_dev": counts.kernel_region_bytes,
        "link_bytes_per_dev": counts.link_bytes,
        "n_collectives": counts.n_collectives,
        "collective_breakdown": {k: round(v)
                                 for k, v in counts.collective_breakdown.items()},
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "memory_ref_s": terms["memory_ref_s"],
        "collective_s": terms["collective_s"],
        # each dtype's flops at its own peak (the fp32 recurrences and
        # router at the fp32 rate), and the bound on that term
        "compute_typed_s": terms["compute_typed_s"],
        "bound_typed_s": terms["bound_typed_s"],
        "dominant": terms["dominant"],
        "model_flops_global": mf,
        "useful_flops_ratio": mf_per_dev / hlo_flops,
        "roofline_fraction": min(1.0, (mf_per_dev / PEAK_FLOPS_BF16)
                                 / max(terms["bound_s"], 1e-30)),
        # local bytes of the inputs and outputs, and the peak of the
        # storage the step allocates (per device)
        "arg_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": peak,
        "xla_cost_flops_uncorrected": None,
        "flops_by_dtype": counter.flops_by_dtype,
        "flops_by_region": counter.flops_by_region,
        "kernel_calls": {k: v["calls"] for k, v in counter.kernels.items()},
        "undivided_dims": undivided_dims(cfg, mesh, counter.kernels),
    }
    if shape.kind == "train":
        row["microbatches_counted"] = cfg.grad_accum
    if verbose:
        hbm_gib = (row["arg_bytes"] + row["temp_bytes"]) / 2**30
        print(f"[{arch_name} × {shape_name} × {mesh_name}] run "
              f"{t_run:.1f}s | args+temp {hbm_gib:.2f} GiB/dev | "
              f"compute {terms['compute_s']*1e3:.2f}ms "
              f"memory {terms['memory_s']*1e3:.2f}ms "
              f"collective {terms['collective_s']*1e3:.2f}ms "
              f"-> {terms['dominant']} | roofline "
              f"{row['roofline_fraction']:.2%}", flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON rows")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    rows = []
    t_all = time.time()
    for multi in meshes:
        mesh = make_dryrun_mesh(multi_pod=multi)
        mesh_name = "2x16x16" if multi else "16x16"
        for a in archs:
            for s in shapes:
                try:
                    row = run_cell(a, s, mesh, mesh_name)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    row = {"arch": a, "shape": s, "mesh": mesh_name,
                           "status": "error", "error": repr(e)[:500]}
                    print(f"[{a} × {s} × {mesh_name}] ERROR: {e}", flush=True)
                rows.append(row)
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    fn = f"{row['arch']}_{row['shape']}_{row['mesh']}.json"
                    with open(os.path.join(args.out, fn), "w") as f:
                        json.dump(row, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = len(rows) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} "
          f"errors in {time.time() - t_all:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
