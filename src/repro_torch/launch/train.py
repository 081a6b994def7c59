"""End-to-end training driver with the LeaseGuard control plane, ported
from ``repro.launch.train``.

Every run:
  * registers with the cluster registry (membership),
  * restores from the latest **committed** checkpoint manifest (leased
    zero-roundtrip read) if one exists,
  * trains with the microbatched ``train_step``,
  * reports per-step times (straggler table) and heartbeats,
  * commits a checkpoint manifest through the Raft log every
    ``--ckpt-every`` steps and at the end,
  * optionally injects a coordinator-leader crash mid-run (--failover-at)
    to show that training does not block on coordinator failover.

It runs on the card unless the caller asks for the CPU, and raises
without a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny \\
      --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \\
      --depth 9

``--depth`` trains the first N layers of ``--arch`` at full width: a
model whose state (16 bytes a parameter with AdamW) does not fit one card,
such as pixtral-12b's 40 layers (193 GB), is cut in depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get_arch
from ..configs.base import ArchConfig, ShapeConfig
from ..coord.registry import ClusterRegistry
from ..serve.engine import resolve_device
from ..train.checkpoint import restore_checkpoint, save_checkpoint
from ..train.data import DataIterator
from ..train.optimizer import OptConfig
from ..train.train_step import init_train_state, to_device, train_step

PRESETS = {
    "tiny": ArchConfig(
        name="tiny-12m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=4096,
        grad_accum=1, param_dtype="float32"),
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2304, vocab_size=32000,
        grad_accum=1, param_dtype="float32"),
}


def run_training(cfg: ArchConfig, shape: ShapeConfig, steps: int,
                 ckpt_dir: str, ckpt_every: int = 20,
                 registry: ClusterRegistry | None = None,
                 worker_id: str = "worker-0",
                 failover_at: int | None = None,
                 log_every: int = 5, device="cuda") -> dict:
    device = resolve_device(device)
    registry = registry or ClusterRegistry()
    registry.register_worker(worker_id, {"arch": cfg.name})

    # warmup proportional to short runs: a 40-step demo should not spend
    # half its budget below full LR
    opt_cfg = OptConfig(name=cfg.optimizer,
                        warmup_steps=min(20, max(2, steps // 10)),
                        total_steps=max(steps, 100))
    latest = registry.latest_checkpoint()
    state = init_train_state(torch.Generator(device).manual_seed(0), cfg,
                             opt_cfg)
    if latest is not None and latest["extra"].get("arch") == cfg.name:
        state = restore_checkpoint(state, latest)
        start_step = int(latest["step"])
        print(f"[train] resumed from committed step {start_step} "
              f"(leased read, zero roundtrips)")
    else:
        start_step = 0

    data = DataIterator(cfg, shape, start_step=start_step)
    losses = []
    for step in range(start_step, steps):
        batch = to_device(next(data), device)
        t0 = time.time()
        state, metrics = train_step(state, batch, cfg, opt_cfg)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        registry.report_step_time(worker_id, step, dt)
        registry.heartbeat(worker_id)   # feeds live_workers(ttl=...)
        if failover_at is not None and step == failover_at:
            crashed = registry.coord.crash_leader()
            print(f"[train] coordinator leader {crashed} crashed at step "
                  f"{step}; training continues through failover")
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt:.2f}s)", flush=True)
        if (step + 1) % ckpt_every == 0 or step == steps - 1:
            manifest = save_checkpoint(
                ckpt_dir, step + 1, state,
                extra={"arch": cfg.name, "data": data.state()},
                registry=registry)
            print(f"[train] checkpoint step {step+1} committed via Raft "
                  f"(sha {manifest['sha256'][:10]})")
    stats = registry.coord.stats()
    print(f"[train] coordinator stats: {stats}")
    flags = registry.straggler_flags()
    if any(flags.values()):
        print(f"[train] stragglers flagged: {flags}")
    return {"losses": losses, "state": state, "registry": registry}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of --arch")
    ap.add_argument("--depth", type=int, default=None,
                    help="layers of --arch to train (default: all)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--failover-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.preset:
        cfg = PRESETS[args.preset]
    elif args.arch:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
        if args.depth is not None:
            if not 0 < args.depth <= cfg.n_layers:
                ap.error(f"--depth {args.depth}: {cfg.name} has "
                         f"{cfg.n_layers} layers")
            cfg = dataclasses.replace(cfg, n_layers=args.depth)
    else:
        cfg = PRESETS["tiny"]
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    return run_training(cfg, shape, args.steps, args.ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        failover_at=args.failover_at, device=args.device)


if __name__ == "__main__":
    main()
