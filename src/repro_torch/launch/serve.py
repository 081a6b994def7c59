"""Serving entry point: random weights from a seed, one batch of random
prompts, greedy (or sampled) generation through the CUDA kernels
(attention, RWKV6's WKV recurrence, or a hybrid's attention and Mamba
scan), for any config the Engine serves (dense, MoE, RWKV6, hybrid; not
the stub-frontend configs, which take embeddings).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 4 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --requests 4 --prompt-len 1024 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --requests 4 --prompt-len 512 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --requests 4 --prompt-len 4096 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --preset tiny --device cpu

The served model version is read from a coordinator with the read policy
of ``--consistency`` (a leased read under ``leaseguard``); a fresh-init
manifest is committed to it first, and its message counts are printed.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_arch
from ..consistency import benchmark_configs
from ..coord.registry import ClusterRegistry
from ..kernels import ops
from ..models import init_params
from ..serve.engine import Engine, ServeConfig, resolve_device
from .train import PRESETS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced same-family config")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--consistency", default="leaseguard",
                    choices=sorted(benchmark_configs(variants=False)),
                    help="coordination read policy for model-version reads")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
    else:
        cfg = PRESETS[args.preset]
    device = resolve_device(args.device)
    registry = ClusterRegistry(consistency=args.consistency)
    registry.commit_checkpoint({"step": 0, "path": "(fresh init)",
                                "sha256": "0" * 64, "n_arrays": 0,
                                "extra": {"arch": cfg.name}})
    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=args.max_new,
                                             temperature=args.temperature),
                    registry=registry, device=device)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.requests, args.prompt_len), device=device,
                            generator=torch.Generator(device).manual_seed(1))
    ops.reset_launches()
    out = engine.generate(prompts)
    launches = ops.launch_counts()
    st = engine.stats
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name} on {name}: served {args.requests} requests, "
          f"generated {out.shape[1]} tokens each ({out.size} in all); "
          f"prefill {st['prefill_ms']:.3f} ms, decode "
          f"{st['decode_ms_per_token']:.3f} ms/token; kernel launches: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()))
    stats = registry.coord.stats()
    print(f"model version: step {engine.model_version['step']}; "
          f"coordinator stats: {stats}")
    return {"ids": out, **st, **launches, "coordinator": stats}


if __name__ == "__main__":
    main()
