#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, metrics and limits are files under
``cardbench/``, found by the names ``BENCHMARK.json`` gives (see
``spec.py`` and ``README.md``). With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, the
device's busy and traced seconds and a breakdown. Every run checks what
the program produced against the plain reference and prints the numbers
compared, each beside its limit, last on standard error and last in the
result. Without a card, with fewer cards than the cell asks for, or when
a module of JAX or of the JAX package was loaded, it exits non-zero and
prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# no module of these top-level names may be loaded in the process that
# prints a result: the port runs without JAX and without the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Kernel and compile caches at fixed paths inside the checkout; the
    port and this package importable."""
    cache = ROOT / "build" / "cardbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules(names=None) -> list:
    """The top-level names among ``names`` (the loaded modules' unless
    given) that are one of FORBIDDEN, compared whole: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device="cuda", started: float = STARTED) -> dict:
    """One run of ``cell`` (a ``spec.Cell``): its result line as a dict."""
    import torch

    from cardbench import check, spec
    driver = importlib.import_module(f"cardbench.drivers.{cell.mix['kind']}")
    run = driver.run(cell, seed, seconds, trace, device, started)
    entries = cell.per_layer if trace else cell.end_to_end
    dev = torch.device(device)
    metrics = {}
    for entry in entries:
        value = spec.reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        elif not trace and dev.type == "cuda":
            raise RuntimeError(f"{cell.name}: no {entry['name']} to read")
    ok, shown = check.verdict(run["numbers"], cell.limits)
    result = {
        "correct": ok and run["failed"] == 0,
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu",
            "count": 1,
            "memory_peak_bytes": run["peak_bytes"],
        },
    }
    if trace:
        result["device"].update(busy_s=run["trace"].busy_s,
                                window_s=run["trace"].window_s)
        result["breakdown"] = run["trace"].breakdown()
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from cardbench import spec
    import torch
    bench = spec.read_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"{args.workload} needs {chips[args.workload]} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
