#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size, many seeds in one process.

    python3 cardbench/readings.py --workload <name> --seeds 1,2,3 \
        [--control 3]

For each seed: the program's numbers, as a run's check computes them
from what set-up's checked steps or the checked batches produce (the
lower reading is the largest over the seeds). For the first ``--control``
seeds also the control, the reference computed with float8 e4m3 matrix
products in the program's place (``reference.model.FP8``), and a fault:
for a training cell the one that leaves out half of every batch, for a
served cell each served token altered (the upper reading is the smallest
over the seeds). A served cell's control is read as a run reads the
program: the token float8 puts first at the last position of each checked
prompt, its logits there, and its K/V ring and Mamba states. One JSON
line a reading, then a summary.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from cardbench import check, spec, weights  # noqa: E402
from cardbench.drivers import free, prefill, train  # noqa: E402
from cardbench.reference import model as ref  # noqa: E402


def train_readings(cell, seed: int, device, control: bool) -> list:
    step, state, prog = train.prepare(cell, seed, device)
    del step, state
    free(device)
    want = train.reference(cell, seed, device)
    for what in ("grad", "change"):
        print(json.dumps({"seed": seed, "worst " + what:
                          check.worst_leaves(prog, want, what)}),
              file=sys.stderr, flush=True)
    out = [("program", check.train_numbers(prog, want))]
    if control:
        out.append(("control fp8", check.train_numbers(
            train.reference(cell, seed, device, prec=ref.FP8), want)))
        out.append(("fault half batch", check.train_numbers(
            train.reference(cell, seed, device, half_batch=True), want)))
    return out


@torch.no_grad()
def control_numbers(cell, seed: int, device, checked: list,
                    states: list) -> dict:
    """The float8 reference in the program's place, against the fp32
    one, over the checked prompts: its served token is the one it puts
    first at the last position, its state the ring its K and V fill at
    the program's ring size (``states``, the program's, give the size)."""
    logits32, logits8, worst = [], [], {}
    for (j, r, l32, s32), (_, _, l8, s8) in zip(
            prefill.reference_rows(cell, seed, device, checked),
            prefill.reference_rows(cell, seed, device, checked, ref.FP8)):
        logits32.append(l32.cpu())
        logits8.append(l8.cpu())
        slots = states[j]["k"].shape[2]
        got = {n: torch.stack([check.ring(layer[n], slots) if n in ("k", "v")
                               else layer[n] for layer in s8])
               for n in s8[0]}
        for k, v in check.state_numbers(got, s32).items():
            worst[k] = max(worst.get(k, 0.0), v)
    got8 = torch.stack(logits8)
    worst.update(check.served_numbers(got8, got8.argmax(-1),
                                      torch.stack(logits32)))
    return worst


def prefill_readings(cell, seed: int, device, control: bool) -> list:
    checked = prefill.sample(cell.mix, seed)
    serve = prefill.Served(cell, seed, device, checked)
    for i in checked:
        serve(i, prefill.length_of(cell.mix, seed, i))
    logits, tokens, states = serve.kept(checked)
    serve.close()
    del serve
    free(device)
    want, numbers = prefill.reference(cell, seed, device, checked, states)
    numbers.update(check.served_numbers(logits, tokens, want))
    out = [("program", numbers)]
    if control:
        out.append(("control fp8", control_numbers(cell, seed, device,
                                                   checked, states)))
        out.append(("fault altered token", check.served_numbers(
            logits, (tokens + 1) % cell.model.vocab_size, want)))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    read = {"train": train_readings,
            "prefill": prefill_readings}[cell.mix["kind"]]
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for n, seed in enumerate(seeds):
        for side, numbers in read(cell, seed, args.device,
                                  n < args.control):
            rows.append((side, numbers))
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **numbers}), flush=True)
        free(args.device)
    summary = {}
    for side, numbers in rows:
        agg = max if side == "program" else min
        for k, v in numbers.items():
            key = f"{side}: {k}"
            summary[key] = agg(summary.get(key, v), v)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
