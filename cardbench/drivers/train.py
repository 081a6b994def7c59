"""A closed loop of optimizer steps through
``repro_torch.train.train_step.train_step``.

Set-up makes the weights and AdamW's state from the seed and drives the
first ``checked_steps`` steps through the same call and the same feed as
the window, on batches of their own; they warm every shape up, and what
they produce is what the reference is compared with: each step's loss,
the first step's clipped gradient (AdamW's m after one step over 1 - b1)
and the parameters' change over those steps, leaf by leaf. The window
then runs whole steps until ``seconds`` have passed, making each next
batch on the host while the step runs; it ends when the last step is done
on the device.
"""

from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from .. import bounds, check, traffic, weights
from ..reference import train as ref_train
from . import free, log, sync


def _grad_norms(opt_state: dict, b1: float) -> dict:
    """The first step's clipped gradient, leaf by leaf, from AdamW's first
    moment after one step: m = (1 - b1) g."""
    return {k: float(v.norm()) / (1 - b1) for k, v in
            weights.flat_leaves(opt_state["m"]).items()}


def _changes(cell, seed: int, params: dict, device) -> dict:
    start = weights.flat_leaves(weights.make(cell, seed, device))
    return {k: float((p.float() - start[k].float()).norm())
            for k, p in weights.flat_leaves(params).items()}


def prepare(cell, seed: int, device):
    """Set-up's program side: the weights, AdamW's state and the checked
    steps. Returns (step, state, prog): ``step(i)`` runs the train step
    on batch i through the window's own call and feed and returns its
    metrics; ``prog`` holds what the checked steps produced."""
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import train_step
    cfg, m, mix = cell.arch(), cell.model, cell.mix
    opt_cfg = OptConfig(**mix["optimizer"])
    params = weights.make(cell, seed, device)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg),
             "step": 0}
    prog: dict = {"loss": []}

    def step(i: int):
        with record_function("cardbench.batch"):
            batch = traffic.train_batch(mix, m.vocab_size, seed, i)
        with record_function("cardbench.train_step"):
            return train_step(state, batch, cfg, opt_cfg)[1]

    for i in range(mix["checked_steps"]):
        prog["loss"].append(step(i)["loss"])
        if i == 0:
            prog["grad"] = _grad_norms(state["opt"], opt_cfg.b1)
    prog["loss"] = [float(x) for x in prog["loss"]]
    prog["change"] = _changes(cell, seed, state["params"], device)
    log(f"set-up: {mix['checked_steps']} checked steps, losses "
        f"{prog['loss']}")
    return step, state, prog


def reference(cell, seed: int, device, **kwargs) -> dict:
    """The reference's checked steps (``reference.train.steps``)."""
    t = time.perf_counter()
    n = cell.mix["checked_steps"]
    ref = ref_train.steps(cell, seed, device, n, **kwargs)
    log(f"reference: {n} steps in {time.perf_counter() - t:.1f} s, losses "
        f"{ref['loss']}")
    return ref


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    from .. import trace as tracing
    m, mix = cell.model, cell.mix
    step, state, prog = prepare(cell, seed, device)

    sync(device)
    t0 = time.perf_counter()
    i, losses = mix["checked_steps"], []
    while True:
        losses.append(step(i)["loss"])
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    log(f"window: {i - mix['checked_steps']} steps in {window_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    traced = None
    if trace:
        t = time.perf_counter()
        traced = tracing.capture(lambda: step(i), 1, device)
        log(f"trace: {traced.kernels} kernels, read in "
            f"{time.perf_counter() - t:.1f} s")
    failed = sum(not math.isfinite(float(x)) for x in losses)
    del step, state, losses
    free(device)
    ref = reference(cell, seed, device)
    tokens = mix["sequences"] * mix["seq_len"]
    return {"setup_s": t0 - started, "window_s": window_s,
            "units": i - mix["checked_steps"], "attempted":
            i - mix["checked_steps"], "failed": failed,
            "tokens": tokens * (i - mix["checked_steps"]),
            "unit_bound_s": bounds.train_bound(m, mix["sequences"],
                                               mix["seq_len"])[0],
            "peak_bytes": peak, "trace": traced,
            "numbers": check.train_numbers(prog, ref), "model": m,
            "kind": "train"}
