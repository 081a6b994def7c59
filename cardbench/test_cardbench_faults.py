"""The check fails what it must: the harness's run on the CPU, with the
timed path broken underneath, comes out not correct against each cell's
limits, and so does the control, the reference computed with float8
products in the program's place. A sound run of the same tiny cell comes
out correct, so the fault is what fails it."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

import repro_torch.serve.engine as engine_mod
import repro_torch.train.train_step as ts
from cardbench import check, readings, run as cb_run, spec, tiny
from cardbench.drivers import free, prefill, train
from cardbench.reference import model as ref

BENCH = spec.read_json(spec.ROOT / "BENCHMARK.json")
TRAIN = [w["name"] for w in BENCH["workloads"]
         if spec.load_cell(w["name"]).mix["kind"] == "train"]
SERVE = [w["name"] for w in BENCH["workloads"]
         if spec.load_cell(w["name"]).mix["kind"] == "prefill"]


def unchanged(state, batch, cfg, opt_cfg, impl="kernel"):
    """A train step that returns its state unchanged."""
    loss = torch.tensor(float(torch.log(torch.tensor(cfg.vocab_size))))
    return state, {"loss": loss, "grad_norm": torch.tensor(1.0)}


def half_batch(state, batch, cfg, opt_cfg, impl="kernel"):
    """A train step that leaves out the second half of the batch and
    takes the mean over the rest."""
    rows = next(iter(batch.values())).shape[0] // 2
    return REAL_STEP(state, {k: v[:rows] for k, v in batch.items()}, cfg,
                     opt_cfg, impl)


REAL_STEP = ts.train_step
REAL_GENERATE = engine_mod.Engine.generate
REAL_PREALLOCATE = engine_mod.preallocate_cache


def altered(self, tokens, max_new_tokens=None):
    """The engine's answer with its token altered where it is produced."""
    ids = REAL_GENERATE(self, tokens, max_new_tokens)
    return (ids + 1) % self.cfg.vocab_size


def ring_not_copied(cfg, caches, total_len):
    """Decode caches whose K/V ring the prompt's K/V never reached."""
    out = REAL_PREALLOCATE(cfg, caches, total_len)
    for t in out["kv"].values():
        t.zero_()
    return out


def ring_one_slot_off(cfg, caches, total_len):
    """Each position's K/V written one slot past its own."""
    out = REAL_PREALLOCATE(cfg, caches, total_len)
    for t in out["kv"].values():
        t.copy_(t.roll(1, dims=2))
    return out


def scan_state_dropped(cfg, caches, total_len):
    """A hybrid's final scan state left at zero."""
    out = REAL_PREALLOCATE(cfg, caches, total_len)
    out["mamba"]["h"].zero_()
    return out


def _run(workload):
    return cb_run.run_cell(tiny.cell(workload), 21, 0.2, False, "cpu")


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", TRAIN)
def test_broken_train_step_is_not_correct(workload, fault):
    with mock.patch.object(ts, "train_step", fault):
        result = _run(workload)
    assert not result["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_altered_token_is_not_correct(workload):
    with mock.patch.object(engine_mod.Engine, "generate", altered):
        result = _run(workload)
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] \
        > result["checks"]["logit_gap"]["limit"]


HYBRID = [w for w in SERVE if spec.load_cell(w).model.hybrid_ssm]


@pytest.mark.parametrize("fault, number", [(ring_not_copied, "kv_err"),
                                           (ring_one_slot_off, "kv_err")],
                         ids=["ring_not_copied", "ring_one_slot_off"])
@pytest.mark.parametrize("workload", SERVE)
def test_broken_decode_state_is_not_correct(workload, fault, number):
    with mock.patch.object(engine_mod, "preallocate_cache", fault):
        result = _run(workload)
    assert not result["correct"]
    assert result["checks"][number]["value"] \
        > result["checks"][number]["limit"]


@pytest.mark.parametrize("workload", HYBRID)
def test_dropped_scan_state_is_not_correct(workload):
    with mock.patch.object(engine_mod, "preallocate_cache",
                           scan_state_dropped):
        result = _run(workload)
    assert not result["correct"]
    assert result["checks"]["ssm_err"]["value"] \
        > result["checks"]["ssm_err"]["limit"]


SEEDS = (31, 32, 33)


def _fails(numbers: dict, limits: dict) -> bool:
    return not check.verdict(numbers, limits)[0]


@pytest.mark.parametrize("workload", TRAIN)
def test_control_fails_a_train_limit(workload):
    """float8 products, residual stream and microbatch gradients in the
    program's place, bf16 weights as the cell stores them, at the test's
    wider size: a number over its limit on most seeds (on the card, at
    the cell's size, on every seed of three)."""
    cell = tiny.cell(workload, "bfloat16", tiny.WIDER)
    failed = [_fails(check.train_numbers(
        train.reference(cell, seed, "cpu", prec=ref.FP8),
        train.reference(cell, seed, "cpu")), cell.limits)
        for seed in SEEDS]
    assert sum(failed) >= 2, failed


@pytest.mark.parametrize("workload", SERVE)
def test_control_fails_a_served_limit(workload):
    """The control as ``readings.control_numbers`` reads it, in the
    program's place: the token float8 puts first at the last position,
    its logits there, and its K/V ring and Mamba states."""
    cell = tiny.cell(workload, "bfloat16", tiny.WIDER)
    failed = []
    for seed in SEEDS:
        checked = prefill.sample(cell.mix, seed)
        serve = prefill.Served(cell, seed, "cpu", checked)
        for i in checked:
            serve(i, prefill.length_of(cell.mix, seed, i))
        states = serve.kept(checked)[2]
        serve.close()
        failed.append(_fails(readings.control_numbers(
            cell, seed, "cpu", checked, states), cell.limits))
    free("cpu")
    assert all(failed), failed
