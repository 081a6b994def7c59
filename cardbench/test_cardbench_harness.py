"""The harness on the CPU: its files load, its traffic repeats for a seed,
its reference agrees with the port at a tiny size, its last line has the
contract's keys, and a run loads no module of JAX or the JAX package."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cardbench import run as cb_run
from cardbench import check, spec, tiny, traffic, weights
from cardbench.drivers import prefill

BENCH = spec.read_json(spec.ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BIG_SEED = 2**31 + 12345


def test_benchmark_file_is_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_files_load(workload):
    c = spec.load_cell(workload)
    assert c.mix["kind"] in ("train", "prefill")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gb"}
    assert c.per_layer and c.limits
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    cfg = c.arch()
    assert cfg.hd == c.model.hd and cfg.n_layers == c.model.n_layers


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_is_as_run(config):
    data = spec.read_json(spec.ROOT / config["file"])
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(data["model"]) <= set(spec.MODEL_DEFAULTS) | {
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size"}


def test_length_cycle_repeats_for_a_seed():
    mix = spec.load_cell("hymba-1.5b.prefill-long").mix
    want = sorted(n for n, t in mix["lengths"] for _ in range(t))
    for cycle in range(5):
        got = traffic.length_cycle(mix, BIG_SEED, cycle)
        assert sorted(got) == want
        assert got == traffic.length_cycle(mix, BIG_SEED, cycle)
    orders = {tuple(traffic.length_cycle(mix, BIG_SEED, c))
              for c in range(6)}
    assert len(orders) > 1


def test_batches_repeat_for_a_seed():
    mix = spec.load_cell("hymba-1.5b.train-8x4k").mix
    a = traffic.train_batch(mix, 32001, BIG_SEED, 3)
    b = traffic.train_batch(mix, 32001, BIG_SEED, 3)
    c = traffic.train_batch(mix, 32001, BIG_SEED, 4)
    assert a["tokens"].shape == (8, 4096)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].max() < 32001 and a["tokens"].min() >= 0
    pmix = spec.load_cell("hymba-1.5b.prefill-long").mix
    p = traffic.prompts(pmix, 32001, BIG_SEED, 7, 1024)
    assert p.shape == (4, 1024)
    assert np.array_equal(p, traffic.prompts(pmix, 32001, BIG_SEED, 7, 1024))


def test_checked_sample_holds_the_longest():
    mix = spec.load_cell("h2o-danube-1.8b.prefill-long").mix
    for seed in (1, BIG_SEED):
        picked = prefill.sample(mix, seed)
        assert len(set(picked)) == mix["check_batches"]
        per = sum(t for _, t in mix["lengths"])
        assert max(picked) < mix["check_cycles"] * per
        assert max(prefill.length_of(mix, seed, i) for i in picked) == 8192
        assert picked == prefill.sample(mix, seed)


def test_ring_holds_the_last_positions_by_slot():
    keys = torch.arange(1, 11).float()[:, None]         # positions 0..9
    assert check.ring(keys, 4)[:, 0].tolist() == [9, 10, 7, 8]
    assert check.ring(keys, 12)[:, 0].tolist() == list(range(1, 11)) + [0, 0]
    assert check.ring(keys, 10)[:, 0].tolist() == list(range(1, 11))


def test_weights_repeat_for_a_seed():
    c = tiny.cell("hymba-1.5b.train-8x4k", "bfloat16")
    a = weights.flat_leaves(weights.make(c, BIG_SEED, "cpu"))
    b = weights.flat_leaves(weights.make(c, BIG_SEED, "cpu"))
    d = weights.flat_leaves(weights.make(c, 7, "cpu"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.attn.wq"], d["layers.attn.wq"])
    assert torch.equal(a["layers.ln1"], torch.ones_like(a["layers.ln1"]))
    assert a["layers.attn.wq"].dtype == torch.bfloat16
    std = a["layers.mlp.w_down"].float().std().item()
    assert abs(std * 128 ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_agrees_with_the_port(workload):
    """fp32 weights: the port's plain path and the reference differ only
    by the order of their sums."""
    result = cb_run.run_cell(tiny.cell(workload), 11, 0.2, False, "cpu")
    assert result["correct"]
    assert all(c["value"] < 1e-4 for c in result["checks"].values())


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace):
    result = cb_run.run_cell(tiny.cell("hymba-1.5b.train-8x4k"), 5,
                             0.2, bool(trace), "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) \
        + ["checks"]
    assert set(result["breakdown"] if trace else {}) <= {"device_ops",
                                                         "idle_gaps"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == set(
        spec.load_cell("hymba-1.5b.train-8x4k").limits)
    json.dumps(result)


def test_no_card_no_result(capsys):
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = cb_run.main(["--workload", WORKLOADS[0], "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_run_loads_no_jax():
    """A fresh process that runs a cell holds no module named jax,
    jaxlib, flax or repro (top-level names compared whole)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from cardbench import run, tiny\n"
        "r = run.run_cell(tiny.cell('hymba-1.5b.prefill-long'), 3, 0.1,"
        " False, 'cpu')\n"
        "print(run.forbidden_modules(), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_whole():
    assert cb_run.forbidden_modules(
        ["repro_torch", "repro_torch.models", "reprox", "jax_free",
         "cardbench.run"]) == []
    assert cb_run.forbidden_modules(
        ["repro.core.raft", "jaxlib.xla_client", "flax", "jax",
         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]
