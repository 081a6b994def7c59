"""The RWKV6, hybrid, MoE and stub-frontend families on a mesh, against the
unsharded port and JAX on the CPU.

Reduced rwkv6-3b, hymba-1.5b (also with one KV head, whose K/V cache is
sharded on hd), moonshot-v1-16b-a3b (the flat dispatch
drop-free and at cf 1.25, the group-local one with 2 groups at cf 1.25),
arctic-480b (the dense residual, Adafactor) and pixtral-12b (a stub
frontend: embeddings in, batch-sharded) in fp32 on a 2 x 2 (data, model)
mesh of four gloo processes (``_torch_sharded_families_worker.py``, one
run for the whole module, started before the references are computed so
that both run at once): two train steps of a state laid out by
``state_specs``, and a prefill plus three greedy decode steps on serve
specs. Each agrees with the unsharded port, and the unsharded port with
JAX, within the fp32 model tolerance 1e-4. After the prefill and after
every decode step each cache and recurrent state keeps ``cache_specs``'
placements and equals the unsharded one; the trained state keeps
``state_specs``'. The kernel wrappers see no DTensor and run as often as
unsharded (the kernels run on each rank's local heads or channels).

On the 2 x 2 mesh WKV6's state arrives sharded on its key rows and the
Mamba state on n, not on the heads or channels the kernels split: two
mutants that do not write the final state back from ``local_map``'s
temporary must change the decode logits, and one that ranks the flat
dispatch's capacity slots over each rank's own tokens must change
moonshot's at cf 1.25.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_families_worker as worker
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import decode_step as jdecode_step
from repro.models import prefill as jprefill
from repro.sharding import ctx as jctx
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.checkpoint import _flatten
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import train_step as jtrain_step
from repro_torch.bridge import tree_from_numpy, tree_to_numpy
from repro_torch.train import data as tdata
from repro_torch.train.train_step import init_train_state, train_step

TOL = 1e-4
WORKER = Path(__file__).resolve().parent / "_torch_sharded_families_worker.py"
WORKER_TIMEOUT_S = 420
CASES = list(worker.CASES)
# the kernels each case's serving runs, which must have been called
HYBRID = ("flash_attention", "decode_attention", "mamba_scan")
KERNELS = {"rwkv6": ("wkv6",), "hymba": HYBRID, "hymba_kv1": HYBRID}


def jax_configs(case: str):
    arch, fields, _ = worker.CASES[case]
    _, opt_cfg = worker.configs(case)
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(),
                               param_dtype="float32", **fields)
    jocfg = jopt.OptConfig(name=opt_cfg.name,
                           warmup_steps=opt_cfg.warmup_steps,
                           total_steps=opt_cfg.total_steps, lr=opt_cfg.lr,
                           eps=opt_cfg.eps)
    return jcfg, jocfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank run's results, the unsharded port's and JAX's, from
    one JAX-initialised state per case."""
    d = tmp_path_factory.mktemp("families")
    flat, jstates = {}, {}
    for case in CASES:
        jcfg, jocfg = jax_configs(case)
        jstates[case] = jinit_train_state(jax.random.PRNGKey(0), jcfg, jocfg)
        flat[case] = _flatten(jstates[case])
        np.savez(d / f"state_{case}.npz", **flat[case])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(WORKER), str(d)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        port = {c: port_unsharded(c, flat[c]) for c in CASES}
        ref = {c: jax_reference(c, jstates[c]) for c in CASES}
        _, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return {"sharded": dict(np.load(d / "results.npz")), "port": port,
            "jax": ref}


def port_unsharded(case: str, flat: dict) -> dict:
    cfg, opt_cfg = worker.configs(case)
    template = init_train_state(torch.Generator(), cfg, opt_cfg)
    state = tree_from_numpy(flat, template)
    out = {}
    with worker.moe_groups(worker.CASES[case][2]), \
            worker.counting() as counts:
        for step in range(worker.STEPS):
            batch = tdata.synth_batch(cfg, worker.TRAIN_SHAPE, step)
            state, m = train_step(state, batch, cfg, opt_cfg)
            out[f"train/loss/{step}"] = m["loss"].numpy()
            out[f"train/grad_norm/{step}"] = m["grad_norm"].numpy()
    out.update((f"train/calls/{k}", np.array(v)) for k, v in counts.items())
    out.update((f"train/params/{k}", v)
               for k, v in tree_to_numpy(state["params"]).items())
    params = tree_from_numpy(flat, template)["params"]
    out.update((f"serve/{k}", v)
               for k, v in worker.serve(case, params).items())
    return out


def jax_reference(case: str, jstate) -> dict:
    """JAX's run of a case. ``jit`` keys its traces on the config, which
    the group count is not part of, so a run with other groups drops the
    traces (a flat one would be reused) before and after."""
    jcfg, jocfg = jax_configs(case)
    groups = worker.CASES[case][2]
    jctx.set_moe_groups(groups)
    if groups != 1:
        jax.clear_caches()
    try:
        return _jax_runs(jcfg, jocfg, jstate)
    finally:
        jctx.set_moe_groups(1)
        if groups != 1:
            jax.clear_caches()


def _jax_runs(jcfg, jocfg, jstate) -> dict:
    step_fn = jax.jit(functools.partial(jtrain_step, cfg=jcfg,
                                        opt_cfg=jocfg))
    shape = JShapeConfig("t", "train", worker.TRAIN_SHAPE.seq_len,
                         worker.TRAIN_SHAPE.global_batch)
    out, state = {}, jstate
    for step in range(worker.STEPS):
        batch = jdata.synth_batch(jcfg, shape, step)
        state, m = step_fn(state, jax.tree.map(jnp.asarray, batch))
        out[f"train/loss/{step}"] = np.asarray(m["loss"])
    out.update((f"train/params/{k}", v) for k, v in
               _flatten(state["params"]).items())
    prompts = worker.prompt(jcfg)
    if jcfg.embedding_stub:
        batch = {"embeds": jnp.asarray(prompts[:, :worker.PROMPT])}
    else:
        batch = {"tokens": jnp.asarray(prompts[:, :worker.PROMPT],
                                       jnp.int32)}
    params = jstate["params"]
    logits, caches, pos = jax.jit(jprefill, static_argnums=1)(
        params, jcfg, batch)
    if "kv" in caches:
        caches["kv"] = jax.tree.map(lambda c: jnp.pad(
            c, [(0, 0), (0, 0), (0, worker.DECODE), (0, 0), (0, 0)]),
            caches["kv"])
    dec = jax.jit(jdecode_step, static_argnums=1)
    for step in range(worker.DECODE + 1):
        out[f"serve/logits/{step}"] = np.asarray(logits)
        if step == worker.DECODE:
            break
        out[f"serve/ids/{step}"] = np.asarray(jnp.argmax(logits, -1))
        x = jnp.asarray(prompts[:, worker.PROMPT + step]) \
            if jcfg.embedding_stub \
            else jnp.argmax(logits, -1).astype(jnp.int32)
        logits, caches = dec(params, jcfg, x, caches, pos + step)
    return out


def close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=name)


def keys(results: dict, prefix: str) -> list:
    return sorted(k[len(prefix):] for k in results if k.startswith(prefix))


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_matches_unsharded(runs, case):
    got, want = runs["sharded"], runs["port"][case]
    for step in range(worker.STEPS):
        for what in ("loss", "grad_norm"):
            close(got[f"{case}/train/{what}/{step}"],
                  want[f"train/{what}/{step}"], f"{case} {what} {step}")
    names = keys(got, f"{case}/train/params/")
    assert names == keys(want, "train/params/")
    for name in names:
        close(got[f"{case}/train/params/{name}"],
              want[f"train/params/{name}"], f"{case} {name}")


@pytest.mark.parametrize("case", CASES)
def test_sharded_state_keeps_state_specs(runs, case):
    """Every parameter and optimizer leaf still has ``state_specs``'
    placements after the steps."""
    assert list(runs["sharded"][f"{case}/train/misplaced"]) == []


@pytest.mark.parametrize("case", CASES)
def test_unsharded_train_matches_jax(runs, case):
    got, want = runs["port"][case], runs["jax"][case]
    for step in range(worker.STEPS):
        close(got[f"train/loss/{step}"], want[f"train/loss/{step}"],
              f"loss {step}")
    names = keys(want, "train/params/")
    assert names == keys(got, "train/params/")
    for name in names:
        close(got[f"train/params/{name}"], want[f"train/params/{name}"],
              name)


@pytest.mark.parametrize("step", range(worker.DECODE + 1))
@pytest.mark.parametrize("case", CASES)
def test_sharded_serve_matches_unsharded_and_jax(runs, case, step):
    """Step 0 is the prefill's last-token logits, then each decode step's;
    the greedy ids are equal on all three paths."""
    got, port, ref = runs["sharded"], runs["port"][case], runs["jax"][case]
    close(got[f"{case}/serve/logits/{step}"], port[f"serve/logits/{step}"],
          "sharded")
    close(port[f"serve/logits/{step}"], ref[f"serve/logits/{step}"],
          "port vs JAX")
    if step < worker.DECODE:
        np.testing.assert_array_equal(got[f"{case}/serve/ids/{step}"],
                                      port[f"serve/ids/{step}"])
        np.testing.assert_array_equal(port[f"serve/ids/{step}"],
                                      ref[f"serve/ids/{step}"])


@pytest.mark.parametrize("step", range(worker.DECODE + 1))
@pytest.mark.parametrize("case", CASES)
def test_sharded_caches_follow_cache_specs(runs, case, step):
    """After the prefill (step 0) and each decode step every cache leaf
    (K/V, WKV and shift states, Mamba's conv and h) has ``cache_specs``'
    placements and the unsharded run's values."""
    got, want = runs["sharded"], runs["port"][case]
    assert list(got[f"{case}/serve/misplaced/{step}"]) == []
    names = keys(got, f"{case}/serve/cache/{step}/")
    assert names and names == keys(want, f"serve/cache/{step}/")
    for name in names:
        close(got[f"{case}/serve/cache/{step}/{name}"],
              want[f"serve/cache/{step}/{name}"], f"{case} {name}")


@pytest.mark.parametrize("case", CASES)
def test_kernels_run_on_local_shards(runs, case):
    """The wrappers (which fail on a DTensor in the worker) run as often
    sharded as unsharded, in training and in serving; each family's own
    kernels run."""
    got, want = runs["sharded"], runs["port"][case]
    for run in ("train", "serve"):
        calls = {k: int(got[f"{case}/{run}/calls/{k}"])
                 for k in keys(got, f"{case}/{run}/calls/")}
        assert calls == {k: int(want[f"{run}/calls/{k}"]) for k in calls}
        for kernel in KERNELS.get(case, ("flash_attention",
                                         "decode_attention")):
            if run == "serve" or kernel != "decode_attention":
                assert calls[kernel] > 0, (run, kernel)


@pytest.mark.parametrize("case", list(worker.MUTANTS))
def test_mutants_are_caught(runs, case):
    """A final state left in ``local_map``'s temporary, or capacity ranks
    over each rank's own tokens, change the logits: the comparison above
    fails for each."""
    got, want = runs["sharded"], runs["port"][case]
    worst = max(np.abs(got[f"{case}/mutant/logits/{step}"]
                       - want[f"serve/logits/{step}"]).max()
                for step in range(worker.DECODE + 1))
    assert worst > 100 * TOL


def test_capacity_drops_and_groups_change_the_function(runs):
    """At cf 1.25 moonshot's flat dispatch drops rows (its logits differ
    from the drop-free run's), and the group-local one drops others."""
    got = runs["sharded"]

    def logits(case):
        return np.stack([got[f"{case}/serve/logits/{s}"]
                         for s in range(worker.DECODE + 1)])

    assert np.abs(logits("moonshot_cf") - logits("moonshot")).max() > \
        100 * TOL
    assert np.abs(logits("moonshot_grouped")
                  - logits("moonshot_cf")).max() > 100 * TOL
