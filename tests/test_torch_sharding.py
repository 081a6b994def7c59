"""The port's sharding layer against ``repro.sharding`` on the CPU.

Rules: ``param_specs`` (train and serve), ``state_specs`` (the optimizer
states: AdamW, Adafactor for arctic-480b, as each config names),
``batch_specs`` and ``cache_specs`` equal JAX's ``PartitionSpec``s leaf for
leaf, for every config at full size, on the (2, 4), (16, 16) and (2, 16,
16) meshes. Neither side needs devices: JAX's functions read a stand-in
mesh's ``axis_names``, ``devices`` and ``axis_sizes``, the port's its
``mesh_dim_names`` and ``shape``; JAX's shapes come from ``jax.eval_shape``,
the port's are meta tensors.

Context: ``constrain`` does nothing without axes or on a plain tensor;
the roles, the mesh axes and the placements.

Sharded execution: reduced qwen3-8b (fp32) on a 2 x 2 (data, model) mesh
of four gloo processes (``_torch_sharded_worker.py``, one run for the
whole module): two train steps of a state laid out by ``state_specs``,
with sequence parallelism off and on, and a prefill plus three greedy
decode steps on serve specs and sharded caches. Each agrees with the
unsharded port, and the unsharded port with JAX, within the fp32 model
tolerance 1e-4; a mutant that puts the attention heads' shard on hd must
not agree.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_sharded_worker as worker
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import mesh as jmesh
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_cache as jinit_decode_cache
from repro.models import prefill as jprefill
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.checkpoint import _flatten
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import train_step as jtrain_step
from repro_torch.bridge import tree_from_numpy, tree_to_numpy
from repro_torch.configs import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.models import decode_step, init_decode_cache, prefill
from repro_torch.serve.engine import preallocate_cache
from repro_torch.sharding import ctx, rules
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import init_train_state, train_step

TOL = 1e-4
WORKER = Path(__file__).resolve().parent / "_torch_sharded_worker.py"
WORKER_TIMEOUT_S = 420
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("params_train", "params_serve", "state", "batch", "cache")


def jax_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape, object),
                           axis_sizes=shape)


def port_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(mesh_dim_names=axes, shape=shape)


def jax_flat(tree) -> dict:
    """{key path: spec as a tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) for k in path): tuple(spec)
            for path, spec in leaves}


def port_flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def meta(tree):
    """JAX shapes -> meta tensors in the same nested dicts."""
    if isinstance(tree, dict):
        return {k: meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@functools.cache
def shapes(arch: str) -> dict:
    """JAX's and the port's full-size shape trees of ``arch``: the train
    state, a batch and decode caches."""
    jcfg, tcfg = JAX_ARCHS[arch], ARCHS[arch]
    jstate = jax.eval_shape(functools.partial(
        jinit_train_state, jax.random.PRNGKey(0), jcfg,
        jopt.OptConfig(name=jcfg.optimizer)))
    params = meta(jstate["params"])
    state = {"params": params, "step": 0,
             "opt": topt.init_opt_state(params,
                                        topt.OptConfig(name=tcfg.optimizer))}
    # a batch the data axes divide, and one they do not (6 rows)
    batch = {"tokens": (256, 4096), "labels": (256, 4096), "odd": (6, 8)}
    if jcfg.embedding_stub:
        batch["embeds"] = (256, 4096, jcfg.d_model)
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in batch.items()}
    return {"jstate": jstate, "state": state, "jbatch": jbatch,
            "batch": {k: torch.empty(s, device="meta")
                      for k, s in batch.items()},
            "jcache": jax.eval_shape(functools.partial(
                jinit_decode_cache, jcfg, 16, 1024)),
            "cache": init_decode_cache(tcfg, 16, 1024, device="meta")}


def specs(kind: str, arch: str, mesh: str) -> tuple[dict, dict]:
    s, jm, tm = shapes(arch), jax_mesh(mesh), port_mesh(mesh)
    if kind.startswith("params"):
        mode = kind.split("_")[1]
        return (jax_flat(jrules.param_specs(s["jstate"]["params"], jm, mode)),
                port_flat(rules.param_specs(s["state"]["params"], tm, mode)))
    if kind == "state":
        return (jax_flat(jrules.state_specs(s["jstate"], jm)),
                port_flat(rules.state_specs(s["state"], tm)))
    if kind == "batch":
        return (jax_flat(jrules.batch_specs(s["jbatch"], jm)),
                port_flat(rules.batch_specs(s["batch"], tm)))
    return (jax_flat(jrules.cache_specs(s["jcache"], jm)),
            port_flat(rules.cache_specs(s["cache"], tm)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_jax(arch, mesh, kind):
    want, got = specs(kind, arch, mesh)
    assert sorted(got) == sorted(want)
    assert got == want
    if kind == "state":
        # the optimizer state is the config's own
        opt = "f" if ARCHS[arch].optimizer == "adafactor" else "m"
        assert any(k.startswith(f"opt/{opt}/") for k in got)


def test_rules_shard_both_axes():
    """The rules are not all replication: at (16, 16) qwen3-8b's wq is FSDP
    x TP, arctic's experts sit on model, and serving drops the FSDP dim."""
    train, _ = specs("params_train", "qwen3-8b", "16x16")
    serve, _ = specs("params_serve", "qwen3-8b", "16x16")
    assert train["layers/attn/wq"] == (None, "data", "model")
    assert serve["layers/attn/wq"] == (None, None, "model")
    moe, _ = specs("params_train", "arctic-480b", "2x16x16")
    assert moe["layers/moe/w_gate"][:2] == (None, "model")
    cache, _ = specs("cache", "qwen3-8b", "2x4")
    assert cache["kv/k"] == (None, "data", None, "model", None)


# ----------------------------------------------------------------- context
def test_constrain_is_a_noop_without_axes():
    ctx.clear()
    x = torch.randn(4, 6)
    assert ctx.constrain(x, "dp", "tp") is x


def test_constrain_leaves_plain_tensors():
    ctx.set_axes("data", "model", sp=True)
    try:
        x = torch.randn(4, 6, 8)
        assert ctx.constrain(x, "dp", "sp", "tp") is x
        assert ctx.spec_of(3, ("dp", "sp", "tp")) == ("data", "model",
                                                      "model")
        assert ctx.sp_enabled()
    finally:
        ctx.clear()
    assert not ctx.sp_enabled()
    assert ctx.spec_of(2, ("dp", "tp")) == (None, None)


@pytest.mark.parametrize("mesh", MESHES)
def test_axes_from_mesh_match_jax(mesh):
    assert ctx.axes_from_mesh(port_mesh(mesh)) == \
        jctx.axes_from_mesh(jax_mesh(mesh))


def test_moe_groups_as_in_jax():
    try:
        for n in (0, 1, 4):
            ctx.set_moe_groups(n)
            jctx.set_moe_groups(n)
            assert ctx.moe_groups() == jctx.moe_groups() == max(1, n)
    finally:
        ctx.set_moe_groups(1)
        jctx.set_moe_groups(1)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh("2x16x16")
    assert rules.to_placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert rules.to_placements((None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert rules.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        rules.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two tensor dims"):
        rules.to_placements(("model", "model"), mesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_have_jax_shapes_and_names(monkeypatch, multi_pod):
    """Both mesh functions pass JAX's shape and axis names (no devices are
    needed to see them)."""
    import torch.distributed.device_mesh as dm
    seen = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: seen.append(
                            (tuple(shape), mesh_dim_names)))
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes: seen.append((tuple(shape),
                                                         tuple(axes))))
    tmesh.make_production_mesh(multi_pod=multi_pod)
    jmesh.make_production_mesh(multi_pod=multi_pod)
    tmesh.make_local_mesh(2, 4, multi_pod=multi_pod, device="cpu")
    jmesh.make_local_mesh(2, 4, multi_pod=multi_pod)
    assert seen[0] == seen[1] and seen[2] == seen[3]
    assert seen[0][0] == ((2, 16, 16) if multi_pod else (16, 16))
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12


# -------------------------------------------------------- sharded execution
@functools.cache
def jax_configs(optimizer: str = "adamw"):
    cfg, opt_cfg = worker.configs(optimizer)
    jcfg = dataclasses.replace(JAX_ARCHS["qwen3-8b"].reduced(),
                               param_dtype="float32",
                               grad_accum=cfg.grad_accum)
    jocfg = jopt.OptConfig(name=optimizer, warmup_steps=opt_cfg.warmup_steps,
                           total_steps=opt_cfg.total_steps, lr=opt_cfg.lr)
    return jcfg, jocfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank run's results, the unsharded port's and JAX's, from
    one JAX-initialised state."""
    d = tmp_path_factory.mktemp("mesh")
    flat, jstates = {}, {}
    for optimizer in ("adamw", "adafactor"):
        jcfg, jocfg = jax_configs(optimizer)
        jstates[optimizer] = jinit_train_state(jax.random.PRNGKey(0), jcfg,
                                               jocfg)
        flat[optimizer] = _flatten(jstates[optimizer])
        np.savez(d / f"state_{optimizer}.npz", **flat[optimizer])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(WORKER), str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=WORKER_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    sharded = dict(np.load(d / "results.npz"))
    return {"sharded": sharded,
            "port": {o: port_unsharded(flat[o], o) for o in flat},
            "jax": {o: jax_reference(jstates[o], o) for o in flat}}


def port_unsharded(flat: dict, optimizer: str) -> dict:
    cfg, opt_cfg = worker.configs(optimizer)
    template = init_train_state(torch.Generator(), cfg, opt_cfg)
    state = tree_from_numpy(flat, template)
    out = {}
    for step in range(worker.STEPS):
        batch = tdata.synth_batch(cfg, worker.TRAIN_SHAPE, step)
        state, m = train_step(state, batch, cfg, opt_cfg)
        out[f"loss/{step}"] = m["loss"].numpy()
        out[f"grad_norm/{step}"] = m["grad_norm"].numpy()
    out.update((f"params/{k}", v)
               for k, v in tree_to_numpy(state["params"]).items())
    if optimizer != "adamw":
        return out
    params = tree_from_numpy(flat, template)["params"]
    with torch.no_grad():
        logits, caches, pos = prefill(params, cfg, {
            "tokens": torch.from_numpy(worker.prompt_tokens(cfg))})
        caches = preallocate_cache(cfg, caches, worker.PROMPT + worker.DECODE)
        for step in range(worker.DECODE + 1):
            out[f"logits/{step}"] = logits.numpy()
            if step == worker.DECODE:
                break
            ids = logits.argmax(-1)
            out[f"ids/{step}"] = ids.numpy()
            logits, caches = decode_step(params, cfg, ids, caches, pos + step)
    return out


def jax_reference(jstate, optimizer: str) -> dict:
    jcfg, jocfg = jax_configs(optimizer)
    step_fn = jax.jit(functools.partial(jtrain_step, cfg=jcfg, opt_cfg=jocfg))
    shape = JShapeConfig("t", "train", worker.TRAIN_SHAPE.seq_len,
                         worker.TRAIN_SHAPE.global_batch)
    out, state = {}, jstate
    for step in range(worker.STEPS):
        batch = jdata.synth_batch(jcfg, shape, step)
        state, m = step_fn(state, jax.tree.map(jnp.asarray, batch))
        out[f"loss/{step}"] = np.asarray(m["loss"])
    out.update((f"params/{k}", v) for k, v in
               _flatten(state["params"]).items())
    if optimizer != "adamw":
        return out
    tokens = jnp.asarray(worker.prompt_tokens(jcfg), jnp.int32)
    logits, caches, pos = jax.jit(jprefill, static_argnums=1)(
        jstate["params"], jcfg, {"tokens": tokens})
    caches = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0), (0, 0), (0, worker.DECODE), (0, 0), (0, 0)]), caches)
    dec = jax.jit(jdecode_step, static_argnums=1)
    for step in range(worker.DECODE + 1):
        out[f"logits/{step}"] = np.asarray(logits)
        if step == worker.DECODE:
            break
        ids = jnp.argmax(logits, -1).astype(jnp.int32)
        out[f"ids/{step}"] = np.asarray(ids)
        logits, caches = dec(jstate["params"], jcfg, ids, caches, pos + step)
    return out


def close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=name)


def param_keys(results: dict, prefix: str) -> list:
    return sorted(k for k in results if k.startswith(prefix + "params/"))


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_sharded_train_step_matches_unsharded(runs, case):
    got = runs["sharded"]
    want = runs["port"][worker.TRAIN_CASES[case][1]]
    for step in range(worker.STEPS):
        for what in ("loss", "grad_norm"):
            close(got[f"{case}/{what}/{step}"], want[f"{what}/{step}"],
                  f"{case} {what} step {step}")
    keys = param_keys(got, f"{case}/")
    assert len(keys) == len(param_keys(want, ""))
    for key in keys:
        close(got[key], want[key.split("/", 1)[1]], key)


@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_sharded_state_keeps_the_rules_placements(runs, case):
    """After the steps the parameters still have the rules' placements:
    wq (L, d, H hd) FSDP on data, TP on model."""
    assert str(runs["sharded"][f"{case}/placements/wq"]) == \
        "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_unsharded_train_step_matches_jax(runs, optimizer):
    got, want = runs["port"][optimizer], runs["jax"][optimizer]
    for step in range(worker.STEPS):
        close(got[f"loss/{step}"], want[f"loss/{step}"], f"loss {step}")
    keys = param_keys(want, "")
    assert keys == param_keys(got, "")
    for key in keys:
        close(got[key], want[key], key)


@pytest.mark.parametrize("step", range(worker.DECODE + 1))
def test_sharded_serve_matches_unsharded_and_jax(runs, step):
    """Step 0 is the prefill's last-token logits, then each decode step's;
    the greedy ids fed to the next step are equal on all three paths."""
    got, port, ref = runs["sharded"], runs["port"]["adamw"], \
        runs["jax"]["adamw"]
    close(got[f"serve/logits/{step}"], port[f"logits/{step}"], "sharded")
    close(port[f"logits/{step}"], ref[f"logits/{step}"], "port vs JAX")
    if step < worker.DECODE:
        np.testing.assert_array_equal(got[f"serve/ids/{step}"],
                                      port[f"ids/{step}"])
        np.testing.assert_array_equal(port[f"ids/{step}"],
                                      ref[f"ids/{step}"])


def test_sharded_caches_follow_cache_specs(runs):
    """(L, B, S, Hkv, hd): batch on data, KV heads on model."""
    assert str(runs["sharded"]["serve/cache_placements"]) == \
        "(Shard(dim=1), Shard(dim=3))"


def test_wrong_placement_mutant_is_caught(runs):
    """Attention on shards of hd, not of heads, gives other logits: the
    comparison above fails for it."""
    got = runs["sharded"]["mutant/logits/0"]
    want = runs["port"]["adamw"]["logits/0"]
    assert np.abs(got - want).max() > 100 * TOL
    with pytest.raises(AssertionError):
        close(got, want, "mutant")
