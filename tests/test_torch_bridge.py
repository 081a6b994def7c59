"""The parameter bridge, and the port's import boundary: ``repro_torch``
imports neither ``jax`` nor anything of ``repro``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import init_params as jinit_params
from repro.train.checkpoint import _flatten
from repro_torch.bridge import leaf_dtype, params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch,dtype", [("qwen3-8b", "bfloat16"),
                                        ("qwen2.5-3b", "float32")])
def test_round_trip(arch, dtype):
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), param_dtype=dtype)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype=dtype)
    flat = _flatten(jinit_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(flat, cfg, "cpu")
    assert params["layers"]["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    assert params["layers"]["attn"]["wq"].dtype == getattr(torch, dtype)
    assert params["layers"]["ln1"].dtype == torch.float32
    assert params["final_norm"].dtype == torch.float32
    back = params_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_round_trip_keeps_rwkv_leaves_fp32():
    """RWKV's shift mixes, decay, LoRA, bonus and group-norm leaves stay
    fp32 in a bf16 model, as the JAX init keeps them."""
    jcfg = JAX_ARCHS["rwkv6-3b"].reduced()
    cfg = ARCHS["rwkv6-3b"].reduced()
    flat = _flatten(jinit_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(flat, cfg, "cpu")
    tmix, cmix = params["layers"]["tmix"], params["layers"]["cmix"]
    for name in ("mu", "w0", "w_lora_a", "w_lora_b", "bonus_u", "ln_w",
                 "ln_b"):
        assert tmix[name].dtype == torch.float32, name
    assert cmix["mu"].dtype == torch.float32
    for leaf in (tmix["w_r"], tmix["w_o"], cmix["w_k"], params["embed"]):
        assert leaf.dtype == torch.bfloat16
    back = params_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_leaf_dtypes():
    cfg = ARCHS["qwen3-8b"]
    assert leaf_dtype("layers/attn/q_norm", cfg) == torch.float32
    assert leaf_dtype("layers/attn/wq", cfg) == torch.bfloat16
    assert leaf_dtype("embed", cfg) == torch.bfloat16


def test_rejects_non_float32_arrays():
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float16)},
                          ARCHS["qwen3-8b"], "cpu")


def test_configs_are_a_copy_of_the_jax_configs():
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_ARCHS[name])
        assert cfg.param_count() == JAX_ARCHS[name].param_count()


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
