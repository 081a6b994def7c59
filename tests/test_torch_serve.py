"""The port's serving engine and launcher on the CPU: greedy token ids equal
the JAX engine's on the ``tiny`` preset and on reduced rwkv6-3b in fp32,
and the entry points default to the card and raise without one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch.train import PRESETS as JAX_PRESETS
from repro.models import init_params as jinit_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.coord.registry import ClusterRegistry
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.train import PRESETS
from repro_torch.serve.engine import Engine, ServeConfig


@pytest.fixture(scope="module")
def tiny():
    jparams = jinit_params(jax.random.PRNGKey(0), JAX_PRESETS["tiny"])
    cfg = PRESETS["tiny"]
    return cfg, jparams, params_from_numpy(_flatten(jparams), cfg, "cpu")


def test_greedy_generate_matches_jax(tiny):
    cfg, jparams, params = tiny
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8),
                                                dtype=np.int32)
    want = JaxEngine(JAX_PRESETS["tiny"], jparams,
                     JaxServeConfig(max_new_tokens=6)).generate(
        jnp.asarray(prompts))
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=6), device="cpu")
    got = engine.generate(prompts)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert engine.stats["requests"] == 2 and engine.stats["new_tokens"] == 12
    assert engine.stats["prefill_ms"] > 0


def test_rwkv_greedy_generate_matches_jax():
    """RWKV's states pass from prefill to decode without growth, as in the
    JAX engine: greedy ids match over 6 new tokens."""
    jcfg, cfg = (dataclasses.replace(a["rwkv6-3b"].reduced(),
                                     param_dtype="float32")
                 for a in (JAX_ARCHS, ARCHS))
    jparams = jinit_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10),
                                                dtype=np.int32)
    want = JaxEngine(jcfg, jparams, JaxServeConfig(max_new_tokens=6)) \
        .generate(jnp.asarray(prompts))
    got = Engine(cfg, params, ServeConfig(max_new_tokens=6),
                 device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_is_seeded(tiny):
    cfg, _, params = tiny
    prompts = torch.arange(16).reshape(2, 8)
    scfg = ServeConfig(max_new_tokens=4, temperature=1.0, seed=3)
    a = Engine(cfg, params, scfg, device="cpu").generate(prompts)
    b = Engine(cfg, params, scfg, device="cpu").generate(prompts)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < cfg.vocab_size)).all()


def test_registry_contract(tiny):
    """A given registry is read once for the model version; with none,
    consistency= stands up a coordinator with the named read policy, whose
    read of the (empty) checkpoint table is the model version."""
    cfg, _, params = tiny

    class Registry:
        def latest_checkpoint(self):
            return {"step": 7}
    engine = Engine(cfg, params, registry=Registry(), device="cpu")
    assert engine.model_version == {"step": 7}
    for policy in ("leaseguard", "quorum"):
        engine = Engine(cfg, params, consistency=policy, device="cpu")
        assert isinstance(engine.registry, ClusterRegistry)
        assert engine.registry.coord.stats()["consistency"] == policy
        assert engine.model_version is None
        assert engine.registry.coord.stats()["reads"] == 1


def test_engine_defaults_to_the_card(tiny):
    cfg, _, params = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--preset", "tiny"])


def test_engine_rejects_params_on_another_device(tiny):
    cfg, _, params = tiny
    meta = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError):
        Engine(cfg, meta, device="cpu")


def test_serve_cli_on_cpu(capsys):
    out = serve_cli.main(["--arch", "qwen3-8b", "--smoke", "--requests", "2",
                          "--prompt-len", "6", "--max-new", "3",
                          "--device", "cpu"])
    assert out["ids"].shape == (2, 3)
    # CPU tensors take the plain versions: no kernel launches
    assert out["flash_attention"] == 0 and out["decode_attention"] == 0
    assert "served 2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("policy,read_messages", [("leaseguard", 0),
                                                  ("readindex", None)])
def test_serve_cli_consistency_on_cpu(capsys, policy, read_messages):
    """--consistency: the model version (the fresh-init manifest) is read
    with the named policy; leaseguard's leased read sends no message."""
    out = serve_cli.main(["--preset", "tiny", "--requests", "1",
                          "--prompt-len", "4", "--max-new", "2",
                          "--device", "cpu", "--consistency", policy])
    stats = out["coordinator"]
    assert stats["consistency"] == policy and stats["reads"] == 1
    if read_messages is not None:
        assert stats["read_messages"] == read_messages
    else:
        assert stats["read_messages"] > 0
    printed = capsys.readouterr().out
    assert "model version: step 0" in printed and policy in printed


def test_serve_cli_rwkv_on_cpu(capsys):
    out = serve_cli.main(["--arch", "rwkv6-3b", "--smoke", "--requests", "2",
                          "--prompt-len", "7", "--max-new", "3",
                          "--device", "cpu"])
    assert out["ids"].shape == (2, 3) and out["wkv6"] == 0
    assert "wkv6 0" in capsys.readouterr().out
