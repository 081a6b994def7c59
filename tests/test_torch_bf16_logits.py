"""bf16 logits of the port against the JAX package's, each held to its own
fp32 logits of the same weights.

On the card, rwkv6-3b's and hymba-1.5b's bf16 logits sit 11-14 % (rel L2)
from an fp32 run of the same weights, on the kernel path and on the plain
path alike. This test measures the same gap in the JAX package on the CPU:
the prefill's last-token logits of one bf16 model and of its weights
widened to fp32, JAX's pair and the port's pair (its plain path, which the
CPU runs), with the same weights and tokens. The port's gap must stay within
1.5x JAX's (the rule of ``tests/test_torch_bf16_grads.py``), at the reduced
shape and at a deeper and wider cut; qwen3-8b is the dense control. JAX's
recurrent families sit several times further from fp32 than its dense
control does, so the large gap is the reference's behaviour, not a fault
of the port's bf16 rounding.

Weights cross through ``bridge.params_from_numpy(_flatten(jax_params))``;
tokens are made with numpy from a seed. Tolerances: the gap ratio 1.5; the
two fp32 runs within 1e-5 (rel L2) of each other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.models import prefill

# (layers, d_model, prompt length): the reduced config's, and a cut eight
# layers deep and 256 wide, where the gaps have grown toward the card's
SIZES = [(2, 64, 64), (8, 256, 256)]
BATCH = 4


def rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.cache
def logits_case(name: str, layers: int, d_model: int, s: int) -> dict:
    """Last-token prefill logits, bf16 and fp32, of JAX and of the port,
    from one set of bf16 weights (fp32: the same weights widened)."""
    cut = {"n_layers": layers, "d_model": d_model}
    jcfg = dataclasses.replace(JAX_ARCHS[name].reduced(), **cut)
    cfg = dataclasses.replace(ARCHS[name].reduced(), **cut)
    assert jcfg.param_dtype == cfg.param_dtype == "bfloat16"
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (BATCH, s),
                                               dtype=np.int32)
    run = jax.jit(jprefill, static_argnums=1)
    jax16 = run(jparams, jcfg, {"tokens": jnp.asarray(tokens)})[0]
    jax32 = run(jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                dataclasses.replace(jcfg, param_dtype="float32"),
                {"tokens": jnp.asarray(tokens)})[0]
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(jparams).items()}
    batch = {"tokens": torch.from_numpy(tokens).long()}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    with torch.no_grad():
        port16 = prefill(params_from_numpy(flat, cfg, "cpu"), cfg, batch)[0]
        port32 = prefill(params_from_numpy(flat, cfg32, "cpu"), cfg32,
                         batch)[0]
    return {"jax16": np.asarray(jax16), "jax32": np.asarray(jax32),
            "port16": port16.numpy(), "port32": port32.numpy()}


@pytest.mark.parametrize("size", SIZES, ids=[f"L{n}-d{d}" for n, d, _ in SIZES])
@pytest.mark.parametrize("name", ["qwen3-8b", "rwkv6-3b", "hymba-1.5b"])
def test_bf16_logits_within_jax_bf16_gap(name, size):
    c = logits_case(name, *size)
    assert c["port16"].shape == c["jax16"].shape == (BATCH, 256)
    assert rel(c["port32"], c["jax32"]) <= 1e-5
    port, jax_gap = rel(c["port16"], c["port32"]), rel(c["jax16"], c["jax32"])
    assert 0 < port <= 1.5 * jax_gap, (port, jax_gap)


@pytest.mark.parametrize("name", ["rwkv6-3b", "hymba-1.5b"])
def test_jax_recurrent_bf16_logits_sit_further_than_dense(name):
    """The witness: in the JAX package itself, the recurrent family's bf16
    logits sit more than twice as far from fp32 as the dense control's at
    the deeper cut, as the port's do on the card."""
    size = SIZES[-1]
    dense = logits_case("qwen3-8b", *size)
    c = logits_case(name, *size)
    gaps = [rel(x["jax16"], x["jax32"]) for x in (c, dense)]
    assert gaps[0] > 2 * gaps[1], gaps
