"""bf16 training gradients of the port against the JAX package's, both held
to JAX's fp32 gradients of the same weights.

The embedding's gradient is a scatter-add of one row per token. With
``synth_batch``'s repeated n-grams, hundreds of tokens add into each row,
and in bf16 the sum drifts from the fp32 one: the norm comes out low. The
test shows that the JAX package's own bf16 gradient drifts as far, so the
port keeps its bf16 scatter-add as the reference's behaviour, and it holds
every leaf, the embedding and the others each on their own, to JAX's bf16
error.

Weights cross through ``bridge.params_from_numpy(_flatten(jax_params))``;
the batch is ``synth_batch`` (numpy, bit-equal in both packages).
Tolerances: the loss rtol 1e-3 of JAX's bf16 loss; each leaf's rel L2 from
fp32 within 1.5x JAX's bf16 one; the embedding's gradient within 2e-2 (rel
L2) of JAX's bf16 one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.train import data as jdata
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.train.train_step import loss_and_grads, to_device

# 2 x 2048 tokens of 8-grams: ~230 tokens add into each gathered row
SEQ, BATCH = 2048, 2


def rel(a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.float().numpy()
    return out


@functools.cache
def grads_case():
    """JAX's loss and grads of the reduced qwen3-8b in bf16 and with the
    same weights in fp32, and the port's bf16 ones."""
    jcfg = JAX_ARCHS["qwen3-8b"].reduced()
    assert jcfg.param_dtype == "bfloat16"
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    batch = jdata.synth_batch(jcfg, JaxShapeConfig("t", "train", SEQ, BATCH),
                              0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax.value_and_grad(jforward_train), static_argnums=1)
    loss16, g16 = step(jparams, jcfg, jbatch)
    _, g32 = step(jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                  jcfg32, jbatch)
    cfg = ARCHS["qwen3-8b"].reduced()
    params = params_from_numpy(
        {k: np.asarray(v, np.float32) for k, v in _flatten(jparams).items()},
        cfg, "cpu")
    loss, grads = loss_and_grads(params, cfg, to_device(batch, "cpu"))
    as_np = {k: np.asarray(v, np.float32) for k, v in _flatten(g16).items()}
    return {"jax_loss": float(loss16), "loss": float(loss), "jax16": as_np,
            "jax32": {k: np.asarray(v, np.float32)
                      for k, v in _flatten(g32).items()},
            "port": flat(grads)}


def leaf_errors(c) -> dict:
    """{leaf: (port's rel L2 from fp32, JAX bf16's)}."""
    return {key: (rel(c["port"][key], truth), rel(c["jax16"][key], truth))
            for key, truth in c["jax32"].items()}


def test_bf16_loss_and_every_leaf_within_jax_bf16_error():
    c = grads_case()
    np.testing.assert_allclose(c["loss"], c["jax_loss"], rtol=1e-3)
    assert sorted(c["port"]) == sorted(c["jax32"])
    for key, (port, jax_bf16) in leaf_errors(c).items():
        assert port <= 1.5 * jax_bf16, (key, port, jax_bf16)


def test_bf16_embedding_gradient_drifts_as_jax_does():
    """The witness: JAX's own bf16 embedding gradient is many times further
    from fp32 than any other leaf's, with a low norm, and the port's
    follows it."""
    c = grads_case()
    errs = leaf_errors(c)
    others = max(e[1] for key, e in errs.items() if key != "embed")
    assert errs["embed"][1] > 5 * others, errs
    norms = [np.linalg.norm(c[k]["embed"]) for k in ("jax16", "jax32")]
    assert norms[0] < 0.98 * norms[1], norms
    assert rel(c["port"]["embed"], c["jax16"]["embed"]) <= 2e-2
