"""Where the JAX reference places a dim that the ``model`` axis does not
divide, pinned for the port's sharding layer and dry run (ROADMAP.md
queue 3, m).

Three facts of jax 0.9, in a subprocess with 16 forced CPU devices (jax
fixes the device count when it first starts, as in
``tests/test_dryrun_small.py``):

* on ``repro.launch.mesh.make_local_mesh(1, 16)``, whose axes
  ``jax.make_mesh`` makes ``Explicit``, ``repro.sharding.ctx.constrain``
  leaves a (2, 4, h, 8) array unconstrained for h of 56, 25 and 32:
  ``with_sharding_constraint`` raises there ("can only refer to Auto
  axes") and ``constrain`` returns its input, so the output of ``jit``
  lies whole on one device, even where 16 divides h;
* on a mesh of ``Auto`` axes, ``with_sharding_constraint`` shards h over
  gcd(h, 16) devices and replicates it over the rest: 56 -> 8, 40 -> 8,
  12 -> 4, 25 -> 1;
* the JAX package's own dry run (``repro.launch.dryrun.lower_cell``, at
  full width and depth 1, a 2 x 64 prefill on that mesh) still shards
  such a dim over gcd(dim, 16) devices: the constraints do nothing, but
  GSPMD carries the weights' ``model`` sharding into the activations.
  Its compiled program holds arctic-480b's attention scores on 7 of the
  56 heads a device (8 ways) and hymba-1.5b's on all 25 (whole), and
  hymba's Mamba state on 100 of its 1600 channels a device (16 ways).

The port keeps such a dim whole on every ``model`` rank (DTensor has no
placement over gcd(dim, 16) of 16 ranks, and the scan kernel takes a
multiple of 8 channels a rank), so it matches JAX's placement only where
the gcd is 1; ``repro_torch.launch.dryrun.undivided_dims`` reports both.
"""

import json
import math
import os
import subprocess
import sys

import pytest

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import json
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.launch.mesh import make_local_mesh
from repro.sharding import ctx

out = {"explicit": {}, "auto": {}}
mesh = make_local_mesh(1, 16)
out["axis_types"] = [t.name for t in mesh.axis_types]
ctx.set_axes("data", "model")
for h in (56, 25, 32):
    same = []

    def f(x):
        y = ctx.constrain(x, None, None, "tp", None)
        same.append(y is x)
        return y * 1

    with mesh:
        y = jax.jit(f)(jnp.ones((2, 4, h, 8)))
    out["explicit"][h] = [same[0], type(y.sharding).__name__,
                          len(y.sharding.device_set)]
ctx.clear()
auto = jax.make_mesh((1, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for h in (56, 40, 12, 25):
    def g(x):
        return jax.lax.with_sharding_constraint(
            x, P(None, None, "model", None)) * 1

    with auto:
        y = jax.jit(g)(jnp.ones((2, 4, h, 8)))
    out["auto"][h] = [len({str(s.index) for s in y.addressable_shards}),
                      y.addressable_shards[0].data.shape[2]]

# JAX's own dry run: the per-device sizes of the attention scores'
# (B, H, S, S) and the Mamba scan's (B, di, n) values in its compiled
# program, read from the instructions under their named scopes
import dataclasses
import re
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell


def local_sizes(text, scope, pattern):
    return sorted({int(m.group(1)) for line in text.splitlines()
                   if scope in line for m in [re.search(pattern, line)] if m})


out["dry_run"] = {}
for arch in ("arctic-480b", "hymba-1.5b"):
    cfg = dataclasses.replace(get_arch(arch), n_layers=1)
    text = lower_cell(cfg, ShapeConfig("p", "prefill", 64, 2),
                      mesh).compile().as_text()
    out["dry_run"][arch] = {
        "heads": local_sizes(text, "vmemkernel_flash_attention",
                             r"= f32\[2,(\d+),64,64\]"),
        "channels": local_sizes(text, "vmemkernel_mamba_scan",
                                r"= f32\[2,(\d+),16\]")}
print("PLACEMENTS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def placements():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = next(x for x in run.stdout.splitlines()
                if x.startswith("PLACEMENTS "))
    return json.loads(line[len("PLACEMENTS "):])


def test_reference_constrain_on_explicit_and_auto_meshes(placements):
    got = placements
    assert got["axis_types"] == ["Explicit", "Explicit"]
    for h in ("56", "25", "32"):
        # constrain returned its input; jit's output is on one device
        assert got["explicit"][h] == [True, "SingleDeviceSharding", 1], h
    for h, ways in (("56", 8), ("40", 8), ("12", 4), ("25", 1)):
        assert ways == math.gcd(int(h), 16)
        # ``ways`` distinct shards, each h / ways heads
        assert got["auto"][h] == [ways, int(h) // ways], h


def test_reference_dry_run_shards_over_the_gcd(placements):
    """JAX's compiled dry run on its own (1, 16) mesh: each dim over
    gcd(dim, 16) devices, whole only where the gcd is 1."""
    got = placements["dry_run"]
    assert got["arctic-480b"] == {"heads": [56 // math.gcd(56, 16)],
                                  "channels": []}
    assert got["hymba-1.5b"] == {"heads": [25 // math.gcd(25, 16)],
                                 "channels": [1600 // math.gcd(1600, 16)]}
