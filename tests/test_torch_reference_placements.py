"""Where the JAX reference places a dim that the ``model`` axis does not
divide, pinned for the port's sharding layer (ROADMAP.md queue 3, m).

Two facts of jax 0.9, in a subprocess with 16 forced CPU devices (jax
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
  12 -> 4, 25 -> 1.

The port's ``constrain`` and ``kernels.ops._on_local_heads`` replicate a
dim that the axis does not divide; which of the two JAX placements the
port should match is the dryrun's question.
"""

import json
import math
import os
import subprocess
import sys

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
print("PLACEMENTS " + json.dumps(out))
"""


def test_reference_constrain_on_explicit_and_auto_meshes():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = next(x for x in run.stdout.splitlines()
                if x.startswith("PLACEMENTS "))
    got = json.loads(line[len("PLACEMENTS "):])
    assert got["axis_types"] == ["Explicit", "Explicit"]
    for h in ("56", "25", "32"):
        # constrain returned its input; jit's output is on one device
        assert got["explicit"][h] == [True, "SingleDeviceSharding", 1], h
    for h, ways in (("56", 8), ("40", 8), ("12", 4), ("25", 1)):
        assert ways == math.gcd(int(h), 16)
        # ``ways`` distinct shards, each h / ways heads
        assert got["auto"][h] == [ways, int(h) // ways], h
