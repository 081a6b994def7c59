"""The port's copy of the control plane (``core``, ``consistency``,
``coord``, ``faults``, ``fleet`` and ``obs``): every file is
byte-identical to the JAX package's, ``obs`` exports what the JAX one
does, and the copy behaves like the original, message for message, under
each read policy."""

from pathlib import Path

import pytest

from repro.coord.registry import ClusterRegistry as JaxClusterRegistry
from repro_torch.consistency import benchmark_configs
from repro_torch.coord.registry import ClusterRegistry
from repro_torch.obs import Metrics, Tracer

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = sorted(
    [f"core/{p.name}" for p in (SRC / "repro" / "core").glob("*.py")]
    + [f"consistency/{p.name}"
       for p in (SRC / "repro" / "consistency").glob("*.py")]
    + [f"faults/{p.name}" for p in (SRC / "repro" / "faults").glob("*.py")]
    + [f"fleet/{p.name}" for p in (SRC / "repro" / "fleet").glob("*.py")]
    + ["coord/kvstore.py", "coord/registry.py"]
    + [f"obs/{p.name}" for p in (SRC / "repro" / "obs").glob("*.py")
       if p.name != "__init__.py"])
POLICIES = sorted(benchmark_configs(variants=False))


def test_every_control_plane_file_is_copied():
    assert len(COPIED) == 36, COPIED
    dirs = ("core", "consistency", "faults", "fleet")
    port = {str(p.relative_to(SRC / "repro_torch"))
            for d in dirs for p in (SRC / "repro_torch" / d).glob("*.py")}
    assert port == {c for c in COPIED if c.split("/")[0] in dirs}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_byte_identical(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == \
        (SRC / "repro" / rel).read_bytes(), rel


def test_obs_exports_what_jax_exports():
    import repro.obs as jobs
    import repro_torch.obs as obs
    assert obs.__all__ == jobs.__all__
    for name in obs.__all__:
        mine, theirs = getattr(obs, name), getattr(jobs, name)
        if not callable(theirs):
            assert mine == theirs, name
        else:
            assert mine.__module__ == theirs.__module__.replace(
                "repro.", "repro_torch.", 1), name
    assert Metrics.__module__ == "repro_torch.obs.metrics"
    assert Tracer.__module__ == "repro_torch.obs.trace"


def drive(registry) -> tuple:
    """A trainer's traffic: register, commit two manifests, read, lose the
    coordinator's leader, commit and read again."""
    registry.register_worker("w0", {"arch": "a"})
    for step in (1, 2):
        registry.commit_checkpoint({"step": step, "path": "-", "n_arrays": 0,
                                    "sha256": "0" * 64, "extra": {}})
        registry.report_step_time("w0", step, 0.5)
    first = registry.latest_checkpoint()
    registry.coord.crash_leader()
    registry.heartbeat("w0")
    registry.commit_checkpoint({"step": 3, "path": "-", "n_arrays": 0,
                                "sha256": "0" * 64, "extra": {}})
    return (first["step"], registry.latest_checkpoint()["step"],
            sorted(registry.live_workers()), registry.coord.stats())


@pytest.mark.parametrize("policy", POLICIES)
def test_registry_behaves_as_the_original(policy):
    got = drive(ClusterRegistry(consistency=policy))
    want = drive(JaxClusterRegistry(consistency=policy))
    assert got == want
    assert got[:3] == (2, 3, ["w0"])


def test_leased_read_costs_no_messages():
    """The paper's point, through the port's registry: a leased read of the
    latest checkpoint sends no message under leaseguard, and a quorum round
    under quorum. (Over many reads, background heartbeats that fall inside
    a read's crank are counted too.)"""
    costs = {}
    for policy in ("leaseguard", "quorum"):
        reg = ClusterRegistry(consistency=policy)
        reg.commit_checkpoint({"step": 1, "path": "-", "n_arrays": 0,
                               "sha256": "0" * 64, "extra": {}})
        before = reg.coord.stats()["read_messages"]
        assert reg.latest_checkpoint()["step"] == 1
        stats = reg.coord.stats()
        assert stats["consistency"] == policy
        costs[policy] = stats["read_messages"] - before
    assert costs["leaseguard"] == 0
    assert costs["quorum"] > 0
