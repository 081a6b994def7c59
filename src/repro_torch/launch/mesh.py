"""Production meshes, ported from ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); the pod axis
is pure data parallelism (params replicated across pods; only the
per-step gradient all-reduce crosses pods).

The shapes and axis names are JAX's, so the rules give JAX's placements;
they are not refitted to an 8-GPU NVLink domain. The caller starts the
process group first (``torch.distributed.init_process_group``) with the
mesh's number of ranks, except for the dry run's meshes
(``make_fake_mesh``), which start their own. Defined as functions, so
importing this module touches no device or process group.
"""

from __future__ import annotations


def _mesh(shape: tuple, axes: tuple, device: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(data: int = 2, model: int = 4, multi_pod: bool = False,
                    device: str = "cuda"):
    """Small mesh for tests and single-host runs (gloo on the CPU)."""
    if multi_pod:
        return _mesh((2, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def make_fake_mesh(shape: tuple, axes: tuple):
    """A CPU mesh of ``prod(shape)`` ranks that exist only in this process,
    for the dry run (``launch/dryrun.py``): the ``fake`` process group on a
    ``FakeStore``, as this process's rank 0, whose collectives move nothing
    and return at once. A process group of another size is torn down
    first, so one process can build the (16, 16) and the (2, 16, 16) mesh
    in turn. Tensors on it are meta DTensors: each rank's local shard has
    its shape and allocates nothing."""
    import math

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    size = math.prod(shape)
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != size):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    return _mesh(shape, axes, "cpu")


def make_dryrun_mesh(*, multi_pod: bool = False):
    """The production mesh's shape and axis names on ``make_fake_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


# H100 SXM5 hardware constants (roofline denominators), from NVIDIA's H100
# Tensor Core GPU datasheet: dense bf16 tensor-core peak, HBM3 bandwidth,
# and NVLink 4's 900 GB/s total over 18 links, 450 GB/s each direction
PEAK_FLOPS_BF16 = 989e12         # per card
# each dtype's peak, for the compute term that counts the fp32 recurrences
# and router at the CUDA cores' fp32 rate (the same datasheet)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS_BF16, "float32": 67e12}
HBM_BW = 3.35e12                 # bytes/s per card
# The roofline's collective term divides by NVLINK_BW where JAX's divides
# by ICI_BW. It is optimistic for the production meshes: a ``model`` axis
# of 16 spans two 8-card NVLink nodes, and the data and pod axes span
# more, so their collectives cross the inter-node network, which is slower
# than NVLink.
NVLINK_BW = 450e9                # bytes/s per card, per direction
