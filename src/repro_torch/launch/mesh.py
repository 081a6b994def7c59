"""Production meshes, ported from ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); the pod axis
is pure data parallelism (params replicated across pods; only the
per-step gradient all-reduce crosses pods).

The shapes and axis names are JAX's, so the rules give JAX's placements;
they are not refitted to an 8-GPU NVLink domain. The caller starts the
process group first (``torch.distributed.init_process_group``) with the
mesh's number of ranks. Defined as functions, so importing this module
touches no device or process group.
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


# H100 SXM5 hardware constants (roofline denominators), from NVIDIA's H100
# Tensor Core GPU datasheet: dense bf16 tensor-core peak, HBM3 bandwidth,
# and NVLink 4's 900 GB/s total over 18 links, 450 GB/s each direction
PEAK_FLOPS_BF16 = 989e12         # per card
HBM_BW = 3.35e12                 # bytes/s per card
NVLINK_BW = 450e9                # bytes/s per card, per direction
