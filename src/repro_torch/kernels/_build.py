"""Build and load the CUDA C++ kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. No
PyTorch header is included, so a build takes seconds. All sources build in
parallel, one ``nvcc`` each, the first time any kernel is asked for. A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused. A missing ``nvcc`` or a
failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return str(nvcc)


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        digest.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


@functools.cache
def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all in
    parallel. Returns {kernel source stem: library path}. ``-Xptxas -v``
    output (registers, shared memory, spills) goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _library_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = open(lib.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for name, (proc, tmp, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                tmp.replace(todo[name])
        if failed:
            logs = "\n".join(todo[n].with_suffix(".log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    lib = ctypes.CDLL(str(build_all()[name]))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
