"""PyTorch/CUDA port of the data plane in ``repro``.

The package mirrors ``repro``'s module names (``configs``, ``kernels``,
``models``, ``serve``, ``launch``) so each module's counterpart is easy to
find. It imports ``torch`` and numpy only: never ``jax``, never ``repro``.
Attention runs through CUDA C++ kernels written for Hopper (``sm_90a``)
under ``kernels/csrc/``; every kernel keeps a plain PyTorch version beside
it, which a wrapper uses only for tensors that lie on the CPU.
"""
