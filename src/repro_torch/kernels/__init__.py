"""Kernels: CUDA C++ for Hopper under ``csrc/`` (flash attention, flash
decode, the RWKV6 WKV recurrence), each with its plain PyTorch version, and
the ``ops`` dispatch the model calls."""
