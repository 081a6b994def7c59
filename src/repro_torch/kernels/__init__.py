"""Attention kernels: CUDA C++ for Hopper under ``csrc/``, each with its
plain PyTorch version, and the ``ops`` dispatch the model calls."""
