"""One driver a kind of traffic: ``drivers/<kind>.py``'s ``run(cell,
seed, seconds, trace, device, started)`` sets the cell up, runs its
window, traces a slice when asked, frees the program's state, runs the
reference and returns the run's record, which the metric readers read:

  setup_s, window_s   process start to the window, and the window
  units, attempted, failed, tokens
  unit_bound_s        train: the hand bound of one step
  batches             prefill: [(prompt length, requests, seconds)]
  peak_bytes          torch.cuda.max_memory_allocated() after the window
  trace               a ``trace.Trace`` of a slice after the window, or None
  numbers             the correctness check's numbers
  model, kind, weights
"""

from __future__ import annotations

import gc
import sys
import time

import torch

_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with seconds since import."""
    print(f"[{time.perf_counter() - _T0:8.2f}] {msg}", file=sys.stderr,
          flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    """Give the program's freed memory back before the reference runs,
    and run the reference's fp32 products in fp32, not TF32."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
