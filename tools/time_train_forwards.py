"""The recurrences' training forwards, timed on one NVIDIA GPU.

  python3 tools/time_train_forwards.py

At the training microbatches that chip_smoke.py trains, with its inputs
and time_ms, each forward that ``Wkv6Fn`` and ``MambaScanFn`` run (from
zeros, keeping the state at every 256-step chunk's start):

* WKV6 at rwkv6-3b's (B=2, S=4096, H=40, hd=64, fp32, the model's
  decays): the training entry (``wkv6_chunk_states``: summaries, carry and
  every chunk's y in one C call) beside the chain it replaced, the
  chunked body launched once a chunk from the last one's state, the
  starts copied and the outputs concatenated;
* the fused Mamba scan at hymba-1.5b's (B=4, S=4096, di=1600, n=16,
  bf16): the one launch that writes the starts (``mamba_chunk_states``)
  beside the same chain.

Each pair runs in two rounds, the second in reverse order (as
tools/time_backwards.py's ``rounds``), and then one call of each training
entry under ``torch.profiler`` (chip_smoke.py's ``profile``), whose
device time is printed by kernel.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def wkv6_chain(wk, r, k, v, w, u, chunk: int = 256):
    """The route before the training entry: ``wkv6`` once a chunk from the
    last chunk's state."""
    b, s, h, hd = r.shape
    state = torch.zeros((b, h, hd, hd), device=r.device)
    starts = state.new_empty((b, -(-s // chunk), h, hd, hd))
    ys = []
    for i, c0 in enumerate(range(0, s, chunk)):
        starts[:, i] = state
        ys.append(wk.wkv6(*(t[:, c0:c0 + chunk] for t in (r, k, v, w)), u,
                          state)[0])
    return torch.cat(ys, dim=1), state, starts


def mamba_chain(ms, dt, dt_bias, b, c, x, z, a_log, d_skip,
                chunk: int = 256):
    """The route before the starts output: ``mamba_scan`` once a chunk
    from the last chunk's state."""
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, a_log.shape[1]), device=dt.device)
    starts = h.new_empty((bsz, -(-s // chunk), *h.shape[1:]))
    outs = []
    for i, c0 in enumerate(range(0, s, chunk)):
        starts[:, i] = h
        part = [t[:, c0:c0 + chunk] for t in (dt, b, c, x, z)]
        outs.append(ms.mamba_scan(part[0], dt_bias, *part[1:], a_log,
                                  d_skip, h)[0])
    return torch.cat(outs, dim=1), h, starts


def main() -> int:
    if not torch.cuda.is_available():
        print("time_train_forwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    from time_backwards import rounds
    smi = cs.environment()
    gen = torch.Generator("cuda").manual_seed(7)
    s = cs.TRAIN_SEQ
    b = cs.TRAIN_BATCH // get_arch("rwkv6-3b").grad_accum
    inputs = cs.decay(cs.wkv6_train_inputs(gen, b, s))
    rounds(cs, f"WKV6 training forward, B={b}, S={s}, H={cs.RWKV_HEADS}, "
           f"hd={cs.RWKV_HD}, fp32", {
               "wkv6_train (one C call)":
               lambda: wk.wkv6_chunk_states(*inputs),
               "the chain (one launch a chunk)":
               lambda: wkv6_chain(wk, *inputs)}, iters=10)
    one = cs.time_ms(lambda: wk.wkv6_chunk_states(*inputs), 10)
    cs.profile("wkv6_train", lambda: wk.wkv6_chunk_states(*inputs), one)
    del inputs
    b = cs.TRAIN_BATCH // get_arch("hymba-1.5b").grad_accum
    inputs = cs.mamba_train_inputs(gen, b, s, torch.bfloat16)
    rounds(cs, f"Mamba scan training forward, B={b}, S={s}, "
           f"di={cs.MAMBA_DI}, n={cs.MAMBA_N}, bf16", {
               "mamba_scan_train (one launch)":
               lambda: ms.mamba_chunk_states(*inputs),
               "the chain (one launch a chunk)":
               lambda: mamba_chain(ms, *inputs)}, iters=10)
    one = cs.time_ms(lambda: ms.mamba_chunk_states(*inputs), 10)
    cs.profile("mamba_scan_train", lambda: ms.mamba_chunk_states(*inputs),
               one)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
