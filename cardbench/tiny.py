"""Cells cut to a size the CPU tests can hold: every width small, every
kind of layer kept, the traffic short. Only the tests use them; the
benchmark runs the cells as ``BENCHMARK.json`` names them."""

from __future__ import annotations

import copy

from . import spec

SIZES = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256}
# the control's test: wide enough that float8's error shows as at the
# cells' widths
WIDER = {"n_layers": 4, "d_model": 256, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 64, "d_ff": 512, "vocab_size": 4096}


def cell(workload: str, param_dtype: str = "float32",
         sizes: dict = SIZES) -> spec.Cell:
    c = spec.load_cell(workload)
    c.config, c.mix = copy.deepcopy(c.config), copy.deepcopy(c.mix)
    model = c.config["model"]
    model.update(sizes, param_dtype=param_dtype)
    if model.get("hybrid_ssm"):
        model.update(ssm_state=8, sliding_window=16)
    else:
        model.update(sliding_window=32)
    if c.mix["kind"] == "train":
        c.mix.update(sequences=4, seq_len=64)
    else:
        c.mix.update(lengths=[[24, 2], [48, 1]], check_cycles=2,
                     check_batches=3)
    return c
