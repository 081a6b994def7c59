"""Deterministic synthetic data pipeline, copied from ``repro.train.data``.

Produces a reproducible token stream keyed by (seed, step): restarts from
a checkpoint regenerate identical batches, which the resume test relies
on. The batches are numpy arrays on the host, bit for bit the JAX
package's; the train step moves them to the device.

The "language" is a mixture of repeated n-grams + noise so the loss has
learnable structure.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 0
    ngram: int = 8          # learnable structure period


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, step: int,
                data_cfg: DataConfig = DataConfig()) -> dict:
    """Global batch for ``step`` (numpy, host-resident)."""
    rng = np.random.default_rng(
        np.uint64(data_cfg.seed * 1_000_003 + step * 7919))
    b, s = shape.global_batch, shape.seq_len
    v = cfg.vocab_size
    # structured stream: each row repeats a random n-gram with noise
    base = rng.integers(0, v, size=(b, data_cfg.ngram), dtype=np.int64)
    reps = int(np.ceil((s + 1) / data_cfg.ngram))
    seq = np.tile(base, (1, reps))[:, : s + 1]
    noise = rng.random((b, s + 1)) < 0.1
    seq = np.where(noise, rng.integers(0, v, size=(b, s + 1)), seq)
    batch = {"labels": seq[:, 1:].astype(np.int32)}
    if cfg.embedding_stub:
        # frontend stub: precomputed patch/frame embeddings
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) * 0.02
        batch["embeds"] = emb
    else:
        batch["tokens"] = seq[:, :-1].astype(np.int32)
    return batch


class DataIterator:
    """Stateful iterator with checkpointable position."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig(), start_step: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.step = start_step

    def __next__(self) -> dict:
        batch = synth_batch(self.cfg, self.shape, self.step, self.data_cfg)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.data_cfg.seed}

    @classmethod
    def from_state(cls, cfg, shape, state: dict) -> "DataIterator":
        return cls(cfg, shape, DataConfig(seed=state["seed"]),
                   start_step=state["step"])
