"""The traffic, generated from the seed by the mix's parameters.

Token rows come from a frozen copy of ``repro_torch.train.data.synth_batch``:
each row repeats a random n-gram of the vocabulary, with a share of its
tokens replaced by noise, so the loss has structure to learn. A row set is
keyed by (seed, index): the same seed gives the same rows, and every index
gives new ones.
"""

from __future__ import annotations

import numpy as np


def token_rows(seed: int, index: int, rows: int, length: int, vocab: int,
               ngram: int, noise: float) -> np.ndarray:
    """(rows, length + 1) int64 tokens of row set ``index``: the copy of
    ``synth_batch``'s stream (its ``step`` is ``index``)."""
    rng = np.random.default_rng(
        np.uint64((seed * 1_000_003 + index * 7919) % 2**64))
    base = rng.integers(0, vocab, size=(rows, ngram), dtype=np.int64)
    reps = int(np.ceil((length + 1) / ngram))
    seq = np.tile(base, (1, reps))[:, : length + 1]
    hit = rng.random((rows, length + 1)) < noise
    return np.where(hit, rng.integers(0, vocab, size=(rows, length + 1)),
                    seq)


def train_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Step ``step``'s global batch: {"tokens", "labels"} (B, S) int32."""
    seq = token_rows(seed, step, mix["sequences"], mix["seq_len"], vocab,
                     mix["ngram"], mix["noise"])
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def length_cycle(mix: dict, seed: int, cycle: int) -> list:
    """The prompt lengths of cycle ``cycle``'s batches: every length of
    the mix as many times as it says, in an order drawn from (seed,
    cycle). Every cycle holds the same batches."""
    lengths = [n for n, times in mix["lengths"] for _ in range(times)]
    rng = np.random.default_rng([seed, cycle])
    return [lengths[i] for i in rng.permutation(len(lengths))]


def prompts(mix: dict, vocab: int, seed: int, index: int,
            length: int) -> np.ndarray:
    """Batch ``index``'s prompts: (requests, length) int64. Warm-up
    batches take negative indices, so they share no rows with the
    window's."""
    return token_rows(seed, index, mix["requests_per_batch"], length - 1,
                      vocab, mix["ngram"], mix["noise"])
