"""A closed loop of prompt batches through
``repro_torch.serve.engine.Engine.generate``, one greedy answer token each.

Each batch holds ``requests_per_batch`` prompts of one length (the engine
takes one length a batch and pads nothing); lengths come in cycles that
hold every length of the mix as often as it says, in an order drawn from
the seed. Set-up makes the weights and the engine and serves one batch of
each length. The window serves whole cycles until ``seconds`` have
passed, and at least the ``check_cycles`` the check draws from. A
request's time to first token runs from the batch's submission to its
token on the host.

The check: a sample of the window's batches drawn from the seed before
the window, the longest length among them. Of each, the last-position
logits the engine's sampler saw are kept with the tokens served, and the
decode state the engine built (the K/V ring, a hybrid's Mamba states) is
copied to the host behind the batch, into pinned buffers set up before the
window, so that the copy does not hold the host. Once the window has
closed and the program's state is freed, the reference runs their prompts.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import check, traffic, weights
from ..reference import model as ref
from . import free, log, sync


def sample(mix: dict, seed: int) -> list:
    """Indices of the checked batches: one of the longest length and
    ``check_batches - 1`` others, drawn from the first ``check_cycles``
    cycles, which every window finishes."""
    cyc = mix["check_cycles"]
    lengths = [n for c in range(cyc)
               for n in traffic.length_cycle(mix, seed, c)]
    rng = np.random.default_rng([seed, 1 << 20])
    longest = [i for i, n in enumerate(lengths) if n == max(lengths)]
    first = int(rng.choice(longest))
    rest = [i for i in range(len(lengths)) if i != first]
    return sorted([first] + [int(i) for i in rng.choice(
        rest, mix["check_batches"] - 1, replace=False)])


def _leaves(caches: dict) -> dict:
    """The decode state ``Engine.generate`` reads after the prompt: "k",
    "v" (L, B, slots, Hkv, hd) and, for a hybrid, "conv", "h"."""
    out = dict(caches["kv"])
    out.update(caches.get("mamba", {}))
    return out


class Served:
    """The engine of the seed's weights, serving batches by index; of each
    batch in ``checked`` the sampler's input is kept in ``logits``, its
    tokens in ``tokens``, and the decode state on the host in
    ``states``. ``close`` takes the engine's hooks out again."""

    def __init__(self, cell, seed: int, device, checked: list):
        from repro_torch.serve import engine as engine_mod
        from repro_torch.serve.engine import Engine, ServeConfig
        self.mix, self.seed, self.vocab = cell.mix, seed, cell.model.vocab_size
        self.device = torch.device(device)
        self.checked = set(checked)
        self.engine = Engine(cell.arch(), weights.make(cell, seed, device),
                             ServeConfig(max_new_tokens=cell.mix["new_tokens"],
                                         temperature=0.0), device=device)
        self.logits, self.tokens, self.states = {}, {}, {}
        self.shapes, self.pinned = {}, {}
        self.index, self.cache = None, None
        real = self.engine._sample

        def keep(logits, gen):
            if self.index in self.checked and self.index not in self.logits:
                self.logits[self.index] = logits.detach().clone()
            return real(logits, gen)
        self.engine._sample = keep

        self._module = engine_mod
        self._preallocate = engine_mod.preallocate_cache

        def preallocate(cfg, caches, total_len):
            out = self._preallocate(cfg, caches, total_len)
            if self.index < 0 or self.index in self.checked:
                self.cache = out
            return out
        engine_mod.preallocate_cache = preallocate

    def close(self) -> None:
        self._module.preallocate_cache = self._preallocate
        self.cache = None

    def pin(self, lengths: dict) -> None:
        """Host buffers for the checked batches' states, {index: prompt
        length}, shaped as the warm-up batch of that length left them."""
        pin = self.device.type == "cuda"
        for i, n in lengths.items():
            self.pinned[i] = {k: torch.empty(shape, dtype=dtype,
                                             pin_memory=pin)
                              for k, (shape, dtype) in self.shapes[n].items()}

    def __call__(self, index: int, length: int):
        """Serve batch ``index``: (ids (B, new), seconds from submission
        to the tokens on the host)."""
        tokens = traffic.prompts(self.mix, self.vocab, self.seed, index,
                                 length)
        self.index = index
        t = time.perf_counter()
        with record_function("cardbench.generate"):
            ids = self.engine.generate(tokens)
        took = time.perf_counter() - t
        cache, self.cache = self.cache, None
        if cache is not None:
            leaves = _leaves(cache)
            if index < 0:
                self.shapes[length] = {k: (tuple(v.shape), v.dtype)
                                       for k, v in leaves.items()}
            elif index not in self.states:
                to = self.pinned.pop(index, None)
                self.states[index] = {k: v.to("cpu", copy=True)
                                      for k, v in leaves.items()} \
                    if to is None else {k: to[k].copy_(v, non_blocking=True)
                                        for k, v in leaves.items()}
        if index in self.checked:
            self.tokens[index] = ids[:, 0]
        return ids, took

    def kept(self, checked: list):
        """(logits (R, V) fp32 on the host, tokens (R,), [each checked
        batch's state]) of the checked batches, or None if one was not
        served."""
        if any(i not in self.logits or i not in self.tokens
               or i not in self.states for i in checked):
            return None
        return (torch.cat([self.logits[i].float().cpu() for i in checked]),
                torch.as_tensor(np.concatenate([self.tokens[i]
                                                for i in checked])),
                [self.states[i] for i in checked])


@torch.no_grad()
def reference_rows(cell, seed: int, device, checked: list, prec=ref.FP32):
    """The reference over the checked batches' prompts, one row at a
    time: (batch's place in ``checked``, row, last-position logits (V,),
    the layers' decode state as ``reference.model.hidden`` keeps it)."""
    m, mix = cell.model, cell.mix
    params = weights.make(cell, seed, device, dtype=torch.float32)
    w = ref.head(params, m)
    for j, i in enumerate(checked):
        tokens = torch.as_tensor(traffic.prompts(
            mix, m.vocab_size, seed, i, length_of(mix, seed, i))).to(device)
        for r in range(tokens.shape[0]):
            layers = []
            h = ref.hidden(params, m, tokens[r:r + 1], prec, states=layers)
            yield j, r, prec.mm(h[:, -1:], w)[0, 0], layers


def reference(cell, seed: int, device, checked: list, states: list
              ) -> tuple:
    """The reference's last-position logits of the checked batches' rows
    (R, V) on the host, and the state numbers of the program's ``states``
    (``Served.kept``) against the reference's, the worst over the rows."""
    t = time.perf_counter()
    logits, worst = [], {}
    for j, r, last, layers in reference_rows(cell, seed, device, checked):
        logits.append(last.cpu())
        got = {k: v[:, r] for k, v in states[j].items()}
        for k, v in check.state_numbers(got, layers).items():
            worst[k] = max(worst.get(k, 0.0), v)
    log(f"reference: {len(checked)} batches in "
        f"{time.perf_counter() - t:.1f} s")
    return torch.stack(logits), worst


def run(cell, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    from .. import trace as tracing
    m, mix = cell.model, cell.mix
    checked = sample(mix, seed)
    serve = Served(cell, seed, device, checked)
    for j, n in enumerate(sorted({n for n, _ in mix["lengths"]})):
        serve(-1 - j, n)
    serve.pin({i: length_of(mix, seed, i) for i in checked})

    sync(device)
    t0 = time.perf_counter()
    index, cycle, batches = 0, 0, []
    while True:
        for n in traffic.length_cycle(mix, seed, cycle):
            ids, ttft = serve(index, n)
            bad = int(((ids < 0) | (ids >= m.vocab_size)).sum())
            batches.append((n, ids.shape[0], ttft, bad))
            index += 1
        cycle += 1
        if time.perf_counter() - t0 >= seconds \
                and cycle >= mix["check_cycles"]:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    log(f"window: {len(batches)} batches, {cycle} cycles in "
        f"{window_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    traced = None
    if trace:
        lengths = traffic.length_cycle(mix, seed, cycle)

        def one_cycle():
            for j, n in enumerate(lengths):
                serve(index + j, n)
        t = time.perf_counter()
        traced = tracing.capture(one_cycle, len(lengths), device)
        log(f"trace: {traced.kernels} kernels, read in "
            f"{time.perf_counter() - t:.1f} s")
    got = serve.kept(checked)
    serve.close()
    del serve
    free(device)
    numbers = {k: float("inf") for k in cell.limits}
    if got is not None:
        logits, tokens, states = got
        want, numbers = reference(cell, seed, device, checked, states)
        numbers.update(check.served_numbers(logits, tokens, want))
    return {"setup_s": t0 - started, "window_s": window_s,
            "units": len(batches), "attempted": sum(b[1] for b in batches),
            "failed": sum(b[3] for b in batches), "batches": batches,
            "tokens": sum(b[0] * b[1] for b in batches),
            "peak_bytes": peak, "trace": traced, "numbers": numbers,
            "model": m, "kind": "prefill",
            "weights": weights.census(weights.layout(cell))}


def length_of(mix: dict, seed: int, index: int) -> int:
    """Batch ``index``'s prompt length."""
    per = sum(t for _, t in mix["lengths"])
    return traffic.length_cycle(mix, seed, index // per)[index % per]
