"""Batched serving engine, ported from ``repro.serve.engine``: prefill, then
decode over a request batch against one preallocated cache (K/V, or RWKV's
fixed-size states)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..coord.registry import ClusterRegistry
from ..models import decode_step, init_decode_cache, prefill


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one this raises: nothing falls back
    to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "kernels' plain versions on the CPU")
    return dev


def preallocate_cache(cfg: ArchConfig, caches: dict, total_len: int) -> dict:
    """Prefill caches {"kv": {"k": (L, B, S, Hkv, hd), ...}} -> the decode
    caches of ``init_decode_cache`` for ``total_len`` positions, holding the
    prefill's K/V of position p at slot ``p % size``. A sliding-window
    config gets a ring of ``min(total_len, window)`` slots, which keeps the
    last ``window`` positions, so decode after a long prompt stays inside
    the window. JAX pads the full prefill cache instead, so its decode
    attends past the window (ROADMAP.md queue 3, a), and it rewrites the
    cache every step; here it is allocated once, and each decode step
    writes its slot in place. RWKV's prefill states already have their
    decode size and pass through, as JAX's engine skips their growth."""
    if cfg.attn_free:
        return caches
    k = caches["kv"]["k"]
    out = init_decode_cache(cfg, k.shape[1], total_len, device=k.device)
    s, size = k.shape[2], out["kv"]["k"].shape[2]
    pos = torch.arange(max(0, s - size), s, device=k.device)
    for name, c in caches["kv"].items():
        out["kv"][name][:, :, pos % size] = c[:, :, pos]
    return out


class Engine:
    """Single-host batched engine.

    ``registry``: any object with ``latest_checkpoint()``, read once (a
    leased read on the coordinator) to learn which model version is
    served. With no registry, ``consistency=`` stands up a coordinator
    (``coord.registry.ClusterRegistry``) with the named read policy of
    ``consistency`` (e.g. "leaseguard", "readindex").
    """

    def __init__(self, cfg: ArchConfig, params: dict,
                 serve_cfg: ServeConfig = ServeConfig(), registry=None,
                 consistency: Optional[str] = None, device=None) -> None:
        if registry is None and consistency is not None:
            registry = ClusterRegistry(consistency=consistency)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.registry = registry
        self.model_version: Optional[dict] = None
        if registry is not None:
            self.model_version = registry.latest_checkpoint()
        self.stats: dict = {}

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: Optional[int] = None
                 ) -> np.ndarray:
        """tokens: (B, S) prompt batch -> (B, new) generated ids (int32).
        Sets ``stats``: prefill ms and decode ms per token on the device's
        clock (CUDA events on the card, so no extra synchronisation)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b, s = tokens.shape
        n_new = max_new_tokens or self.scfg.max_new_tokens
        t0 = self._mark()
        logits, pre, pos = prefill(self.params, cfg, {"tokens": tokens})
        caches = preallocate_cache(cfg, pre, s + n_new)
        del pre
        gen = torch.Generator(self.device).manual_seed(self.scfg.seed)
        tok = self._sample(logits, gen)
        out = [tok]
        t1 = self._mark()
        for i in range(n_new - 1):
            logits, caches = decode_step(self.params, cfg, tok, caches,
                                         pos + i)
            tok = self._sample(logits, gen)
            out.append(tok)
        t2 = self._mark()
        ids = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        self.stats = {"prefill_ms": self._ms(t0, t1),
                      "decode_ms_per_token":
                          self._ms(t1, t2) / max(1, n_new - 1),
                      "requests": b, "new_tokens": b * n_new}
        return ids

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        if self.scfg.temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @staticmethod
    def _ms(start, end) -> float:
        if isinstance(start, torch.cuda.Event):
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3
