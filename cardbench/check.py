"""The numbers that decide ``correct``, each against its limit.

Training (the first steps that set-up drives through ``train_step``):
  loss_gap    the largest over those steps of |loss - reference's| /
              |reference's|
  grad_gap    the worst leaf's |norm of the first step's clipped gradient
              - the reference's| / max(the reference's norm of that leaf,
              of the median leaf)
  change_gap  the same of the norm of the parameters' change over the
              steps, over the leaves whose reference gradient is at least
              GRAD_FLOOR of the median leaf's (below it a leaf moves under
              Adam by round-off alone)
Serving (a sample of the window's finished requests):
  logit_gap   the widest gap by which a served token's reference logit
              lies below the reference's best, in logits
  logits_err  the largest relative L2 distance of a request's
              last-position logits from the reference's
  kv_err      the largest relative L2 distance, over the requests and
              the layers, of the K or the V ring that decode would read,
              slot by slot, from the ring the reference's K (after RoPE)
              and V fill: position p at slot p % slots, the last
              positions that fit, the other slots zero
  ssm_err     (hybrid) the same of the Mamba heads' final scan state and
              conv inputs
A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

import torch

GRAD_FLOOR = 1e-3


def _gap(got: dict, want: dict, leaves) -> float:
    med = statistics.median(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in leaves)


def worst_leaves(prog: dict, ref: dict, what: str, n: int = 3) -> list:
    """The ``n`` leaves of the largest gap of ``what`` ("grad" or
    "change"): [(leaf, program's norm, reference's norm, gap)]."""
    med = statistics.median(ref[what].values())
    rows = [(k, prog[what][k], ref[what][k],
             abs(prog[what][k] - ref[what][k]) / max(ref[what][k], med,
                                                       1e-30))
            for k in ref[what]]
    return sorted(rows, key=lambda r: -r[3])[:n]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` as ``reference.train.steps`` returns them."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    leaves = list(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [k for k in leaves if ref["grad"][k] >= GRAD_FLOOR * med]
    return {"loss_gap": loss,
            "grad_gap": _gap(prog["grad"], ref["grad"], leaves),
            "change_gap": _gap(prog["change"], ref["change"], moved)}


@torch.no_grad()
def served_numbers(logits: torch.Tensor, served: torch.Tensor,
                   ref_logits: torch.Tensor) -> dict:
    """logits, ref_logits: (R, V) of R requests' last positions; served:
    (R,) the tokens the program answered."""
    logits, ref_logits = logits.float(), ref_logits.float()
    best = ref_logits.max(-1).values
    took = ref_logits.gather(-1, served.long()[:, None])[:, 0]
    err = (logits - ref_logits).norm(dim=-1) / ref_logits.norm(dim=-1)
    return {"logit_gap": float((best - took).max()),
            "logits_err": float(err.max())}


def ring(keys: torch.Tensor, slots: int) -> torch.Tensor:
    """(slots, ...) the ring of ``slots`` slots that the positions of
    ``keys`` (S, ...) fill in order: position p at slot p % slots, the
    last ``slots`` positions kept, the slots no position reached zero."""
    s = keys.shape[0]
    out = keys.new_zeros((slots,) + tuple(keys.shape[1:]))
    pos = torch.arange(max(0, s - slots), s, device=keys.device)
    out[pos % slots] = keys[pos]
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.to(want.device).float() - want).norm()
                 / want.norm().clamp_min(1e-30))


@torch.no_grad()
def state_numbers(got: dict, want: list) -> dict:
    """got: one request's decode state as the program left it, "k", "v"
    (L, slots, Hkv, hd) and for a hybrid "conv" (L, K-1, di), "h" (L, di,
    n); want: the reference's layers, [{"k", "v": (S, Hkv, hd), "conv",
    "h"}] (``reference.model.hidden``'s ``states``)."""
    slots = got["k"].shape[1]
    out = {"kv_err": max(_rel(got[n][i], ring(layer[n], slots))
                         for i, layer in enumerate(want)
                         for n in ("k", "v"))}
    if "h" in got:
        out["ssm_err"] = max(_rel(got[n][i], layer[n])
                             for i, layer in enumerate(want)
                             for n in ("h", "conv"))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in limits
             if k in numbers}
    ok = len(shown) == len(limits) and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in shown.values())
    return ok, shown
