"""The backward that ``Wkv6Fn`` and ``MambaScanFn`` share: the gradient of
a recurrence run from the states kept at its chunk boundaries.

JAX's ``chunked_time_scan`` (``repro/models/ssm.py:30-47``) keeps the
state at every ``TIME_CHUNK`` boundary and rematerialises each chunk in
the backward. Here each chunk is recomputed from its kept start state by
a differentiable chunked form (``wkv6_chunked``, ``mamba_scan_chunked``)
and autograd gives its inputs' gradients, given the gradient of its final
state, which is that of the next chunk's start state. That carry is the
only thing that runs from chunk to chunk, and it is cheap: the final state
is ``fade * start + (terms free of start)`` elementwise, so

    d start_c = (d start_c from the chunk's own outputs) + fade_c * d end_c

Both parts come from the chunk's graph: the first is one autograd pass to
the start state alone. So the chunks of a group are recomputed together,
as one batch of B x chunks rows: two passes over one graph in place of a
graph per chunk, and as many times fewer kernel launches as the group has
chunks (chunk by chunk, the backward is launch-bound on the card:
tools/time_backwards.py). ``steps`` bounds the steps recomputed at once,
and so the backward's memory.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# the steps between kept states: JAX's TIME_CHUNK (repro/models/ssm.py:28)
TIME_CHUNK = 256


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """A recurrence's type: fp32, or fp64 for fp64 inputs (the tests' exact
    check of a backward's algebra)."""
    return torch.promote_types(dtype, torch.float32)


def remat_backward(fn: Callable, seq: Sequence[torch.Tensor],
                   params: Sequence[torch.Tensor], starts: torch.Tensor,
                   dout: torch.Tensor, dfinal: Optional[torch.Tensor],
                   fade: Callable, chunk: int, steps: int
                   ) -> tuple[list, list]:
    """Gradients of ``fn`` run chunk by chunk over ``seq``.

    fn(*seq parts (rows, T, ...), *params, start) -> (out, final): the
    recurrence over rows of T steps, each from its own start state.
    seq: the (B, S, ...) inputs; params: inputs shared by every step;
    starts: (B, chunks, *state), the state at each ``chunk``-step chunk's
    start; dout: the gradient of out (B, S, ...); dfinal: that of the
    final state (None: zeros). fade(seq parts, params) -> d final / d start
    of each row, elementwise (broadcast to the state's shape), computed
    without grad. Up to ``steps`` steps of full chunks are recomputed
    together; a ragged last chunk alone. Returns (the seq inputs'
    gradients in their dtypes, the params' gradients summed over chunks).
    """
    b, s = seq[0].shape[:2]
    full, tail = divmod(s, chunk)
    per = max(1, steps // chunk)
    groups = [(i, min(per, full - i), chunk) for i in range(0, full, per)]
    if tail:
        groups.append((full, 1, tail))
    state = starts.shape[2:]
    grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in seq]
    leaves_p = [p.detach().requires_grad_() for p in params]
    totals = [torch.zeros_like(p) for p in leaves_p]
    carry = torch.zeros_like(starts[:, 0]) if dfinal is None \
        else dfinal.to(starts.dtype)
    for first, count, length in reversed(groups):
        t0, t1 = first * chunk, first * chunk + count * length

        def rows(t):                  # (B, S, ...) -> (B x count, T, ...)
            return t[:, t0:t1].reshape(b * count, length, *t.shape[2:])

        leaves = [rows(t).detach().requires_grad_() for t in seq]
        start = starts[:, first:first + count].reshape(
            b * count, *state).detach().requires_grad_()
        d_out = rows(dout)
        with torch.enable_grad():
            out, final = fn(*leaves, *leaves_p, start)
        local, = torch.autograd.grad(out, start, d_out, retain_graph=True)
        with torch.no_grad():
            decay = fade(leaves, leaves_p).view(b, count, *state[:-1], -1)
        local = local.view(b, count, *state)
        ends = []
        for c in reversed(range(count)):
            ends.append(carry)
            carry = torch.addcmul(local[:, c], decay[:, c], carry)
        ends = torch.stack(ends[::-1], dim=1).view(b * count, *state)
        got = torch.autograd.grad((out, final), leaves + leaves_p,
                                  (d_out, ends))
        for g, d in zip(grads, got):
            g[:, t0:t1] = d.reshape(b, count * length, *d.shape[2:])
        for total, d in zip(totals, got[len(seq):]):
            total += d
    return grads, totals
