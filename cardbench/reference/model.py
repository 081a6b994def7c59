"""The plain reference: the port's dense and hybrid decoders in fp32, in
plain PyTorch, written from the models' equations and not from the
port's code; it imports nothing of the port.

A layer: x += mixer(rms_norm(x)), then x += SwiGLU(rms_norm(x)). The
mixer is GQA attention with RoPE (half-split rotation), causal inside the
sliding window, or for the hybrid family 0.5 (attention + Mamba heads),
the Mamba heads reading the same normed input: in_proj to x and z, a
causal depthwise conv of 4 taps and SiLU, dt = softplus(x W_a W_b +
dt_bias), b and c from one projection, the selective scan h_t = exp(dt_t
a) h_{t-1} + dt_t x_t b_t with a = -exp(a_log), y_t = h_t c_t + d_skip
x_t, gated by silu(z), and out_proj. The final norm and the LM head give
fp32 logits; the loss is the mean next-token cross-entropy.

Every matrix product goes through a ``Precision``, and so do the
residual stream between layers and, in training, each microbatch's
gradient (``store``): ``FP32`` computes and keeps them in fp32 (the caller
turns TF32 off). ``FP8`` is the control, the reference computed one
precision below the configuration's bf16: it rounds both operands of
every product to float8 e4m3 with one scale a tensor, the gradient coming
back into a product too, and keeps the residual stream and each
microbatch's gradient in float8, where the program keeps them in bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
SCAN_TILE = 64          # steps of the scan's local loop
QUERY_CHUNK = 512       # queries whose scores exist at once
LOSS_CHUNK = 1024       # positions whose logits exist at once


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundIn(torch.autograd.Function):
    """float8 in the forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity forward; float8 on the gradient it passes back."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    """fp32 matrix products."""
    name = "fp32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, a, b)


class Float8(Precision):
    """Matrix products of float8 e4m3 operands, accumulated in fp32."""
    name = "fp8"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundIn.apply(t)

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundIn.apply(t) if t.requires_grad else _fp8(t)

    def mm(self, a, b):
        return _RoundGrad.apply(self.q(a) @ self.q(b))

    def einsum(self, eq, a, b):
        return _RoundGrad.apply(torch.einsum(eq, self.q(a), self.q(b)))


FP32, FP8 = Precision(), Float8()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotate (B, S, H, hd) by position: the first half of each head's
    dims pairs with the second."""
    hd = x.shape[-1]
    freqs = theta ** -(torch.arange(0, hd, 2, device=x.device,
                                    dtype=torch.float32) / hd)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attend_chunk(q, k, v, q0, k0, window, prec):
    """Queries q0.. of (B, Tq, H, hd) against keys k0.. (B, Tk, H, hd)."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qpos = torch.arange(q0, q0 + tq, device=q.device)[:, None]
    kpos = torch.arange(k0, k0 + tk, device=q.device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    p = torch.softmax(s.masked_fill_(~ok, float("-inf")), -1)
    return prec.einsum("bhqk,bkhd->bqhd", p, v)


def attention(q, k, v, window, prec, grad: bool) -> torch.Tensor:
    """Causal GQA attention, query head h reading KV head h // (H / Hkv),
    QUERY_CHUNK queries at a time against the keys they can see."""
    s, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    outs = []
    for q0 in range(0, s, QUERY_CHUNK):
        q1 = min(s, q0 + QUERY_CHUNK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window, prec)
        outs.append(checkpoint(_attend_chunk, *args, use_reentrant=False)
                    if grad else _attend_chunk(*args))
    return torch.cat(outs, 1)


def selective_scan(dt, a, u, c):
    """y_t = h_t c_t with h_t = exp(dt_t a) h_{t-1} + u_t from h = 0.
    dt (B, S, di), a (di, n), u (B, S, di, n), c (B, S, n). Tiles of
    SCAN_TILE steps run their local states from zero all at once; each
    tile's start state is then carried across tiles and added back with
    the tile's decay. Returns (y (B, S, di), the final state)."""
    bsz, s, di = dt.shape
    n = a.shape[-1]
    t = SCAN_TILE
    pad = -s % t
    m = (s + pad) // t
    log_da = F.pad(dt, (0, 0, 0, pad))[..., None] * a        # (B,S',di,n)
    log_da = log_da.view(bsz, m, t, di, n)
    u = F.pad(u, (0, 0, 0, 0, 0, pad)).view(bsz, m, t, di, n)
    # steps taken by unbind, not by index: an indexed step's backward
    # would build a gradient of the whole tensor for every step
    g, local = None, []
    for da, push in zip(torch.exp(log_da).unbind(2), u.unbind(2)):
        g = push if g is None else da * g + push
        local.append(g)
    local = torch.stack(local, 2)
    decay = torch.exp(log_da.cumsum(2))
    h = torch.zeros((bsz, di, n), dtype=dt.dtype, device=dt.device)
    starts = []
    for fade, end in zip(decay[:, :, -1].unbind(1),
                         local[:, :, -1].unbind(1)):
        starts.append(h)
        h = fade * h + end
    states = local + decay * torch.stack(starts, 1)[:, :, None]
    c = F.pad(c, (0, 0, 0, pad)).view(bsz, m, t, 1, n)
    y = (states * c).sum(-1).reshape(bsz, m * t, di)[:, :s]
    return y, h


def mamba(p: dict, x: torch.Tensor, m, prec, keep: dict | None = None
          ) -> torch.Tensor:
    """The Mamba heads; ``keep`` receives the state decode reads after
    the last position: "h" (di, n), the scan's final state, and "conv"
    (K-1, di), the conv's last K-1 inputs (zeros before the prompt)."""
    n = m.ssm_state
    xz = prec.mm(x, p["in_proj"])
    xi, z = xz.chunk(2, -1)
    k = p["conv_w"].shape[0]
    xp = F.pad(xi, (0, 0, k - 1, 0))
    s = xi.shape[1]
    conv = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xc = F.silu(conv + p["conv_b"])
    bc = prec.mm(xc, p["w_bc"])
    dt = F.softplus(prec.mm(prec.mm(xc, p["dt_a"]), p["dt_b"])
                    + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    u = (dt * xc)[..., None] * bc[..., None, :n]
    y, h = selective_scan(dt, a, u, bc[..., n:])
    if keep is not None:
        keep["h"], keep["conv"] = h[0], xp[0, -(k - 1):]
    y = (y + p["d_skip"] * xc) * F.silu(z)
    return prec.mm(y, p["out_proj"])


def block(lp: dict, x: torch.Tensor, m, positions, prec, grad: bool,
          keep: dict | None = None) -> torch.Tensor:
    """One layer; ``keep`` (one prompt row) receives what decode reads of
    it: "k", "v" (S, Hkv, hd), K after RoPE, and the Mamba heads' state."""
    b, s, _ = x.shape
    at = lp["attn"]
    normed = rms_norm(x, lp["ln1"], m.norm_eps)
    q, k, v = (prec.mm(normed, at[w]) for w in ("wq", "wk", "wv"))
    if m.qkv_bias:
        q, k, v = q + at["bq"], k + at["bk"], v + at["bv"]
    q = q.view(b, s, m.n_heads, m.hd)
    k = k.view(b, s, m.n_kv_heads, m.hd)
    v = v.view(b, s, m.n_kv_heads, m.hd)
    if m.qk_norm:
        q = rms_norm(q, at["q_norm"], m.norm_eps)
        k = rms_norm(k, at["k_norm"], m.norm_eps)
    q, k = rope(q, positions, m.rope_theta), rope(k, positions, m.rope_theta)
    if keep is not None:
        keep["k"], keep["v"] = k[0], v[0]
    o = attention(q, k, v, m.sliding_window, prec, grad)
    mixed = prec.mm(o.reshape(b, s, m.n_heads * m.hd), at["wo"])
    if m.hybrid_ssm:
        mixed = 0.5 * (mixed + mamba(lp["mamba"], normed, m, prec, keep))
    x = prec.store(x + mixed)
    h = rms_norm(x, lp["ln2"], m.norm_eps)
    mlp = lp["mlp"]
    gate = F.silu(prec.mm(h, mlp["w_gate"])) * prec.mm(h, mlp["w_up"])
    return prec.store(x + prec.mm(gate, mlp["w_down"]))


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def supported(m) -> None:
    if m.attn_free or m.n_experts or m.embedding_stub:
        raise NotImplementedError(
            "the reference has the dense and hybrid decoders only")


def hidden(params: dict, m, tokens: torch.Tensor, prec=FP32,
           grad: bool = False, states: list | None = None) -> torch.Tensor:
    """Final-normed hidden states (B, S, D) of ``tokens`` (B, S); with
    ``grad``, each layer and each attention chunk recomputed in the
    backward, so that one layer's activations exist at a time.
    ``params["layers"]`` is the stacked tree or a list of layer trees.
    ``states`` (one prompt row, no ``grad``) receives each layer's state
    as ``block`` keeps it."""
    supported(m)
    x = prec.store(params["embed"][tokens])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layers = params["layers"]
    for i in range(m.n_layers):
        lp = layers[i] if isinstance(layers, list) else _layer(layers, i)
        if grad:
            x = checkpoint(block, lp, x, m, positions, prec, True,
                           use_reentrant=False)
        else:
            keep = None if states is None else {}
            x = block(lp, x, m, positions, prec, False, keep)
            if keep is not None:
                states.append(keep)
    return rms_norm(x, params["final_norm"], m.norm_eps)


def head(params: dict, m) -> torch.Tensor:
    return params["embed"].T if m.tie_embeddings else params["lm_head"]


def _ce_sum(h, w, labels, prec):
    logits = prec.mm(h, w)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def loss(params: dict, m, tokens, labels, prec=FP32) -> torch.Tensor:
    """Mean next-token cross-entropy, differentiable."""
    h = hidden(params, m, tokens, prec, grad=True)
    w = head(params, m)
    total = 0.0
    for c0 in range(0, h.shape[1], LOSS_CHUNK):
        total = total + checkpoint(_ce_sum, h[:, c0:c0 + LOSS_CHUNK], w,
                                   labels[:, c0:c0 + LOSS_CHUNK], prec,
                                   use_reentrant=False)
    return total / labels.numel()


@torch.no_grad()
def logits_at(params: dict, m, tokens: torch.Tensor, prec=FP32,
              last_only: bool = True) -> torch.Tensor:
    """fp32 logits of the last position (B, V), or of every position (B,
    S, V), one row at a time."""
    w = head(params, m)
    rows = []
    for r in range(tokens.shape[0]):
        h = hidden(params, m, tokens[r:r + 1], prec)
        rows.append(prec.mm(h[:, -1:] if last_only else h, w)[0])
    out = torch.stack(rows)
    return out[:, 0] if last_only else out
