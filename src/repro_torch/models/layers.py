"""Neural building blocks of the dense decoder (``repro/models/layers.py``).

Plain functions on tensors with the reference's casts at the reference's
places: norms and RoPE in fp32, linears and the embedding in the compute
dtype, attention scores, softmax and the weighted sum in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def apply_rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding. x: (..., S, H, Dh); positions: (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (S, Dh/2)
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with w (d_in, d_out), in x's dtype (the reference's layout)."""
    return x @ w.to(x.dtype)


def apply_embedding(table: torch.Tensor, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table.to(compute_dtype)[tokens]


def apply_mlp(w_in: torch.Tensor, w_gate: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor):
    """SwiGLU: out(silu(gate(x)) · in(x))."""
    h = F.silu(apply_linear(w_gate, x)) * apply_linear(w_in, x)
    return apply_linear(w_out, h)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention, q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh) → (B, S, Hq, Dh).

    The kv heads are repeated to the query heads first, as the reference's
    ``chunked_attention`` does. Scores, softmax and the weighted sum run in
    fp32 over the whole sequence in one block; the reference's chunked online
    softmax is the same function with sums taken in another order.
    """
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    s_len = q.shape[1]
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v.float())
    return out.to(q.dtype)
