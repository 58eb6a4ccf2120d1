"""Dense decoder of the port (``repro/models/transformer.py``, dense path only).

Parameters are one ordered ``name → tensor`` dict in the reference's layout
and the reference's ``jax.tree.flatten`` order (see :func:`tree_paths`):
block parameters are stacked over layers, ``(num_layers, d_in, d_out)`` for
a linear, and layer ``r`` reads row ``r``; linears are ``(d_in, d_out)``
and apply as ``x @ w``. For llama3.2-1b the order is::

    blocks/0/attn/{wk,wo,wq,wv}/w, blocks/0/mlp/{gate,in,out}/w,
    blocks/0/norm1/scale, blocks/0/norm2/scale, embed/table, final_norm/scale

so flattening the dict into buckets is a concatenation in dict order that
matches the reference's buckets element for element.

The reference wraps each layer in ``jax.checkpoint`` (rematerialisation),
which changes no numbers; the port keeps the activations instead, which is
affordable at the slice's sizes. MoE, Mamba, encoder, patch tokens and the
KV cache are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = dict[str, torch.Tensor]
BLOCK = "blocks/0/"  # the one pattern position of a homogeneous decoder


def tree_paths(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict/list tree in ``jax.tree.flatten``
    order: dict keys sorted, list order kept. Leaves are anything else."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_paths(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from tree_paths(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


class _Init:
    """Leaf of the parameter spec tree: shape and initializer kind."""

    def __init__(self, shape: tuple[int, ...], kind: str):
        self.shape, self.kind = shape, kind


def param_spec(cfg: ModelConfig) -> dict[str, _Init]:
    """Ordered name → (shape, kind) of the decoder's parameters."""
    n, d, hd, ff, v = cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    lin = lambda d_in, d_out: {"w": _Init((n, d_in, d_out), "linear")}
    block = {
        "attn": {
            "wq": lin(d, cfg.num_heads * hd),
            "wk": lin(d, cfg.num_kv_heads * hd),
            "wv": lin(d, cfg.num_kv_heads * hd),
            "wo": lin(cfg.num_heads * hd, d),
        },
        "mlp": {"in": lin(d, ff), "out": lin(ff, d), "gate": lin(d, ff)},
        "norm1": {"scale": _Init((n, d), "ones")},
        "norm2": {"scale": _Init((n, d), "ones")},
    }
    tree = {
        "embed": {"table": _Init((v, d), "embed")},
        "final_norm": {"scale": _Init((d,), "ones")},
        "blocks": [block],
    }
    return dict(tree_paths(tree))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Params:
    """Random parameters with the reference's shapes and distributions
    (``transformer.py:57-116``): N(0, 1/d_in) linears, 0.02·N(0, 1) embedding,
    ones for norm scales. The values differ from the reference's (another
    generator); to share weights with it, use
    :func:`repro_torch.models.convert.from_jax_params`.

    The draws happen on the generator's device; the result is moved to
    ``device`` (default: the generator's).
    """
    dtype = getattr(torch, cfg.param_dtype)
    gdev = generator.device
    out: Params = {}
    for name, spec in param_spec(cfg).items():
        if spec.kind == "ones":
            t = torch.ones(spec.shape, dtype=torch.float32, device=gdev)
        else:
            t = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=gdev)
            fan_in = spec.shape[-2] if spec.kind != "embed" else None
            t.mul_(0.02 if fan_in is None else 1.0 / math.sqrt(fan_in))
        out[name] = t.to(device=device or gdev, dtype=dtype)
    return out


def _block(bp: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = layers.apply_rms_norm(bp["norm1/scale"], x)
    q = layers.apply_linear(bp["attn/wq/w"], h).view(b, s, hq, hd)
    k = layers.apply_linear(bp["attn/wk/w"], h).view(b, s, hkv, hd)
    v = layers.apply_linear(bp["attn/wv/w"], h).view(b, s, hkv, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = layers.causal_attention(q, k, v)
    x = x + layers.apply_linear(bp["attn/wo/w"], out.reshape(b, s, hq * hd))
    h = layers.apply_rms_norm(bp["norm2/scale"], x)
    return x + layers.apply_mlp(bp["mlp/in/w"], bp["mlp/gate/w"], bp["mlp/out/w"], h)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) → logits (B, S, V_pad) in the compute dtype."""
    cdtype = getattr(torch, cfg.compute_dtype)
    x = layers.apply_embedding(params["embed/table"], tokens, cdtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    # unbind once: its backward stacks the per-layer grads into one tensor
    stacked = {k[len(BLOCK):]: v.unbind(0) for k, v in params.items() if k.startswith(BLOCK)}
    for r in range(cfg.num_layers):
        x = _block({k: v[r] for k, v in stacked.items()}, cfg, x, positions)
    x = layers.apply_rms_norm(params["final_norm/scale"], x)
    return x @ params["embed/table"].to(x.dtype).T  # tied head


def loss_fn(params: Params, cfg: ModelConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy on fp32 logits (log-softmax NLL, mean over tokens)."""
    logits = forward(params, cfg, batch["tokens"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss.detach()}
