"""Plain PyTorch versions of the bucket EF-sign kernels.

They define what the CUDA kernels in ``ef_sign.py`` compute, run on any
device, and keep the reference's arithmetic (``repro/kernels/ref.py``)
operation for operation, so that on the CPU they agree with the JAX package
bitwise wherever the reference is elementwise.

Layout: ``(n_buckets, bucket_size)`` fp32 stacks, ``bucket_size % 32 == 0``,
each bucket packing into ``bucket_size / 32`` sign words. Words are held in
``torch.int32`` storage (``torch.uint32`` has no shifts or sums on the CPU);
the bits are those of the reference's ``uint32`` words, and
``numpy.ndarray.view(np.uint32)`` reads them as such.
"""

from __future__ import annotations

import numpy as np
import torch

PACK_WIDTH = 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK_WIDTH, dtype=torch.int32, device=device)


def reciprocal_f32(n: int) -> float:
    """``1/n`` rounded once to fp32.

    XLA rewrites a division by a constant into a multiplication by the
    constant's fp32 reciprocal, so the reference's ``x / n`` is ``x * (1/n)``
    in fp32 (not the correctly rounded quotient). The port multiplies by this
    value wherever the reference divides by a constant, which keeps W = 3 or
    bucket_size = 96 bitwise-equal.
    """
    return float(np.float32(1.0) / np.float32(n))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32k) bool → (..., k) int32 words; bit i of word j is element 32j+i.

    The 32 shifted bits are disjoint, so their int32 sum is their OR and can
    never overflow (bit 31 is INT32_MIN and the rest sum to at most 2³¹−1).
    """
    lead, n = bits.shape[:-1], bits.shape[-1]
    b = bits.to(torch.int32).reshape(*lead, n // PACK_WIDTH, PACK_WIDTH)
    return torch.sum(b << _shifts(bits.device), dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words → (..., 32k) ±1 fp32 (bit 1 → +1)."""
    bits = (words.unsqueeze(-1) >> _shifts(words.device)) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * PACK_WIDTH)
    return 2.0 * bits.to(torch.float32) - 1.0


def bucket_stats_ref(g: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket (‖p‖₁, ‖p‖₂²) of p = g + e.  (nb, bs) → 2×(nb,)."""
    p = g.float() + e.float()
    return p.abs().sum(dim=-1), (p * p).sum(dim=-1)


def bucket_ef_sign_compress_ref(
    g: torch.Tensor, e: torch.Tensor, scales: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """p = g + e; words = pack(p ≥ 0) (nb, bs/32) int32; e_new = p − scale_b·sign(p)."""
    p = g.float() + e.float()
    bits = p >= 0  # NaN → False, −0.0 → True
    delta = scales[:, None] * (2.0 * bits.to(torch.float32) - 1.0)
    return pack_bits(bits), p - delta


def bucket_sign_decode_ref(words: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(nb, bs/32) int32 + (nb,) scales → (nb, bs) fp32 of ±scale_b."""
    return scales[:, None] * unpack_bits(words)


def bucket_decompress_mean_ref(words: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Mean of W payload stacks: (W, nb, bs/32) int32 + (W, nb) → (nb, bs) fp32.

    Sequential accumulation in sender order from a zero accumulator, for any
    W — the reference's unrolled loop (W ≤ 64) and its ``fori_loop`` (W > 64)
    are the same sequence — then the multiplication by the fp32 reciprocal of
    W that XLA makes of the reference's ``acc / W``.
    """
    w, nb, m = words.shape
    acc = torch.zeros((nb, m * PACK_WIDTH), dtype=torch.float32, device=words.device)
    for i in range(w):
        acc = acc + bucket_sign_decode_ref(words[i], scales[i])
    return acc * reciprocal_f32(w)
