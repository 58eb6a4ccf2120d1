"""Per-bucket sign compression with error feedback (``repro/comm/compressed.py``).

EF bookkeeping, per bucket b (paper Alg. 1):

    p_b   = u_b + e_b
    wire  = C(p_b)                      (packed sign words + one fp32 scale)
    e_b'  = (p_b − C⁻¹(wire)) · mask    (mask zeroes the padded tail)

The sign family runs through the fused bucket kernels
(:func:`repro_torch.kernels.ops.ef_sign_bucket_step`). The other compressors
of the reference are still to be ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.compressors import Compressor, ScaledSignCompressor, UnscaledSignCompressor
from repro_torch.kernels import ops


class BucketPayload(NamedTuple):
    """Uniform wire payload of a bucket stack: ``{"words": (…, nb, bs/32)
    int32, "scale": (…, nb) f32}``, with a leading W axis once gathered."""

    data: dict[str, torch.Tensor]


def is_sign(comp) -> bool:
    return isinstance(comp, (ScaledSignCompressor, UnscaledSignCompressor))


def init_error_buckets(layout, world: int = 1, device=None) -> tuple[torch.Tensor, ...]:
    """Zero EF residuals: one (W, n_buckets, bucket_size) stack per dtype group."""
    return tuple(
        torch.zeros((world, g.n_buckets, layout.bucket_size), dtype=torch.float32, device=device)
        for g in layout.groups
    )


def ef_encode_buckets(
    comp: Compressor, buckets: torch.Tensor, err: torch.Tensor, *, valid: int | None = None
) -> tuple[BucketPayload, torch.Tensor, torch.Tensor]:
    """Compress ``p = buckets + err`` per bucket → ``(payload, new_err, density)``.

    ``valid`` is the group's true element count (``BucketGroup.valid``): the
    residual's padded tail is multiplied by 0.0, which is the reference's
    multiplication by ``valid_mask`` (×1.0 leaves every other element's bits
    as they are) without materialising a bucket-sized mask.
    """
    if not is_sign(comp):
        raise NotImplementedError(f"{comp.name}: only the sign compressors are ported")
    fixed = None if isinstance(comp, ScaledSignCompressor) else comp.scale
    words, scales, new_err, dens = ops.ef_sign_bucket_step(buckets, err, fixed_scale=fixed)
    if valid is not None:
        new_err.view(-1)[valid:].mul_(0.0)
    return BucketPayload({"words": words, "scale": scales}), new_err, dens


def decode_mean_buckets(
    comp: Compressor, gathered: BucketPayload, bucket_size: int
) -> torch.Tensor:
    """Mean reconstruction of W gathered payloads → (n_buckets, bucket_size) fp32."""
    if not is_sign(comp):
        raise NotImplementedError(f"{comp.name}: only the sign compressors are ported")
    words = gathered.data["words"]
    if words.shape[-1] * 32 != bucket_size:
        raise ValueError(f"{words.shape[-1]} words per bucket for bucket_size {bucket_size}")
    return ops.bucket_decompress_mean(words, gathered.data["scale"])
