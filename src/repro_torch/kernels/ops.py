"""Public entry points of the bucket EF-sign layer, with device dispatch.

The tensor's device alone picks the path: a CPU tensor goes to the plain
version in :mod:`repro_torch.kernels.ref`, a CUDA tensor to the Hopper kernel
in :mod:`repro_torch.kernels.ef_sign` (which raises on anything it does not
take). There is no switch and no fallback: unlike the reference
(``repro/kernels/ops.py``), a bucket size that is a multiple of 32 but not of
4096 still runs the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ef_sign, ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no bucket EF-sign path for device {t.device}")


def ef_sign_bucket_step(
    g: torch.Tensor, e: torch.Tensor, fixed_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EF sign compression of a bucket stack (``repro/kernels/ops.py:96``).

    ``g``/``e`` are (nb, bs) fp32 (update and EF residual). Returns
    ``(words (nb, bs/32) int32, scales (nb,) f32, e_new (nb, bs) f32,
    dens (nb,) f32)``. One stats pass yields per-bucket L1 and L2², hence
    both the scale L1/bs (the zero padding of the last bucket counts in bs)
    and the density φ = L1²/(bs·L2²), 1.0 where L2² = 0. ``fixed_scale``
    selects the unscaled-sign wire format (the stats still give the density).
    """
    nb, bs = g.shape
    if bs % 32:
        raise ValueError(f"bucket_size must be a multiple of 32, got {bs}")
    card = _on_card(g)
    l1, l2sq = ef_sign.bucket_stats(g, e) if card else ref.bucket_stats_ref(g, e)
    # a tensor divisor keeps this a true division on the card too (PyTorch
    # divides by a host scalar through its reciprocal); XLA divides here too
    dens = torch.where(l2sq > 0, l1 * l1 / (float(bs) * l2sq), torch.ones_like(l1))
    if fixed_scale is not None:
        scales = torch.full((nb,), fixed_scale, dtype=torch.float32, device=g.device)
    else:
        scales = l1 * ref.reciprocal_f32(bs)  # the reference's l1 / bs, as XLA computes it
    if card:
        words, e_new = ef_sign.bucket_ef_sign_compress(g, e, scales)
    else:
        words, e_new = ref.bucket_ef_sign_compress_ref(g, e, scales)
    return words, scales, e_new, dens


def bucket_decompress_mean(words: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Mean of W bucket payload stacks: (W, nb, bs/32) + (W, nb) → (nb, bs)."""
    if _on_card(words):
        return ef_sign.bucket_sign_decompress_mean(words, scales)
    return ref.bucket_decompress_mean_ref(words, scales)

