"""Sign compressors of the port (``repro/core/compressors.py:44-61, 213-266``).

The slice ships the sign family only: :class:`ScaledSignCompressor` (the
paper's EF-SIGNSGD operator, C(v) = (‖v‖₁/d)·sign(v)) and
:class:`UnscaledSignCompressor` (plain sign with a fixed scale). The other
compressors of the reference are still to be ported (ROADMAP.md).

Wire format, shared with the CUDA kernels: bit = 1 iff x ≥ 0 (so −0.0 → 1
and NaN → 0), LSB first, element 32j+i is bit i of word j, padding bits 0.
Words are held as ``torch.int32``; their bits are the reference's ``uint32``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ref import PACK_WIDTH, pack_bits


def packed_len(n: int) -> int:
    return (n + PACK_WIDTH - 1) // PACK_WIDTH


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Pack ``x ≥ 0`` of a 1-D vector into ``packed_len(n)`` int32 words."""
    n = x.shape[0]
    bits = torch.zeros(packed_len(n) * PACK_WIDTH, dtype=torch.bool, device=x.device)
    bits[:n] = x >= 0
    return pack_bits(bits)


@dataclasses.dataclass(frozen=True)
class ScaledSignCompressor:
    """C(v) = (‖v‖₁/d)·sign(v); δ = φ(v) = ‖v‖₁²/(d‖v‖₂²) (Lemma 8)."""

    name: str = "scaled_sign"

    def wire_bits(self, n: int) -> int:
        return packed_len(n) * PACK_WIDTH + 32


@dataclasses.dataclass(frozen=True)
class UnscaledSignCompressor:
    """Plain sign with a fixed scale — not δ-approximate (the counterexamples)."""

    scale: float = 1.0
    name: str = "sign"

    def wire_bits(self, n: int) -> int:
        return packed_len(n) * PACK_WIDTH


Compressor = ScaledSignCompressor | UnscaledSignCompressor

_TABLE = {"scaled_sign": ScaledSignCompressor, "sign": UnscaledSignCompressor}


def get_compressor(name: str, **kw) -> Compressor:
    if name not in _TABLE:
        raise ValueError(f"compressor {name!r} is not ported yet; the port has {sorted(_TABLE)}")
    return _TABLE[name](**kw)

