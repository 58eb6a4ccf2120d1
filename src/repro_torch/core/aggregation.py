"""Aggregation state and wire models (``repro/core/aggregation.py:108-112, 251-256``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class AggInfo(NamedTuple):
    """Per-step exchange metrics: bytes each worker receives, mean density."""

    wire_bytes_per_device: float
    mean_density: torch.Tensor  # fp32 scalar


class AggState(NamedTuple):
    """EF state of the bucketed exchange.

    ``worker_error`` holds one ``(W, n_buckets, bucket_size)`` fp32 residual
    stack per dtype group; worker ``i`` owns row ``i``, which its encode
    overwrites in place. The reference's ``server_error`` (``ef_alltoall``'s
    double-compression residual) is not ported, and its RNG key is absent
    because the sign compressors draw no randomness.
    """

    worker_error: tuple[torch.Tensor, ...]
    steps: int


def bucketed_sign_allgather_wire_bytes(n_buckets: int, bucket_size: int, world: int) -> float:
    """Bucketed ef_allgather wire model: (W−1) sign payloads per bucket, each
    bucket_size bits + one fp32 scale."""
    return (world - 1) * n_buckets * (bucket_size / 8.0 + 4.0)
