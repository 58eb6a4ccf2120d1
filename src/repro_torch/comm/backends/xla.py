"""The all-gather transport over an in-process EF world (``repro/comm/backends/xla.py``).

The reference's ``xla`` backend all-gathers every worker's payload along a
new leading worker axis with ``lax.all_gather``. Here the W workers of one
EF world run in one process on one device, so the all-gather is a stack of
their payloads in worker order: the same ``(W, nb, bs/32)`` words and
``(W, nb)`` scales the reference's decode receives.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.comm.compressed import BucketPayload


def gather_payload(payloads: Sequence[BucketPayload]) -> BucketPayload:
    """Stack W workers' payloads along a new leading worker axis."""
    keys = payloads[0].data.keys()
    return BucketPayload({k: torch.stack([p.data[k] for p in payloads]) for k in keys})
