"""The ``ef_allgather`` bucketed aggregator over an in-process EF world.

Port of the ``ef_allgather`` branch of ``repro/comm/collective.py:147-260``.
In the reference, each of W devices runs the aggregator body under a
fully-manual ``shard_map``: EF-encode its own ``(n_buckets, bucket_size)``
slice, all-gather the payloads, decode the mean. Here the W EF workers run
in one process on one device, one after another:

* :meth:`BucketedAggregator.encode` is one worker's half: per dtype group,
  the fused EF sign step over its buckets and residual. The residual row is
  overwritten in place and only the small payload (words and scales) is
  kept, so no more than one worker's bucket-sized temporaries are ever
  alive.
* :meth:`BucketedAggregator.reduce` is the exchange: the "all-gather" stacks
  the W payloads (:mod:`repro_torch.comm.backends.xla`) and one decode-mean
  per group runs over the ``(W, nb, bs/32)`` words.

That is the reference's arithmetic on the reference's operands, and its
metrics: ``wire_bytes_per_device`` counts the (W−1)·nb payloads each worker
receives, and ``mean_density`` is the mean over workers of the mean over
groups of the per-bucket densities.

Other strategies (``dense``, ``ef_ring``, ``ef_alltoall``,
``majority_vote`` and the robust ones) are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.comm import bucketize, compressed
from repro_torch.comm.backends import xla
from repro_torch.core.aggregation import AggInfo
from repro_torch.core.compressors import Compressor

STRATEGIES = ("ef_allgather",)


class WorkerMessage(NamedTuple):
    """What one worker contributes to the exchange."""

    payloads: tuple[compressed.BucketPayload, ...]  # one per dtype group
    density: torch.Tensor  # fp32 scalar: mean over groups of the bucket-mean density


class BucketedAggregator:
    """``ef_allgather`` over ``world`` in-process EF workers."""

    def __init__(self, strategy: str, comp: Compressor, layout: bucketize.BucketLayout, world: int):
        if strategy not in STRATEGIES:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet; the port has {STRATEGIES}"
            )
        if not compressed.is_sign(comp):
            raise NotImplementedError(f"compressor {comp.name!r} is not ported yet")
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.strategy, self.comp, self.layout, self.world = strategy, comp, layout, world

    def encode(self, buckets: Sequence[torch.Tensor], err: Sequence[torch.Tensor]) -> WorkerMessage:
        """One worker: EF-encode its buckets; ``err`` rows are updated in place."""
        payloads, dens = [], []
        for group, b, e in zip(self.layout.groups, buckets, err):
            payload, new_err, d_b = compressed.ef_encode_buckets(self.comp, b, e, valid=group.valid)
            e.copy_(new_err)
            del new_err
            payloads.append(payload)
            dens.append(d_b.mean())
        return WorkerMessage(tuple(payloads), torch.stack(dens).mean())

    def reduce(self, messages: Sequence[WorkerMessage]) -> tuple[tuple[torch.Tensor, ...], AggInfo]:
        """The exchange: gather the W payloads, decode their mean per group."""
        if len(messages) != self.world:
            raise ValueError(f"{len(messages)} messages for a world of {self.world}")
        bs = self.layout.bucket_size
        outs = []
        wire_bits = 0
        for gi, group in enumerate(self.layout.groups):
            gathered = xla.gather_payload([m.payloads[gi] for m in messages])
            outs.append(compressed.decode_mean_buckets(self.comp, gathered, bs))
            # every worker receives the other W−1 workers' payloads
            wire_bits += (self.world - 1) * group.n_buckets * self.comp.wire_bits(bs)
        density = torch.stack([m.density for m in messages]).mean()
        return tuple(outs), AggInfo(wire_bits / 8.0, density)

