"""Training state (``repro/train/state.py:34-70``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.comm import bucketize, compressed
from repro_torch.core import optim
from repro_torch.core.aggregation import AggState
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class TrainState:
    """Mutable: the step updates params, worker state and residuals in place."""

    params: transformer.Params
    opt_state: list[Any]  # one local-chain state per EF worker
    agg_state: AggState
    step: int = 0


def init_train_state(
    cfg: ModelConfig,
    generator: torch.Generator,
    local_chain: optim.Transform,
    world: int,
    bucket_size: int,
    device=None,
    params: transformer.Params | None = None,
) -> TrainState:
    """Fresh state of a bucketed EF run over ``world`` in-process workers.

    ``params`` overrides the random init (e.g. weights carried over from the
    JAX package with :func:`repro_torch.models.convert.from_jax_params`).
    """
    if params is None:
        params = transformer.init_params(cfg, generator, device)
    layout = bucketize.build_layout(params, bucket_size)
    agg = AggState(
        worker_error=compressed.init_error_buckets(layout, world, device),
        steps=0,
    )
    return TrainState(params, [local_chain.init(params) for _ in range(world)], agg)
