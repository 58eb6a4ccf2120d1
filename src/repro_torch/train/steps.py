"""The bucketed EF train step (``repro/train/steps.py:116-129, 405-536``).

One step of ``ef_allgather`` over W in-process EF workers:

1. each worker computes loss and grads on its ``(B/W, S)`` shard of the
   batch, runs its local optimizer chain, flattens its update into
   ``(nb, bs)`` fp32 buckets and EF-encodes them against its own residual
   (:meth:`~repro_torch.comm.collective.BucketedAggregator.encode`);
2. the W payloads are gathered and one decode-mean per dtype group yields the
   aggregated update (:meth:`~repro_torch.comm.collective.BucketedAggregator.reduce`);
3. the update is unflattened and added to the parameters.

The reference runs the W workers as a ``vmap`` over a leading worker axis
(``steps.py:477-493``); the port loops over them. The arithmetic is the
same, and after a worker is encoded only its payload (1/32 of its update)
stays alive, so peak memory holds one worker's gradients and buckets, not W.
"""

from __future__ import annotations

import torch

from repro_torch.comm import bucketize
from repro_torch.comm.collective import BucketedAggregator
from repro_torch.core import optim
from repro_torch.core.compressors import Compressor
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train.state import TrainState


def grad_fn(params: transformer.Params, cfg: ModelConfig, batch: dict):
    """``((loss, metrics), grads)`` of the mean loss — the reference's
    ``value_and_grad`` — with autograd over plain PyTorch ops."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = transformer.loss_fn(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), metrics), dict(zip(leaves, grads))


def split_workers(batch: dict, world: int, index: int) -> dict:
    """Worker ``index``'s rows of a (B, ...) batch: the reference's
    ``reshape(W, B/W, ...)[index]``."""
    out = {}
    for k, x in batch.items():
        if x.shape[0] % world:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by EF world {world}")
        per = x.shape[0] // world
        out[k] = x[index * per : (index + 1) * per]
    return out


def make_bucketed_ef_step(
    cfg: ModelConfig,
    *,
    strategy: str,
    comp: Compressor,
    layout: bucketize.BucketLayout,
    local_chain: optim.Transform,
    world: int,
):
    """``step(state, batch) -> (state, (loss, metrics))``; ``state`` is updated in place."""
    agg = BucketedAggregator(strategy, comp, layout, world)

    def train_step(state: TrainState, batch: dict):
        messages, losses = [], []
        for i in range(world):
            (loss, _), grads = grad_fn(state.params, cfg, split_workers(batch, world, i))
            updates, state.opt_state[i] = local_chain.update(
                grads, state.opt_state[i], state.params
            )
            buckets = bucketize.flatten_buckets(layout, updates)
            del grads, updates
            messages.append(agg.encode(buckets, [e[i] for e in state.agg_state.worker_error]))
            del buckets
            losses.append(loss)
        agg_buckets, info = agg.reduce(messages)
        optim.apply_updates(state.params, bucketize.unflatten_buckets(layout, agg_buckets))
        state.agg_state = state.agg_state._replace(steps=state.agg_state.steps + 1)
        state.step += 1
        metrics = {
            "loss": torch.stack(losses).mean(),
            "wire_bytes": info.wire_bytes_per_device,
            "density": info.mean_density,
        }
        return state, (metrics["loss"], metrics)

    return train_step
