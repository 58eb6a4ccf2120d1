"""Training loop of the port (``repro/train/loop.py:30-201``).

``run_training`` runs on the card unless the caller passes ``device="cpu"``
(as the tests do); without a CUDA device it raises instead of falling back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import torch

from repro_torch.comm import bucketize
from repro_torch.comm.bucketize import DEFAULT_BUCKET_SIZE
from repro_torch.core import optim
from repro_torch.core.compressors import get_compressor
from repro_torch.data import synthetic
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Params
from repro_torch.train import steps as steps_lib
from repro_torch.train.state import init_train_state


@dataclasses.dataclass
class TrainJob:
    """The reference's ``TrainJob`` fields this path reads. ``world`` is the
    in-process EF world W (the reference's data-mesh size); the slice runs
    ``strategy="ef_allgather"`` with a sign compressor and an SGD chain."""

    cfg: ModelConfig
    world: int = 1
    steps: int = 100
    batch: int = 8
    seq: int = 128
    lr: float = 0.02
    momentum: float = 0.0
    weight_decay: float = 0.0
    optimizer: str = "sgd"  # local per-worker chain
    strategy: str = "ef_allgather"
    compressor: str = "scaled_sign"
    seed: int = 0
    log_every: int = 10
    lr_schedule: str = "step_decay"  # the paper's /10-decimation schedule
    bucket_size: int = DEFAULT_BUCKET_SIZE


def _local_chain(job: TrainJob) -> optim.Transform:
    sched = {
        "constant": optim.constant_schedule(job.lr),
        "step_decay": optim.step_decay_schedule(job.lr, job.steps),
        "cosine": optim.cosine_schedule(job.lr, job.steps),
    }[job.lr_schedule]
    if job.optimizer == "sgd":
        return optim.sgd(sched, momentum=job.momentum, weight_decay=job.weight_decay)
    raise NotImplementedError(f"optimizer {job.optimizer!r} is not ported yet (the port has sgd)")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; never a silent fallback."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) to run on the CPU")
    return device


def run_training(
    job: TrainJob,
    batches: Iterator[dict] | None = None,
    log_fn: Callable | None = None,
    *,
    device=None,
    params: Params | None = None,
):
    """Train ``job.steps`` steps → ``(state, history)``.

    ``batches`` yields ``{"tokens", "labels"}`` of shape (batch, seq) (moved
    to ``device``); by default the synthetic token stream. ``params``
    overrides the random init; tensors of it already on ``device`` become the
    state's own and are updated in place (the others are copied there), so
    pass clones to keep the originals. ``history`` holds one record per logged step
    (every ``log_every`` steps and the last).
    """
    device = resolve_device(device)
    chain = _local_chain(job)
    comp = get_compressor(job.compressor)
    gen = torch.Generator(device=device).manual_seed(job.seed)
    if params is not None:
        params = {k: v.to(device) for k, v in params.items()}
    state = init_train_state(
        job.cfg, gen, chain, job.world, job.bucket_size, device=device, params=params
    )
    layout = bucketize.build_layout(state.params, job.bucket_size)
    step_fn = steps_lib.make_bucketed_ef_step(
        job.cfg, strategy=job.strategy, comp=comp, layout=layout, local_chain=chain, world=job.world
    )
    if batches is None:
        batches = synthetic.token_batches(job.seed, job.batch, job.seq, job.cfg.vocab_size)

    history = []
    t0 = time.perf_counter()
    for i in range(job.steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(batches).items()}
        state, (loss, metrics) = step_fn(state, batch)
        if i % job.log_every == 0 or i == job.steps - 1:
            rec = {"step": i, **{k: float(v) for k, v in metrics.items()}}
            rec["wall_s"] = time.perf_counter() - t0
            history.append(rec)
            if log_fn:
                log_fn(rec)
    return state, history
