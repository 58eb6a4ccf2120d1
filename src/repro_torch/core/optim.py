"""Optimizer substrate of the port (``repro/core/optim.py:31-130, 220-226, 285-286``).

A :class:`Transform` is ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)`` over name → tensor
dicts. Updates flowing through a chain are descent directions;
:func:`apply_updates` adds them.

Unlike the reference's pure functions, the transforms here take ownership of
the ``updates`` dict they are given and may overwrite its tensors in place
(the gradients of one worker are never read again), which keeps one
gradient-sized buffer alive instead of two at full width. The arithmetic is
the reference's, operation for operation.

The slice ports ``sgd`` (weight decay, heavy-ball momentum, −lr scaling) and
the three schedules; ``signsgd``, ``signum``, ``adam`` and ``ef_sgd`` are
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

Schedule = Callable[[int], np.float32]
Params = dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]  # (updates, state, params) -> (updates, state)


class EmptyState(NamedTuple):
    pass


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


# ---------------------------------------------------------------------------
# schedules (fp32 values, as the reference's jnp.float32 arithmetic)
# ---------------------------------------------------------------------------


def constant_schedule(lr: float) -> Schedule:
    return lambda step: np.float32(lr)


def step_decay_schedule(lr: float, total_steps: int, decays=(0.5, 0.75), factor=0.1) -> Schedule:
    """The paper's schedule: /10 at 50% and 75% of training."""
    boundaries = [int(d * total_steps) for d in decays]

    def sched(step):
        k = sum(step >= b for b in boundaries)
        return np.float32(lr) * np.float32(factor) ** k

    return sched


def cosine_schedule(
    lr: float, total_steps: int, warmup: int = 0, final_frac: float = 0.1
) -> Schedule:
    f32 = np.float32

    def sched(step):
        s = f32(step)
        warm = min(f32(1.0), s / max(f32(1.0), f32(warmup)))
        prog = np.clip((s - f32(warmup)) / max(f32(1.0), f32(total_steps - warmup)), f32(0), f32(1))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
        return f32(lr) * warm * cos

    return sched


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


# ---------------------------------------------------------------------------
# basic blocks
# ---------------------------------------------------------------------------


class ScaleByLrState(NamedTuple):
    step: int


def scale_by_neg_lr(lr) -> Transform:
    sched = _as_schedule(lr)

    def update(updates, state, params=None):
        neg = -float(sched(state.step))  # an fp32 value, exact as a Python float
        for u in updates.values():
            u.mul_(neg)
        return updates, ScaleByLrState(step=state.step + 1)

    return Transform(lambda p: ScaleByLrState(step=0), update)


def add_weight_decay(wd: float) -> Transform:
    """g ← g + wd·x (the paper leaves wd = 5e-4 for all methods)."""

    def update(updates, state, params=None):
        if wd == 0.0 or params is None:
            return updates, state
        for k, u in updates.items():
            u.add_(params[k].to(u.dtype) * wd)
        return updates, state

    return Transform(lambda p: EmptyState(), update)


class TraceState(NamedTuple):
    momentum: Params


def trace(beta: float) -> Transform:
    """Heavy-ball momentum m ← βm + g (pytorch-style, as in the paper's SGDM)."""

    def init(params):
        return TraceState({k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()})

    def update(updates, state, params=None):
        for k, u in updates.items():
            m = state.momentum[k]
            m.mul_(beta).add_(u.float())
            u.copy_(m)
        return updates, state

    return Transform(init, update)


# ---------------------------------------------------------------------------
# user-facing optimizers
# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0) -> Transform:
    parts = [add_weight_decay(weight_decay)]
    if momentum:
        parts.append(trace(momentum))
    parts.append(scale_by_neg_lr(lr))
    return chain(*parts)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """x ← x + u, in place on ``params`` (the reference returns a new tree)."""
    for k, x in params.items():
        x.add_(updates[k].to(x.dtype))
    return params
