"""Synthetic token data (``repro/data/synthetic.py:26-43``).

The same Markov-ish construction as the reference, drawn from an explicit
``torch.Generator`` — so the same seed gives other tokens than the
reference's ``jax.random`` keys. Parity tests hand both sides the same
explicit batches instead.
"""

from __future__ import annotations

from typing import Iterator

import torch


def token_batch(generator: torch.Generator, batch: int, seq: int, vocab: int) -> dict:
    """With probability .75 token t = (31·t₋₁ + 17·t₋₂ + 7) mod vocab, else uniform."""
    dev = generator.device
    x = torch.randint(0, vocab, (batch, seq + 1), generator=generator, device=dev)
    det = (31 * x[:, :-2] + 17 * x[:, 1:-1] + 7) % vocab
    coin = torch.rand(det.shape, generator=generator, device=dev) < 0.75
    toks = x.clone()
    toks[:, 2:] = torch.where(coin, det, x[:, 2:])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def token_batches(seed: int, batch: int, seq: int, vocab: int, device=None) -> Iterator[dict]:
    """Endless batches; batch ``i`` comes from a CPU generator seeded
    ``seed·100003 + i`` (the reference's key schedule) and is moved to ``device``."""
    step = 0
    while True:
        gen = torch.Generator().manual_seed(seed * 100_003 + step)
        yield {k: v.to(device) for k, v in token_batch(gen, batch, seq, vocab).items()}
        step += 1
