"""Model configuration of the port (copy of ``repro/models/config.py``).

The port keeps its own copy of the dataclass, with the fields the dense
decoder reads; the JAX package's ``ModelConfig`` also covers MoE, Mamba,
encoder and patch-token models, which the port does not run yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

VOCAB_PAD = 256  # vocab padded up so embedding tables shard evenly (as the reference)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense"]
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float = 10_000.0
    norm_type: Literal["rms"] = "rms"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""

    def __post_init__(self):
        if self.arch_type != "dense" or self.norm_type != "rms" or not self.tie_embeddings:
            raise NotImplementedError(
                f"{self.name}: the port runs dense RMS-norm decoders with tied embeddings "
                "only (see ROADMAP.md)"
            )
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} not a multiple of kv {self.num_kv_heads}")

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD

    def param_count(self) -> int:
        """Parameters of the dense decoder, embedding table included."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.num_layers * per_layer + self.padded_vocab * d + d
