"""Config registry of the port (copy of ``repro/configs/base.py``'s registry).

Only the architectures the port can run are registered: the dense decoder
``llama3_2_1b``. ``reduced(cfg)`` is the reference's smoke-test variant, for
the fields the port's config has.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ("llama3_2_1b",)
_ALIASES = {"llama3.2-1b": "llama3_2_1b"}


def get_config(arch: str) -> ModelConfig:
    arch_id = _ALIASES.get(arch, arch)
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family, 2 layers, tiny dims, fp32 compute."""
    num_heads = min(cfg.num_heads, 4)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=num_heads,
        num_kv_heads=min(cfg.num_kv_heads, max(1, num_heads // 2)),
        head_dim=min(cfg.head_dim, 64),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        param_dtype="float32",
        compute_dtype="float32",
    )
