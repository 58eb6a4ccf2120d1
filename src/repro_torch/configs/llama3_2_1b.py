"""llama3.2-1b [dense] — small llama3, GQA kv=8. [hf:meta-llama/Llama-3.2-1B]

Copy of ``repro/configs/llama3_2_1b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-1B",
)
