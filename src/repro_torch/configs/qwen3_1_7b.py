"""qwen3-1.7b — dense GQA with per-head qk-norm.

[hf:Qwen/Qwen3-8B family] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, head_dim=128, qk_norm, tied embeddings.
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="qwen3-1.7b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=269,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
    dtype="float32",
)
