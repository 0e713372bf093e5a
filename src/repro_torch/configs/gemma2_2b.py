"""gemma2-2b — local+global alternating attention, logit softcaps.

[arXiv:2408.00118] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
head_dim=256 (q width 2048 != d_model), sliding window 4096 on even layers,
attn softcap 50, final softcap 30, GeGLU, post-block norms, tied embeddings
scaled by sqrt(d_model).
"""

import math

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    sliding_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_activation="geglu",
    post_block_norm=True,
    embedding_multiplier=math.sqrt(2304.0),
    tie_embeddings=True,
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="gemma2-2b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=283,
    sliding_window=8,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_activation="geglu",
    post_block_norm=True,
    embedding_multiplier=8.0,
    tie_embeddings=True,
    norm_eps=1e-6,
    dtype="float32",
)
