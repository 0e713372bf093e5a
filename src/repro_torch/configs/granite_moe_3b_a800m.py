"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0 family] 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155; every layer is MoE.
"""

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_expert=512,
        layer_period=1,
        layer_offset=0,
        capacity_factor=1.25,
    ),
    tie_embeddings=True,
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=307,
    moe=MoEConfig(
        num_experts=8,
        top_k=4,
        d_expert=32,
        layer_period=1,
        layer_offset=0,
        capacity_factor=2.0,
    ),
    tie_embeddings=True,
    norm_eps=1e-6,
    dtype="float32",
)
