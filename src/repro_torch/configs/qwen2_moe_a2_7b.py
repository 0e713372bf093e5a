"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936; every layer is MoE with a 4x shared expert branch.
"""

from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_expert=1408,
        num_shared_experts=4,
        d_shared=1408,
        layer_period=1,
        layer_offset=0,
        capacity_factor=1.25,
    ),
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=313,
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=6,
        top_k=2,
        d_expert=32,
        num_shared_experts=2,
        d_shared=32,
        layer_period=1,
        layer_offset=0,
        capacity_factor=2.0,
    ),
    norm_eps=1e-6,
    dtype="float32",
)
