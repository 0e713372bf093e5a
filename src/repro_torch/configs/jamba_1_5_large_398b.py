"""jamba-1.5-large-398b — hybrid Mamba + attention 1:7 interleave, MoE.

[arXiv:2403.19887] 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16 experts top-2 on every other layer; 1 attention layer per 8
(offset 4 within the period, following the Jamba block layout).
"""

from repro_torch.configs.base import LMConfig, MambaConfig, MoEConfig

CONFIG = LMConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_expert=24576,
        layer_period=2,
        layer_offset=1,
        capacity_factor=1.25,
    ),
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=277,
    attn_layer_period=4,
    attn_layer_offset=2,
    mamba=MambaConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk_size=16),
    moe=MoEConfig(
        num_experts=4,
        top_k=2,
        d_expert=128,
        layer_period=2,
        layer_offset=1,
        capacity_factor=2.0,
    ),
    norm_eps=1e-6,
    dtype="float32",
)
