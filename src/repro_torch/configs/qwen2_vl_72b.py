"""qwen2-vl-72b — VLM backbone with M-RoPE.

[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Multimodal rotary position embedding: 3 sections (temporal/height/width).
The vision frontend is a STUB — input_specs() provides token ids plus
precomputed 3-axis position ids (for text, all three axes coincide).
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
)

SMOKE = LMConfig(
    name="qwen2-vl-72b-smoke",
    family="vlm",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=311,
    qkv_bias=True,
    mrope_sections=(4, 2, 2),
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    dtype="float32",
)
