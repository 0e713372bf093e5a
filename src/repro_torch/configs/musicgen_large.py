"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (kv=32, full MHA) d_ff=8192
vocab=2048.  The EnCodec frontend (4 codebooks, delay pattern) is a STUB:
input_specs() provides a single interleaved code stream of token ids.
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_activation="gelu",
    norm_eps=1e-5,
)

SMOKE = LMConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=263,
    mlp_activation="gelu",
    norm_eps=1e-5,
    dtype="float32",
)
