"""mamba2-370m — SSD (state-space duality), attention-free.

[arXiv:2405.21060] 48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128.
Mamba-2 blocks have no MLP sublayer (d_ff=0 -> mixer-only layers).
"""

from repro_torch.configs.base import LMConfig, MambaConfig

CONFIG = LMConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = LMConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=16,
    d_ff=0,
    vocab_size=257,
    mamba=MambaConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk_size=16),
    tie_embeddings=True,
    norm_eps=1e-5,
    dtype="float32",
)
