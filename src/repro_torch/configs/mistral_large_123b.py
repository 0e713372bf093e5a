"""mistral-large-123b — deep dense GQA transformer.

[hf:mistralai/Mistral-Large-Instruct-2407] 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    norm_eps=1e-5,
)

SMOKE = LMConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    num_layers=3,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=293,
    norm_eps=1e-5,
    dtype="float32",
)
