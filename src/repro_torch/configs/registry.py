"""Architecture registry: ``--arch <id>`` resolution.

``get_config(name)`` returns the full published config; ``get_smoke_config``
returns the reduced same-family config used by CPU smoke tests.  The full
configs are only ever instantiated abstractly (ShapeDtypeStruct) by the
dry-run; smoke configs are the ones that allocate real arrays.
"""

from __future__ import annotations

from repro_torch.configs import (
    gemma2_2b,
    granite_moe_3b_a800m,
    jamba_1_5_large_398b,
    mamba2_370m,
    mistral_large_123b,
    musicgen_large,
    paper_archs,
    qwen1_5_4b,
    qwen2_moe_a2_7b,
    qwen2_vl_72b,
    qwen3_1_7b,
)
from repro_torch.configs.base import SHAPES, InputShape, LMConfig, VisionConfig

_LM_MODULES = {
    "mamba2-370m": mamba2_370m,
    "qwen2-vl-72b": qwen2_vl_72b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "musicgen-large": musicgen_large,
    "gemma2-2b": gemma2_2b,
    "qwen3-1.7b": qwen3_1_7b,
    "qwen1.5-4b": qwen1_5_4b,
    "mistral-large-123b": mistral_large_123b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
}

_VISION_CONFIGS = {
    "mobilenet-l": (paper_archs.MOBILENET_L, paper_archs.MOBILENET_L_SMOKE),
    "vgg11": (paper_archs.VGG11, paper_archs.VGG11_SMOKE),
    "vit-s": (paper_archs.VIT_S, paper_archs.VIT_S_SMOKE),
    "swin-t": (paper_archs.SWIN_T, paper_archs.SWIN_T_SMOKE),
}

ASSIGNED_ARCHS = tuple(_LM_MODULES)
PAPER_ARCHS = tuple(_VISION_CONFIGS)


def list_archs() -> list:
    return list(ASSIGNED_ARCHS) + list(PAPER_ARCHS)


def get_config(name: str):
    if name in _LM_MODULES:
        return _LM_MODULES[name].CONFIG
    if name in _VISION_CONFIGS:
        return _VISION_CONFIGS[name][0]
    raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_smoke_config(name: str):
    if name in _LM_MODULES:
        return _LM_MODULES[name].SMOKE
    if name in _VISION_CONFIGS:
        return _VISION_CONFIGS[name][1]
    raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def cells(include_skipped: bool = True):
    """Yield every (arch, shape) cell of the assignment matrix.

    Returns tuples ``(arch_name, shape_name, runnable, reason)``.
    long_500k is only runnable for sub-quadratic (SSM/hybrid) archs.
    """
    out = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            runnable, reason = True, ""
            if shape == "long_500k" and not cfg.is_subquadratic:
                runnable, reason = False, (
                    "pure full-attention arch: 500k-context decode requires "
                    "sub-quadratic attention (see DESIGN.md)"
                )
            if runnable or include_skipped:
                out.append((arch, shape, runnable, reason))
    return out
