"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly;
they never drift to the CPU on their own when no card is present.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device (raises without one),
    with fp32 and cuDNN's deterministic algorithms pinned (:func:`pin_fp32`,
    :func:`pin_deterministic`); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        pin_fp32()
        pin_deterministic()
    return dev


def pin_fp32() -> None:
    """Run float32 convolutions and matmuls in full fp32 on the card, as
    the reference computes them: PyTorch lets cuDNN round conv operands
    to TF32 (a 10-bit mantissa) unless told otherwise, and a caller may
    have let cuBLAS do the same.  Process-wide, as the flags are; the
    backward ops autograd runs later read them too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def pin_deterministic() -> None:
    """Let cuDNN pick only deterministic algorithms, so that a run repeats
    bit for bit on the card as the reference's does: PyTorch's default
    lets cuDNN's convolution backward sum in a varying order (the vision
    classifiers).  The hand-written kernels and the rest of the LM paths
    repeat without it; ``torch.use_deterministic_algorithms`` is not set,
    which costs the LM server step time and changes nothing there
    (PERF.md, Findings)."""
    torch.backends.cudnn.deterministic = True
