"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly;
they never drift to the CPU on their own when no card is present.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device (raises without one),
    with fp32 pinned (:func:`pin_fp32`); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        pin_fp32()
    return dev


def pin_fp32() -> None:
    """Run float32 convolutions and matmuls in full fp32 on the card, as
    the reference computes them: PyTorch lets cuDNN round conv operands
    to TF32 (a 10-bit mantissa) unless told otherwise, and a caller may
    have let cuBLAS do the same.  Process-wide, as the flags are; the
    backward ops autograd runs later read them too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
