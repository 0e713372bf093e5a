"""Fused (never-materialize-the-logits) cross entropy over huge vocabularies.

* ``impl="kernel"`` — :class:`_FusedXent`, a ``torch.autograd.Function``
  around the ``xent_fwd``/``xent_bwd`` kernel pair (Hopper kernels on CUDA
  tensors, their plain versions on CPU tensors).  This is the port's path.
* ``impl="ref"``    — the materializing oracle (test scale only).

Both support gemma2's final-logit softcap.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.xent import kernel as K
from repro_torch.kernels.xent.ref import cross_entropy_ref
from repro_torch.observability.profiling import annotate

# the profiler range of both launches (--profile): the reference's name
# for its kernel entry point
RANGE = "fused_xent_pallas"


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, softcap):
        with annotate(RANGE):
            loss, lse = K.xent_fwd(h, w, labels, softcap=softcap)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.softcap = softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        with annotate(RANGE):
            dh, dw = K.xent_bwd(h, w, labels, lse, g, softcap=ctx.softcap)
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def fused_xent(h, w, labels, softcap: float = 0.0):
    """Per-token cross-entropy (T,) through the kernel pair."""
    return _FusedXent.apply(h, w, labels, softcap)


def cross_entropy(hidden, w, labels, mask=None, *, softcap: float = 0.0,
                  impl: str = "kernel"):
    """Mean cross-entropy; hidden (T, D), w (D, V), labels (T,).

    Returns (loss, per_token_loss); differentiable wrt hidden and w."""
    if impl == "ref":
        return cross_entropy_ref(hidden, w, labels, mask, softcap)
    if impl != "kernel":
        raise ValueError(f"unknown xent impl {impl!r}")
    per_token = fused_xent(hidden, w, labels, softcap)
    mask = torch.ones_like(per_token) if mask is None else mask.float()
    loss = torch.sum(per_token * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, per_token
