"""The SSD intra-chunk kernel as a ``torch.autograd.Function``, as
``repro.kernels.ssd_chunk.ops``.

The forward runs :func:`~repro_torch.kernels.ssd_chunk.kernel.
ssd_intra_kernel` (the Hopper kernel on CUDA tensors, its plain version on
CPU tensors) and saves only the inputs.  The backward is the reference's
own design (``repro/kernels/ssd_chunk/ops.py::_bwd``), not a fallback: it
differentiates the quadratic oracle, recomputing ``ref.ssd_intra_ref``
from the saved inputs under autograd.  The JAX package has no backward
kernel for SSD, so neither has the port; a hand-written one is later work
(ROADMAP.md queue B).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.kernel import ssd_intra_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_ref


class _SSDIntra(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xf, dtf, a_cum, Bf, Cf):
        ctx.save_for_backward(xf, dtf, a_cum, Bf, Cf)
        return ssd_intra_kernel(xf, dtf, a_cum, Bf, Cf)

    @staticmethod
    def backward(ctx, dy, ds):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ssd_intra_ref(*inputs)
        return torch.autograd.grad(outs, inputs, (dy, ds))


def ssd_intra(xf, dtf, a_cum, Bf, Cf):
    """Differentiable (y_intra, S_chunk); layouts as ``ref.ssd_intra_ref``."""
    return _SSDIntra.apply(xf, dtf, a_cum, Bf, Cf)
