"""The SSD intra-chunk kernel as a ``torch.autograd.Function``, as
``repro.kernels.ssd_chunk.ops``.

The forward runs :func:`~repro_torch.kernels.ssd_chunk.kernel.
ssd_intra_kernel` and saves only the inputs.  The backward runs
:func:`~repro_torch.kernels.ssd_chunk.kernel.ssd_intra_bwd_kernel`, which
recomputes C.B^T and the decays from them: the hand-written Hopper kernel
on CUDA tensors, its plain version (explicit formulas, not autograd) on
CPU tensors.  It computes the VJP that the reference's ``_bwd`` takes by
differentiating the quadratic oracle ``ref.ssd_intra_ref``, which stays
as the tests' oracle and the ``impl="xla"`` route of ``models/mamba.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk.kernel import (ssd_intra_bwd_kernel,
                                                  ssd_intra_kernel)


class _SSDIntra(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xf, dtf, a_cum, Bf, Cf):
        ctx.save_for_backward(xf, dtf, a_cum, Bf, Cf)
        return ssd_intra_kernel(xf, dtf, a_cum, Bf, Cf)

    @staticmethod
    def backward(ctx, dy, ds):
        return ssd_intra_bwd_kernel(*ctx.saved_tensors, dy, ds)


def ssd_intra(xf, dtf, a_cum, Bf, Cf):
    """Differentiable (y_intra, S_chunk); layouts as ``ref.ssd_intra_ref``."""
    return _SSDIntra.apply(xf, dtf, a_cum, Bf, Cf)
