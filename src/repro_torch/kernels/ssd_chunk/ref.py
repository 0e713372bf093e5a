"""Quadratic oracle for the SSD intra-chunk kernel (the dual form), as
``repro.kernels.ssd_chunk.ref``."""

from __future__ import annotations

import torch


def ssd_intra_ref(xf, dtf, a_cum, Bf, Cf):
    """Intra-chunk outputs and per-chunk state contributions.

    xf:  (B, nc, Q, H, P)   per-head inputs (fp32)
    dtf: (B, nc, Q, H)      timestep
    a_cum: (B, nc, Q, H)    inclusive cumsum of dt*A within the chunk
    Bf, Cf: (B, nc, Q, N)   shared input/output projections (ngroups=1)

    Returns y_intra (B, nc, Q, H, P) and S_chunk (B, nc, H, P, N).  The
    mask is applied before the exponential, as in the reference: above the
    diagonal seg > 0, and ``exp(seg) * mask`` would overflow there and give
    NaN gradients.
    """
    Q = xf.shape[2]
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xf.device))
    Ldec = torch.exp(torch.where(tril[None, None, :, :, None], seg,
                                 torch.full_like(seg, -torch.inf)))
    cb = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)
    att = cb[..., None] * Ldec * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xf)
    a_total = a_cum[:, :, -1, :]
    wj = torch.exp(a_total[:, :, None, :] - a_cum) * dtf
    S_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchpn", wj, Bf, xf)
    return y_intra, S_chunk
