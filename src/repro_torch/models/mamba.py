"""Mamba-2 (state-space duality) token mixer, training path, as
``repro.models.mamba``.

The chunked SSD algorithm [arXiv:2405.21060]: the sequence is split into
chunks of length Q; within a chunk the quadratic (dual) form computes the
causal contribution, between chunks a linear recurrence carries the
(H, P, N) state.  Everything is fp32 inside the scan.  ``impl="kernel"``
routes the intra-chunk term through :mod:`repro_torch.kernels.ssd_chunk`
(the Hopper kernels, forward and backward, on CUDA tensors);
``impl="xla"`` computes it, and autograd its gradient, with the
einsums of the oracle ``ssd_chunk.ref``, as the reference's default.

Decode and prefill (``ssd_decode_step``, the conv streaming state, the
cache) come with the serving slice (ROADMAP.md queue A).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from repro_torch.models import layers as L


def init_mamba(gen, cfg, device="cpu", lead=()):
    D = cfg.d_model
    m = cfg.mamba
    d_in = m.d_inner(D)
    H = m.num_heads(D)
    N = m.d_state
    pd = cfg.param_dtype
    lead = tuple(lead)
    d_proj = 2 * d_in + 2 * N + H  # [z, x, B, C, dt]

    # dt bias: softplus^-1 of log-uniform dt in [dt_min, dt_max]
    u = torch.rand(lead + (H,), generator=gen, device=device)
    dt0 = torch.exp(u * (math.log(m.dt_max) - math.log(m.dt_min))
                    + math.log(m.dt_min))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    a = 1.0 + 15.0 * torch.rand(lead + (H,), generator=gen, device=device)
    return {
        "in_proj": L.init_dense(gen, D, d_proj, param_dtype=pd, device=device,
                                lead=lead),
        "conv": L.init_conv1d(gen, d_in + 2 * N, m.conv_width, pd, device,
                              lead),
        "A_log": torch.log(a).to(L.dt(pd)),
        "dt_bias": dt_bias.to(L.dt(pd)),
        "D_skip": L.ones_init(lead + (H,), pd, device),
        "norm": L.init_gated_rmsnorm(d_in, pd, device, lead),
        "out_proj": L.init_dense(gen, d_in, D, param_dtype=pd, device=device,
                                 lead=lead),
    }


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, impl: str = "kernel"):
    """Chunked state-space-duality scan from a zero state.

    xh: (B, S, H, P) per-head inputs; dt: (B, S, H) post-softplus timestep;
    A: (H,) negative decay rates; Bm, Cm: (B, S, N) input/output
    projections (ngroups=1, shared by the heads).  Returns
    (y (B, S, H, P) fp32, h_final (B, H, P, N) fp32).  The reference's
    initial state ``h0`` serves prefill, which comes with serving.
    """
    B_, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    xf = xh.float().reshape(B_, nc, Q, H, P)
    dtf = dt.float().reshape(B_, nc, Q, H)
    Bf = Bm.float().reshape(B_, nc, Q, N)
    Cf = Cm.float().reshape(B_, nc, Q, N)
    a_cum = torch.cumsum(dtf * A.float(), dim=2)       # inclusive
    a_total = a_cum[:, :, -1, :]                        # (B, nc, H)

    if impl == "kernel":
        y_intra, S_chunk = ssd_ops.ssd_intra(xf, dtf, a_cum, Bf, Cf)
    elif impl == "xla":
        y_intra, S_chunk = ssd_ref.ssd_intra_ref(xf, dtf, a_cum, Bf, Cf)
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")

    # inter-chunk recurrence over nc (the reference's lax.scan)
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=xf.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)                                  # state entering c
        h = h * torch.exp(a_total[:, c])[:, :, None, None] + S_chunk[:, c]
    h_in = torch.stack(h_in, dim=1)                     # (B, nc, H, P, N)

    # y_inter[i] = exp(a_cum[i]) * C_i . h_in(chunk)
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cf, h_in)
               * torch.exp(a_cum)[..., None])
    y = (y_intra + y_inter).reshape(B_, Sp, H, P)[:, :S]
    return y, h


# ---------------------------------------------------------------------------
# Full Mamba-2 sublayer
# ---------------------------------------------------------------------------


def mamba(cfg, p, x, *, impl: str = "kernel"):
    """x: (B, S, D) -> y (B, S, D); training form (no cache)."""
    B, S, D = x.shape
    m = cfg.mamba
    d_in = m.d_inner(D)
    H, P, N = m.num_heads(D), m.head_dim, m.d_state
    cd = cfg.dtype

    zxbcdt = L.dense(p["in_proj"], x, cd)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    xbc = L.causal_conv1d(p["conv"], xbc, cd)
    xi = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + N]
    Cm = xbc[..., d_in + N:]

    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, S, H, P)
    y, _ = ssd_chunked(xh, dtv, A, Bm, Cm, m.chunk_size, impl=impl)
    y = y + xh.float() * p["D_skip"].float()[:, None]
    y = y.reshape(B, S, d_in)
    y = L.gated_rmsnorm(p["norm"], y, z, cfg.norm_eps, cd)
    return L.dense(p["out_proj"], y, cd)
