"""Mamba-2 (state-space duality) token mixer, as ``repro.models.mamba``.

The chunked SSD algorithm [arXiv:2405.21060]: the sequence is split into
chunks of length Q; within a chunk the quadratic (dual) form computes the
causal contribution, between chunks a linear recurrence carries the
(H, P, N) state.  Everything is fp32 inside the scan.  ``impl="kernel"``
routes the intra-chunk term through :mod:`repro_torch.kernels.ssd_chunk`
(the Hopper kernels, forward and backward, on CUDA tensors);
``impl="xla"`` computes it, and autograd its gradient, with the
einsums of the oracle ``ssd_chunk.ref``, as the reference's default.

Serving keeps a cache a layer (:func:`init_mamba_cache`): the last W-1
pre-conv inputs and the fp32 SSM state.  Prefill runs the chunked scan
from the cached state (``h0``) and fills both; decode is the O(1)
recurrence (:func:`ssd_decode_step`) and the conv's streaming form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk import ref as ssd_ref
from repro_torch.models import layers as L
from repro_torch.sharding import shard


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


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None,
                impl: str = "kernel"):
    """Chunked state-space-duality scan.

    xh: (B, S, H, P) per-head inputs; dt: (B, S, H) post-softplus timestep;
    A: (H,) negative decay rates; Bm, Cm: (B, S, N) input/output
    projections (ngroups=1, shared by the heads); h0: the state entering
    the sequence (B, H, P, N), zero when None (prefill passes the cached
    one; it enters only the inter-chunk recurrence).  Returns
    (y (B, S, H, P) fp32, h_final (B, H, P, N) fp32).
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
    # the SSD head axis is embarrassingly parallel — shard it over "model"
    # or the (B, nc, Q, Q, H) decay tensor alone is tens of GB per layer
    # (the oracle's decay tensor inherits a_cum's head sharding)
    xf = shard(xf, "batch", None, None, "heads", None)
    dtf = shard(dtf, "batch", None, None, "heads")
    a_cum = torch.cumsum(dtf * A.float(), dim=2)       # inclusive
    a_cum = shard(a_cum, "batch", None, None, "heads")
    a_total = a_cum[:, :, -1, :]                        # (B, nc, H)

    if impl == "kernel":
        y_intra, S_chunk = ssd_ops.ssd_intra(xf, dtf, a_cum, Bf, Cf)
    elif impl == "xla":
        y_intra, S_chunk = ssd_ref.ssd_intra_ref(xf, dtf, a_cum, Bf, Cf)
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")

    # inter-chunk recurrence over nc (the reference's lax.scan)
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=xf.device)
         if h0 is None else h0.float())
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


def ssd_decode_step(xh, dt, A, Bm, Cm, h):
    """One token of the SSM recurrence.  xh: (B, H, P), dt: (B, H), Bm, Cm:
    (B, N), h: (B, H, P, N) fp32.  Returns (y (B, H, P), h_new), fp32."""
    a = torch.exp(dt.float() * A.float())                       # (B, H)
    dbx = torch.einsum("bh,bn,bhp->bhpn", dt.float(), Bm.float(), xh.float())
    h_new = h * a[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.float())
    return y, h_new


# ---------------------------------------------------------------------------
# Full Mamba-2 sublayer
# ---------------------------------------------------------------------------


def mamba(cfg, p, x, *, cache=None, impl: str = "kernel"):
    """x: (B, S, D) -> (y, cache).

    Without a cache, training (returns (y, None)).  With one
    (``{"conv": (B, W-1, conv_dim), "ssm": (B, H, P, N)}``, views into the
    caller's stacked caches), S > 1 is prefill and S == 1 decode; both
    write the new state into it in place and return it.  As the
    reference: prefill keeps the last W-1 *pre-conv* inputs, decode
    casts the conv state to the compute dtype, the SSM state stays fp32.
    """
    B, S, D = x.shape
    m = cfg.mamba
    d_in = m.d_inner(D)
    H, P, N = m.num_heads(D), m.head_dim, m.d_state
    W = m.conv_width
    cd = cfg.dtype

    zxbcdt = L.dense(p["in_proj"], x, cd)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    if cache is None:
        xbc = L.causal_conv1d(p["conv"], xbc, cd)
    elif S > 1:  # prefill
        if W > 1:
            cache["conv"].copy_(xbc[:, -(W - 1):])
        xbc = L.causal_conv1d(p["conv"], xbc, cd)
    else:  # decode
        xbc, conv_state = L.causal_conv1d(p["conv"], xbc, cd,
                                          state=cache["conv"])
        cache["conv"].copy_(conv_state)
    xi = xbc[..., :d_in]
    Bm = xbc[..., d_in:d_in + N]
    Cm = xbc[..., d_in + N:]

    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xi.reshape(B, S, H, P)
    if cache is None or S > 1:
        h0 = None if cache is None else cache["ssm"]
        y, h_final = ssd_chunked(xh, dtv, A, Bm, Cm, m.chunk_size, h0=h0,
                                 impl=impl)
        if cache is not None:
            cache["ssm"].copy_(h_final)
    else:
        y1, h_new = ssd_decode_step(xh[:, 0], dtv[:, 0], A, Bm[:, 0],
                                    Cm[:, 0], cache["ssm"].float())
        y = y1[:, None]
        cache["ssm"].copy_(h_new)
    y = y + xh.float() * p["D_skip"].float()[:, None]
    y = y.reshape(B, S, d_in)
    y = L.gated_rmsnorm(p["norm"], y, z, cfg.norm_eps, cd)
    y = shard(y, "batch", None, "ff")
    return L.dense(p["out_proj"], y, cd), cache


def init_mamba_cache(cfg, batch: int, dtype="float32", device="cpu"):
    """Zero conv and SSM state of one Mamba layer."""
    D = cfg.d_model
    m = cfg.mamba
    conv_dim = m.d_inner(D) + 2 * m.d_state
    return {"conv": torch.zeros((batch, m.conv_width - 1, conv_dim),
                                dtype=L.dt(dtype), device=device),
            "ssm": torch.zeros((batch, m.num_heads(D), m.head_dim,
                                m.d_state), dtype=L.dt(dtype), device=device)}
