"""Mamba-2 SSD intra-chunk kernel wrappers, forward and backward.

``ssd_intra_kernel`` replaces the TPU Pallas kernel
``repro/kernels/ssd_chunk/kernel.py::ssd_intra_pallas`` (pallas_call :70);
``ssd_intra_bwd_kernel`` computes its VJP, which the reference takes by
differentiating the quadratic oracle (``repro/kernels/ssd_chunk/ops.py::
_bwd``).  On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/ssd_chunk.cu``; the source says what bounds them and what their
design does about that) or raises; on a CPU tensor it runs its plain
PyTorch version below, written head-major as batched products.

Layouts, as the reference (no transposes: the kernels read x, dt and a_cum
in place with strides): xf (B, nc, Q, H, P), dtf and a_cum (B, nc, Q, H),
Bf and Cf (B, nc, Q, N), all fp32.  The forward returns fp32 y_intra
(B, nc, Q, H, P) and S_chunk (B, nc, H, P, N); the backward takes their
cotangents in the same layouts and returns the five input gradients.  Each
wrapper carries ``launches``, the number of calls that launched its kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_Q, MAX_N, MAX_P = 256, 128, 64


def ssd_intra_plain(xf, dtf, a_cum, Bf, Cf):
    Q = xf.shape[2]
    cb = Cf @ Bf.transpose(-1, -2)                         # (B, nc, Q, Q)
    ac = a_cum.transpose(-1, -2)                           # (B, nc, H, Q)
    seg = ac[..., :, None] - ac[..., None, :]              # (B, nc, H, Q, Q)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xf.device))
    decay = torch.exp(torch.where(tril, seg, torch.full_like(seg, -torch.inf)))
    att = cb[:, :, None] * decay * dtf.transpose(-1, -2)[..., None, :]
    xh = xf.permute(0, 1, 3, 2, 4)                         # (B, nc, H, Q, P)
    y = (att @ xh).permute(0, 1, 3, 2, 4)
    w = torch.exp(ac[..., -1:] - ac) * dtf.transpose(-1, -2)   # (B, nc, H, Q)
    s = xh.transpose(-1, -2) @ (Bf[:, :, None] * w[..., None])
    return y, s


def ssd_intra_bwd_plain(xf, dtf, a_cum, Bf, Cf, dy, ds):
    """(dx, ddt, da_cum, dB, dC) of the SSD dual form, from explicit
    formulas.  Per (b, chunk, head), with the causal mask M = [j <= q],
    L = exp(ac_q - ac_j) (masked before the exponential), CB = C B^T,
    A = CB L dt_j and w_j = exp(ac_last - ac_j) dt_j:
    dA = M (dy x^T), G = dA L, E = dA A, U = B dS^T, Z_j = x_j . U_j;
    dx = A^T dy + w U; ddt = colsum(G CB) + exp(ac_last - ac) Z;
    da_cum = rowsum(E) - colsum(E) - w Z, plus sum(w Z) at the last row;
    and over the heads dCB = sum_h G dt_j, dC = dCB B,
    dB = dCB^T C + sum_h (w x) dS."""
    B, nc, Q, H, P = xf.shape
    cb = (Cf @ Bf.transpose(-1, -2))[:, :, None]           # (B, nc, 1, Q, Q)
    ac = a_cum.transpose(-1, -2)                           # (B, nc, H, Q)
    dth = dtf.transpose(-1, -2)
    seg = ac[..., :, None] - ac[..., None, :]              # (B, nc, H, Q, Q)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xf.device))
    decay = torch.exp(torch.where(tril, seg, torch.full_like(seg, -torch.inf)))
    xh = xf.permute(0, 1, 3, 2, 4)                         # (B, nc, H, Q, P)
    dyh = dy.permute(0, 1, 3, 2, 4)
    g = (dyh @ xh.transpose(-1, -2)) * decay               # dA L
    att = cb * decay * dth[..., None, :]                   # A
    e = g * cb * dth[..., None, :]                         # dA A
    u = Bf[:, :, None] @ ds.transpose(-1, -2)              # (B, nc, H, Q, P)
    ed = torch.exp(ac[..., -1:] - ac)
    w = ed * dth
    z = torch.sum(xh * u, dim=-1)
    dx = att.transpose(-1, -2) @ dyh + w[..., None] * u
    ddt = torch.sum(g * cb, dim=-2) + ed * z
    dac = torch.sum(e, dim=-1) - torch.sum(e, dim=-2) - w * z
    dac[..., -1] += torch.sum(w * z, dim=-1)
    dcb = torch.sum(g * dth[..., None, :], dim=2)          # (B, nc, Q, Q)
    xw = (w[..., None] * xh).permute(0, 1, 3, 2, 4).reshape(B, nc, Q, H * P)
    dB = dcb.transpose(-1, -2) @ Cf + xw @ ds.reshape(B, nc, H * P, -1)
    return (dx.permute(0, 1, 3, 2, 4), ddt.transpose(-1, -2),
            dac.transpose(-1, -2), dB, dcb @ Bf)


def _launch(lib, stream, xf, dtf, a_cum, Bf, Cf):
    xf, dtf, a_cum, Bf, Cf = (t.contiguous() for t in (xf, dtf, a_cum, Bf, Cf))
    B, nc, Q, H, P = xf.shape
    N = Bf.shape[-1]
    y = torch.empty((B, nc, Q, H, P), dtype=torch.float32, device=xf.device)
    s = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=xf.device)
    err = lib.rt_ssd_intra(xf.data_ptr(), dtf.data_ptr(), a_cum.data_ptr(),
                           Bf.data_ptr(), Cf.data_ptr(), y.data_ptr(),
                           s.data_ptr(), B * nc, Q, H, P, N, stream)
    build.check(lib, err, "ssd_intra")
    return y, s


def _launch_bwd(lib, stream, xf, dtf, a_cum, Bf, Cf, dy, ds):
    xf, dtf, a_cum, Bf, Cf, dy, ds = (
        t.contiguous() for t in (xf, dtf, a_cum, Bf, Cf, dy, ds))
    B, nc, Q, H, P = xf.shape
    N = Bf.shape[-1]
    BC = B * nc
    grads = [torch.empty_like(t) for t in (xf, dtf, a_cum, Bf, Cf)]
    scratch = torch.empty(lib.rt_ssd_intra_bwd_scratch_floats(BC, Q, H),
                          dtype=torch.float32, device=xf.device)
    err = lib.rt_ssd_intra_bwd(
        *(t.data_ptr() for t in (xf, dtf, a_cum, Bf, Cf, dy, ds)),
        *(g.data_ptr() for g in grads), scratch.data_ptr(), scratch.numel(),
        BC, Q, H, P, N, stream)
    build.check(lib, err, "ssd_intra_bwd")
    return tuple(grads)


def _check_inputs(xf, dtf, a_cum, Bf, Cf, dy=None, ds=None):
    ts = (xf, dtf, a_cum, Bf, Cf) + tuple(t for t in (dy, ds)
                                           if t is not None)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_intra kernel: all inputs must be CUDA tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("ssd_intra kernel: inputs must be float32")
    B, nc, Q, H, P = xf.shape
    N = Bf.shape[-1]
    if dtf.shape != (B, nc, Q, H) or a_cum.shape != dtf.shape or \
            Bf.shape != (B, nc, Q, N) or Cf.shape != Bf.shape:
        raise ValueError(f"bad shapes x{tuple(xf.shape)} dt{tuple(dtf.shape)} "
                         f"a_cum{tuple(a_cum.shape)} B{tuple(Bf.shape)} "
                         f"C{tuple(Cf.shape)}")
    if dy is not None and (dy.shape != xf.shape or
                           ds.shape != (B, nc, H, P, N)):
        raise ValueError(f"bad cotangent shapes dy{tuple(dy.shape)} "
                         f"dS{tuple(ds.shape)}")
    if Q > MAX_Q or N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_intra kernel takes Q <= {MAX_Q}, N <= {MAX_N},"
                         f" P <= {MAX_P}; got Q {Q}, N {N}, P {P}")


def ssd_intra_kernel(xf, dtf, a_cum, Bf, Cf):
    """(y_intra, S_chunk) of the SSD dual form; layouts as the module says."""
    if xf.device.type == "cpu":
        return ssd_intra_plain(xf, dtf, a_cum, Bf, Cf)
    _check_inputs(xf, dtf, a_cum, Bf, Cf)
    out = _launch(build.load(), build.stream_ptr(xf), xf, dtf, a_cum, Bf, Cf)
    ssd_intra_kernel.launches += 1
    return out


ssd_intra_kernel.launches = 0


def ssd_intra_bwd_kernel(xf, dtf, a_cum, Bf, Cf, dy, ds):
    """(dx, ddt, da_cum, dB, dC) given the cotangents dy of y_intra and ds
    of S_chunk; layouts as the module says."""
    if xf.device.type == "cpu":
        return ssd_intra_bwd_plain(xf, dtf, a_cum, Bf, Cf, dy, ds)
    _check_inputs(xf, dtf, a_cum, Bf, Cf, dy, ds)
    out = _launch_bwd(build.load(), build.stream_ptr(xf), xf, dtf, a_cum, Bf,
                      Cf, dy, ds)
    ssd_intra_bwd_kernel.launches += 1
    return out


ssd_intra_bwd_kernel.launches = 0
