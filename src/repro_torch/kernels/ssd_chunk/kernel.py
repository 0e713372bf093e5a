"""Mamba-2 SSD intra-chunk kernel wrapper.

``ssd_intra_kernel`` replaces the TPU Pallas kernel
``repro/kernels/ssd_chunk/kernel.py::ssd_intra_pallas`` (pallas_call :70).
On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/ssd_chunk.cu``; the source says what bounds it and what its design
does about that) or raises; on a CPU tensor it runs its plain PyTorch
version below, the dual form written head-major as batched products.

Layouts, as the reference (no transposes: the kernel reads x, dt and a_cum
in place with strides): xf (B, nc, Q, H, P), dtf and a_cum (B, nc, Q, H),
Bf and Cf (B, nc, Q, N), all fp32.  Returns fp32 y_intra (B, nc, Q, H, P)
and S_chunk (B, nc, H, P, N).  The wrapper carries ``launches``, the number
of calls that launched the kernel.
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


def _check_inputs(xf, dtf, a_cum, Bf, Cf):
    ts = (xf, dtf, a_cum, Bf, Cf)
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
