"""Flash attention kernel wrappers: forward and fused backward.

``flash_fwd`` and ``flash_bwd_fused`` replace the TPU Pallas kernels of the
same names in ``repro/kernels/flash_attention/kernel.py`` (pallas_call at
:119, and :464/:481).  On a CUDA tensor each launches its hand-written
Hopper kernel (``csrc/flash_attention.cu``; the source says what bounds it
and what its design does about that) or raises; on a CPU tensor it runs its
plain PyTorch version below, which materializes the (Sq, Skv) scores and
follows the reference kernels' semantics exactly (``-1e30`` mask sentinel,
``l`` clamped at 1e-30, uniform weights on a row with no valid key).

Layouts, as the reference kernels: q, o, dq (BH, Sq, hd) with
BH = B * Hkv * G kv-major (``bh // G`` is the kv head); k, v, dk, dv
(BKV, Skv, hd).  Outputs are fp32.  Each wrapper carries ``launches``, the
number of kernel launches it made.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)


def _mask(Sq, Skv, *, causal, window, kv_len, device):
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    m = k_pos < kv_len
    if causal:
        m = m & (q_pos >= k_pos)
    if window:
        m = m & ((q_pos - k_pos) < window)
    return m


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def flash_fwd_plain(q, k, v, *, group, causal, window, softcap, scale,
                    kv_len):
    BH, Sq, hd = q.shape
    BKV, Skv = k.shape[0], k.shape[1]
    qf = q.float().reshape(BKV, group, Sq, hd) * scale
    s = torch.einsum("bgqd,bkd->bgqk", qf, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(Sq, Skv, causal=causal, window=window, kv_len=kv_len,
                 device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.reshape(BH, Sq, hd), lse.reshape(BH, Sq)


def flash_bwd_fused_plain(q, k, v, do, lse, delta, *, group, causal, window,
                          softcap, scale, kv_len):
    BH, Sq, hd = q.shape
    BKV, Skv = k.shape[0], k.shape[1]
    qf = q.float().reshape(BKV, group, Sq, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(BKV, group, Sq, hd)
    s = torch.einsum("bgqd,bkd->bgqk", qf * scale, kf)
    dchain = None
    if softcap:
        s = torch.tanh(s / softcap) * softcap
        dchain = 1.0 - torch.square(s / softcap)   # d softcap / d s_raw
    mask = _mask(Sq, Skv, causal=causal, window=window, kv_len=kv_len,
                 device=q.device)
    lse4 = lse.reshape(BKV, group, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse4), torch.zeros_like(s))
    dv = torch.einsum("bgqk,bgqd->bkd", p, dof)
    dp = torch.einsum("bgqd,bkd->bgqk", dof, vf)
    ds = p * (dp - delta.reshape(BKV, group, Sq, 1))
    if dchain is not None:
        ds = ds * dchain
    ds = ds * scale
    dk = torch.einsum("bgqk,bgqd->bkd", ds, qf)
    dq = torch.einsum("bgqk,bkd->bgqd", ds, kf)
    return dq.reshape(BH, Sq, hd), dk, dv


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_inputs(q, k, v, group):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention kernel: q, k, v must all be CUDA "
                         "tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    BH, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.shape[0] * group != BH or k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} group={group}")


def _launch_fwd(lib, stream, q, k, v, *, group, causal, window, softcap,
                scale, kv_len):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    BH, Sq, hd = q.shape
    o = torch.empty((BH, Sq, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    err = lib.rt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), build.dtype_code(q),
                           BH, Sq, k.shape[1], hd, group, int(causal),
                           int(window), float(softcap), float(scale),
                           int(kv_len), stream)
    build.check(lib, err, "flash_fwd")
    return o, lse


def _launch_bwd(lib, stream, q, k, v, do, lse, delta, *, group, causal,
                window, softcap, scale, kv_len):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.float().contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    BH, Sq, hd = q.shape
    dq = torch.zeros((BH, Sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    err = lib.rt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           build.dtype_code(q), BH, Sq, k.shape[1], hd, group,
                           int(causal), int(window), float(softcap),
                           float(scale), int(kv_len), stream)
    build.check(lib, err, "flash_bwd_fused")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, *, group, causal, window, softcap, scale, kv_len):
    """q (BH, Sq, hd); k, v (BKV, Skv, hd) -> o (BH, Sq, hd), lse (BH, Sq)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, group=group, causal=causal,
                               window=window, softcap=softcap, scale=scale,
                               kv_len=kv_len)
    _check_inputs(q, k, v, group)
    out = _launch_fwd(build.load(), build.stream_ptr(q), q, k, v,
                      group=group, causal=causal, window=window,
                      softcap=softcap, scale=scale, kv_len=kv_len)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_bwd_fused(q, k, v, do, lse, delta, *, group, causal, window,
                    softcap, scale, kv_len):
    """One P recompute per (q tile, kv tile) feeds dQ, dK and dV.
    Returns fp32 dq (BH, Sq, hd), dk, dv (BKV, Skv, hd)."""
    if q.device.type == "cpu":
        return flash_bwd_fused_plain(q, k, v, do, lse, delta, group=group,
                                     causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     kv_len=kv_len)
    _check_inputs(q, k, v, group)
    out = _launch_bwd(build.load(), build.stream_ptr(q), q, k, v, do, lse,
                      delta, group=group, causal=causal, window=window,
                      softcap=softcap, scale=scale, kv_len=kv_len)
    flash_bwd_fused.launches += 1
    return out


flash_bwd_fused.launches = 0
