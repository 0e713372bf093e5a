"""Flash attention kernel wrappers: forward, fused backward, and the two
sweeps of the split backward.

``flash_fwd``, ``flash_bwd_fused``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
replace the TPU Pallas kernels of the same names in
``repro/kernels/flash_attention/kernel.py`` (pallas_call at :119,
:464/:481, :212 and :269).  On a CUDA tensor each launches its hand-written
Hopper kernel (``csrc/flash_attention.cu``; the source says what bounds it
and what its design does about that) or raises; on a CPU tensor it runs its
plain PyTorch version below, which materializes the (Sq, Skv) scores and
follows the reference kernels' semantics exactly (``-1e30`` mask sentinel,
``l`` clamped at 1e-30, uniform weights on a row with no valid key).

Layouts, as the reference kernels: q, o, dq (BH, Sq, hd) with
BH = B * Hkv * G kv-major (``bh // G`` is the kv head); k, v, dk, dv
(BKV, Skv, hd).  Outputs are fp32.  The fused backward reads dO in fp32;
the two sweeps read it in q's dtype and raise ``TypeError`` on another
(the plain versions take either).  Each wrapper carries ``launches``, the
number of kernel launches it made, and ``launches_by_dtype``, the same
count split by q's dtype (``"bfloat16"``, ``"float32"``).  Every kernel
runs on the tensor cores for both dtypes: for fp32 each one runs the same
tensor-core kernel as for bf16 over bf16 planes of q, k and v, which its
split pre-pass writes into scratch taken here (``_planes``; q's dtype sets
only the pass count, and the sweeps split an fp32 dO into hi and lo in the
kernel).
"""

from __future__ import annotations

import ctypes

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


def _bwd_p_ds(q, k, v, do, lse, delta, *, group, causal, window, softcap,
              scale, kv_len):
    """Recomputed P and dS, (BKV, G, Sq, Skv), with the fp32 operands."""
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
    dp = torch.einsum("bgqd,bkd->bgqk", dof, vf)
    ds = p * (dp - delta.reshape(BKV, group, Sq, 1))
    if dchain is not None:
        ds = ds * dchain
    return p, ds * scale, qf, kf, dof


def flash_bwd_fused_plain(q, k, v, do, lse, delta, **kw):
    p, ds, qf, kf, dof = _bwd_p_ds(q, k, v, do, lse, delta, **kw)
    dv = torch.einsum("bgqk,bgqd->bkd", p, dof)
    dk = torch.einsum("bgqk,bgqd->bkd", ds, qf)
    dq = torch.einsum("bgqk,bkd->bgqd", ds, kf)
    return dq.reshape(q.shape), dk, dv


def flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw):
    _, ds, _, kf, _ = _bwd_p_ds(q, k, v, do, lse, delta, **kw)
    return torch.einsum("bgqk,bkd->bgqd", ds, kf).reshape(q.shape)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw):
    p, ds, qf, _, dof = _bwd_p_ds(q, k, v, do, lse, delta, **kw)
    return (torch.einsum("bgqk,bgqd->bkd", ds, qf),
            torch.einsum("bgqk,bgqd->bkd", p, dof))


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


def _planes(lib, q, k):
    """Scratch for the bf16 planes of fp32 q, k and v, which the kernels'
    split pre-pass writes; None for bf16, which needs none."""
    n = lib.rt_flash_plane_elems(build.dtype_code(q), q.numel(), k.numel())
    return torch.empty((n,), dtype=torch.bfloat16, device=q.device) if n \
        else None


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_fwd(lib, stream, q, k, v, *, group, causal, window, softcap,
                scale, kv_len):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    BH, Sq, hd = q.shape
    o = torch.empty((BH, Sq, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    planes = _planes(lib, q, k)
    err = lib.rt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           _ptr(planes), o.data_ptr(), lse.data_ptr(),
                           build.dtype_code(q),
                           BH, Sq, k.shape[1], hd, group, int(causal),
                           int(window), float(softcap), float(scale),
                           int(kv_len), stream)
    build.check(lib, err, "flash_fwd")
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta):
    """The fused backward's operands: dO in fp32 (a bf16 q splits it into
    hi + lo)."""
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            do.float().contiguous(), lse.float().contiguous(),
            delta.float().contiguous())


def _split_operands(q, k, v, do, lse, delta):
    """The split sweeps' operands: dO in q's dtype, never rounded here."""
    if do.dtype != q.dtype:
        raise TypeError(f"split backward: dO must be in q's dtype {q.dtype}, "
                        f"got {do.dtype}")
    return (q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous(),
            lse.float().contiguous(), delta.float().contiguous())


def _bwd_scalars(q, k, *, group, causal, window, softcap, scale, kv_len):
    BH, Sq, hd = q.shape
    return (build.dtype_code(q), BH, Sq, k.shape[1], hd, group, int(causal),
            int(window), float(softcap), float(scale), int(kv_len))


def fused_bwd_tiles(lib, q):
    """(BQ, BK) of the fused backward for q's dtype and head dim."""
    bq, bk = ctypes.c_int(), ctypes.c_int()
    err = lib.rt_flash_bwd_tiles(build.dtype_code(q), q.shape[-1],
                                 ctypes.byref(bq), ctypes.byref(bk))
    build.check(lib, err, "flash_bwd_fused")
    return bq.value, bk.value


def _bwd_ptrs(planes, tensors):
    """The backwards' pointers: q, k, v (the first three of ``tensors``),
    the plane scratch (null for bf16), then the rest."""
    ptrs = [t.data_ptr() for t in tensors]
    ptrs.insert(3, _ptr(planes))
    return ptrs


def _launch_bwd(lib, stream, q, k, v, do, lse, delta, **kw):
    ops = _bwd_operands(q, k, v, do, lse, delta)
    # dQ is summed in place in kv-tile order, one turn counter per
    # (bh, q tile): both start at zero
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    BH, Sq, hd = q.shape
    n = BH * -(-Sq // fused_bwd_tiles(lib, q)[0])
    turns = torch.zeros(n, dtype=torch.int32, device=q.device)
    planes = _planes(lib, q, k)
    err = lib.rt_flash_bwd(*_bwd_ptrs(planes, ops + (dq, dk, dv)),
                           turns.data_ptr(), n,
                           *_bwd_scalars(q, k, **kw), stream)
    build.check(lib, err, "flash_bwd_fused")
    return dq, dk, dv


def _launch_bwd_dq(lib, stream, q, k, v, do, lse, delta, **kw):
    ops = _split_operands(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    planes = _planes(lib, q, k)
    err = lib.rt_flash_bwd_dq(*_bwd_ptrs(planes, ops + (dq,)),
                              *_bwd_scalars(q, k, **kw), stream)
    build.check(lib, err, "flash_bwd_dq")
    return dq


def _launch_bwd_dkv(lib, stream, q, k, v, do, lse, delta, **kw):
    ops = _split_operands(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    planes = _planes(lib, q, k)
    err = lib.rt_flash_bwd_dkv(*_bwd_ptrs(planes, ops + (dk, dv)),
                               *_bwd_scalars(q, k, **kw), stream)
    build.check(lib, err, "flash_bwd_dkv")
    return dk, dv


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
    _count(flash_fwd, q)
    return out


def _count(fn, q):
    fn.launches += 1
    key = str(q.dtype).removeprefix("torch.")
    fn.launches_by_dtype[key] = fn.launches_by_dtype.get(key, 0) + 1


flash_fwd.launches = 0
flash_fwd.launches_by_dtype = {}


def _bwd_wrapper(name, plain, launch, doc):
    def fn(q, k, v, do, lse, delta, *, group, causal, window, softcap, scale,
           kv_len):
        kw = dict(group=group, causal=causal, window=window, softcap=softcap,
                  scale=scale, kv_len=kv_len)
        if q.device.type == "cpu":
            return plain(q, k, v, do, lse, delta, **kw)
        _check_inputs(q, k, v, group)
        out = launch(build.load(), build.stream_ptr(q), q, k, v, do, lse,
                     delta, **kw)
        _count(fn, q)
        return out

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = doc
    fn.launches = 0
    fn.launches_by_dtype = {}
    return fn


flash_bwd_fused = _bwd_wrapper(
    "flash_bwd_fused", flash_bwd_fused_plain, _launch_bwd,
    """One P recompute per (q tile, kv tile) feeds dQ, dK and dV; the kv
    tiles add their dQ contributions in place in kv-tile order, each
    waiting for its turn on a per-(bh, q tile) counter (no atomics, no
    scratch: bit-identical run to run).  Returns fp32 dq (BH, Sq, hd), dk,
    dv (BKV, Skv, hd).""")
flash_bwd_dq = _bwd_wrapper(
    "flash_bwd_dq", flash_bwd_dq_plain, _launch_bwd_dq,
    """dQ sweep of the two-sweep backward (P recomputed; no atomics); dO in
    q's dtype.  Returns fp32 dq (BH, Sq, hd).""")
flash_bwd_dkv = _bwd_wrapper(
    "flash_bwd_dkv", flash_bwd_dkv_plain, _launch_bwd_dkv,
    """dK/dV sweep of the two-sweep backward (P recomputed; no atomics); dO
    in q's dtype.  Returns fp32 dk, dv (BKV, Skv, hd).""")
