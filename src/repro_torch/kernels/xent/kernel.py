"""Fused cross-entropy kernel wrappers: forward and backward.

``xent_fwd`` and ``xent_bwd`` replace the TPU Pallas kernels of the same
names in ``repro/kernels/xent/kernel.py`` (pallas_call at :126, and
:281/:299).  On a CUDA tensor each launches its hand-written Hopper
kernels (``csrc/xent.cu``; the source says what bounds them and what the
design does about that) or raises; on a CPU tensor it runs its plain
PyTorch version below, which materializes the (T, V) logits.

The route follows h's dtype alone: a bf16 h runs the tensor-core kernels
(w split into bf16 hi/lo by a pre-pass into (Vp, D) scratch), an fp32 h the
CUDA-core ones.  A bf16 h that the tensor-core route cannot take (D not a
multiple of 8: its copies move 16-B rows) raises ``ValueError``.

h (T, D) in the model dtype; w (D, V) with any strides — the tied
auxiliary head passes a transposed view of the (V, D) embedding table and
the kernels read it in place; labels (T,).  Outputs are fp32; ``dw`` comes
back with ``w``'s layout (a transposed view of a (V, D) buffer for the
tied head), so it reaches the embedding gradient without a copy.  Each
wrapper carries ``launches``, the number of calls that launched kernels,
and ``launches_by_dtype``, the same by h's dtype (so by route).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
TILE = 64                       # token / vocabulary tile, CUDA-core kernels
TC_TILE = 128                   # the same, tensor-core kernels
TC_CHUNK = 32                   # tensor-core backward chunks: rows multiple
STAGE_BYTES = 4 * 2 ** 30       # bound on the backward's dlogits staging
TARGET_CTAS = 264               # CUDA-core forward: two CTAs per SM on 132
H100_SMS = 132                  # split count of the emulated (CPU) launches


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _logits(h, w, softcap):
    z = h.float() @ w.float()
    dchain = None
    if softcap:
        z = torch.tanh(z / softcap) * softcap
        dchain = 1.0 - torch.square(z / softcap)
    return z, dchain


def xent_fwd_plain(h, w, labels, *, softcap=0.0):
    s, _ = _logits(h, w, softcap)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    correct = torch.gather(s, 1, labels.long()[:, None])[:, 0]
    return lse - correct, lse


def xent_bwd_plain(h, w, labels, lse, g, *, softcap=0.0):
    s, dchain = _logits(h, w, softcap)
    p = torch.exp(s - lse.float()[:, None])
    dlog = p.scatter_add(1, labels.long()[:, None],
                         torch.full_like(p[:, :1], -1.0))
    dlog = dlog * g.float()[:, None]
    if dchain is not None:
        dlog = dlog * dchain
    return dlog @ w.float().t(), h.float().t() @ dlog


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _check_inputs(h, w, labels):
    if not (h.is_cuda and w.is_cuda and labels.is_cuda):
        raise ValueError("xent kernel: h, w, labels must all be CUDA tensors")
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"bad shapes h{tuple(h.shape)} w{tuple(w.shape)}")
    if labels.shape != (h.shape[0],):
        raise ValueError(f"labels {tuple(labels.shape)} != ({h.shape[0]},)")


def _nsplit(T, V):
    nt = -(-T // TILE)
    return max(1, min(-(-TARGET_CTAS // nt), -(-V // TILE)))


def _chunk(T, V):
    rows = max(TILE, STAGE_BYTES // (4 * V) // TILE * TILE)
    return min(rows, -(-T // TILE) * TILE)


def _vpad(V):
    return -(-V // TC_TILE) * TC_TILE


def _tc_chunk(T, V):
    """Backward chunk rows of the tensor-core route: the split dlogits
    stage (bf16 hi + lo, 4 B an element of (rows, Vp)) within
    STAGE_BYTES."""
    rows = max(TC_CHUNK, STAGE_BYTES // (4 * _vpad(V)) // TC_CHUNK * TC_CHUNK)
    return min(rows, -(-T // TC_CHUNK) * TC_CHUNK)


def _sms(t):
    if t.is_cuda:
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    return H100_SMS


def _tc_h(h):
    """h made ready for the tensor-core route: contiguous 16-B rows."""
    if h.shape[1] % 8:
        raise ValueError(f"xent tensor-core route: D = {h.shape[1]} is not a "
                         "multiple of 8 (its copies move 16-B rows)")
    h = h.contiguous()
    return h.clone() if h.data_ptr() % 16 else h


def _split_buffers(w):
    """(W_hi, W_lo) scratch of w's split, (Vp, D) bf16; no lo for bf16 w."""
    w_hi = torch.empty((_vpad(w.shape[1]), w.shape[0]), dtype=torch.bfloat16,
                       device=w.device)
    return w_hi, (torch.empty_like(w_hi) if w.dtype == torch.float32
                  else None)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_split(lib, stream, w):
    """The split pre-pass alone: (W_hi, W_lo or None), (Vp, D) bf16."""
    w_hi, w_lo = _split_buffers(w)
    err = lib.rt_xent_split(w.data_ptr(), w_hi.data_ptr(), _ptr(w_lo),
                            build.dtype_code(w), *w.shape, w.stride(0),
                            w.stride(1), stream)
    build.check(lib, err, "xent_split")
    return w_hi, w_lo


def _launch_fwd(lib, stream, h, w, labels, *, softcap):
    if h.dtype == torch.bfloat16:
        return _launch_fwd_tc(lib, stream, h, w, labels, softcap=softcap)
    h = h.contiguous()
    labels = labels.to(torch.int32).contiguous()
    T, D = h.shape
    V = w.shape[1]
    nsplit = _nsplit(T, V)
    loss = torch.empty((T,), dtype=torch.float32, device=h.device)
    lse = torch.empty((T,), dtype=torch.float32, device=h.device)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=h.device)
    err = lib.rt_xent_fwd(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                          loss.data_ptr(), lse.data_ptr(), part.data_ptr(),
                          build.dtype_code(h), build.dtype_code(w), T, D, V,
                          w.stride(0), w.stride(1), float(softcap), nsplit,
                          stream)
    build.check(lib, err, "xent_fwd")
    return loss, lse


def _launch_fwd_tc(lib, stream, h, w, labels, *, softcap):
    h = _tc_h(h)
    w_hi, w_lo = _split_buffers(w)
    labels = labels.to(torch.int32).contiguous()
    T, D = h.shape
    V = w.shape[1]
    nsplit = lib.rt_xent_tc_nsplit(T, V, _sms(h))
    loss = torch.empty((T,), dtype=torch.float32, device=h.device)
    lse = torch.empty((T,), dtype=torch.float32, device=h.device)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=h.device)
    err = lib.rt_xent_fwd_tc(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                             loss.data_ptr(), lse.data_ptr(), part.data_ptr(),
                             w_hi.data_ptr(), _ptr(w_lo), build.dtype_code(w),
                             T, D, V, w.stride(0), w.stride(1),
                             float(softcap), nsplit, stream)
    build.check(lib, err, "xent_fwd")
    return loss, lse


def _dw_like(w, h):
    D, V = w.shape
    if w.stride(0) == 1 and w.stride(1) != 1:     # transposed (V, D) storage
        return torch.empty((V, D), dtype=torch.float32, device=h.device).t()
    return torch.empty((D, V), dtype=torch.float32, device=h.device)


def _launch_bwd(lib, stream, h, w, labels, lse, g, *, softcap):
    if h.dtype == torch.bfloat16:
        return _launch_bwd_tc(lib, stream, h, w, labels, lse, g,
                              softcap=softcap)
    h = h.contiguous()
    labels = labels.to(torch.int32).contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    T, D = h.shape
    V = w.shape[1]
    chunk = _chunk(T, V)
    dh = torch.empty((T, D), dtype=torch.float32, device=h.device)
    dw = _dw_like(w, h)
    stage = torch.empty((chunk, V), dtype=torch.float32, device=h.device)
    err = lib.rt_xent_bwd(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                          lse.data_ptr(), g.data_ptr(), dh.data_ptr(),
                          dw.data_ptr(), stage.data_ptr(), build.dtype_code(h),
                          build.dtype_code(w), T, D, V, w.stride(0),
                          w.stride(1), dw.stride(0), dw.stride(1),
                          float(softcap), chunk, stream)
    build.check(lib, err, "xent_bwd")
    return dh, dw


def _launch_bwd_tc(lib, stream, h, w, labels, lse, g, *, softcap):
    h = _tc_h(h)
    w_hi, w_lo = _split_buffers(w)
    labels = labels.to(torch.int32).contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    T, D = h.shape
    V = w.shape[1]
    chunk = _tc_chunk(T, V)
    dh = torch.empty((T, D), dtype=torch.float32, device=h.device)
    dw = _dw_like(w, h)
    st_hi, st_lo = (torch.empty((chunk, _vpad(V)), dtype=torch.bfloat16,
                                device=h.device) for _ in range(2))
    err = lib.rt_xent_bwd_tc(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                             lse.data_ptr(), g.data_ptr(), dh.data_ptr(),
                             dw.data_ptr(), w_hi.data_ptr(), _ptr(w_lo),
                             st_hi.data_ptr(), st_lo.data_ptr(),
                             build.dtype_code(w), T, D, V, w.stride(0),
                             w.stride(1), dw.stride(0), dw.stride(1),
                             float(softcap), chunk, _sms(h), stream)
    build.check(lib, err, "xent_bwd")
    return dh, dw


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _count(fn, h):
    fn.launches += 1
    key = str(h.dtype).removeprefix("torch.")
    fn.launches_by_dtype[key] = fn.launches_by_dtype.get(key, 0) + 1


def xent_fwd(h, w, labels, *, softcap=0.0):
    """Per-token loss (T,) and logsumexp (T,), fp32."""
    if h.device.type == "cpu":
        return xent_fwd_plain(h, w, labels, softcap=softcap)
    _check_inputs(h, w, labels)
    out = _launch_fwd(build.load(), build.stream_ptr(h), h, w, labels,
                      softcap=softcap)
    _count(xent_fwd, h)
    return out


xent_fwd.launches = 0
xent_fwd.launches_by_dtype = {}


def xent_bwd(h, w, labels, lse, g, *, softcap=0.0):
    """dh (T, D) and dw (D, V), fp32, for upstream per-token gradient g."""
    if h.device.type == "cpu":
        return xent_bwd_plain(h, w, labels, lse, g, softcap=softcap)
    _check_inputs(h, w, labels)
    out = _launch_bwd(build.load(), build.stream_ptr(h), h, w, labels, lse,
                      g, softcap=softcap)
    _count(xent_bwd, h)
    return out


xent_bwd.launches = 0
xent_bwd.launches_by_dtype = {}
