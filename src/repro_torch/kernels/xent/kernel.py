"""Fused cross-entropy kernel wrappers: forward and backward.

``xent_fwd`` and ``xent_bwd`` replace the TPU Pallas kernels of the same
names in ``repro/kernels/xent/kernel.py`` (pallas_call at :126, and
:281/:299).  On a CUDA tensor each launches its hand-written Hopper
kernels (``csrc/xent.cu``; the source says what bounds them and what the
design does about that) or raises; on a CPU tensor it runs its plain
PyTorch version below, which materializes the (T, V) logits.

h (T, D) in the model dtype; w (D, V) with any strides — the tied
auxiliary head passes a transposed view of the (V, D) embedding table and
the kernels read it in place; labels (T,).  Outputs are fp32; ``dw`` comes
back with ``w``'s layout (a transposed view of a (V, D) buffer for the
tied head), so it reaches the embedding gradient without a copy.  Each
wrapper carries ``launches``, the number of calls that launched kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
TILE = 64                       # token / vocabulary tile of the kernels
STAGE_BYTES = 512 * 2 ** 20     # bound on the backward's dlogits staging
TARGET_CTAS = 264               # forward: two CTAs per SM on 132 SMs


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


def _launch_fwd(lib, stream, h, w, labels, *, softcap):
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


def _launch_bwd(lib, stream, h, w, labels, lse, g, *, softcap):
    h = h.contiguous()
    labels = labels.to(torch.int32).contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    T, D = h.shape
    V = w.shape[1]
    chunk = _chunk(T, V)
    dh = torch.empty((T, D), dtype=torch.float32, device=h.device)
    if w.stride(0) == 1 and w.stride(1) != 1:     # transposed (V, D) storage
        dw = torch.empty((V, D), dtype=torch.float32, device=h.device).t()
    else:
        dw = torch.empty((D, V), dtype=torch.float32, device=h.device)
    stage = torch.empty((chunk, V), dtype=torch.float32, device=h.device)
    err = lib.rt_xent_bwd(h.data_ptr(), w.data_ptr(), labels.data_ptr(),
                          lse.data_ptr(), g.data_ptr(), dh.data_ptr(),
                          dw.data_ptr(), stage.data_ptr(), build.dtype_code(h),
                          build.dtype_code(w), T, D, V, w.stride(0),
                          w.stride(1), dw.stride(0), dw.stride(1),
                          float(softcap), chunk, stream)
    build.check(lib, err, "xent_bwd")
    return dh, dw


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def xent_fwd(h, w, labels, *, softcap=0.0):
    """Per-token loss (T,) and logsumexp (T,), fp32."""
    if h.device.type == "cpu":
        return xent_fwd_plain(h, w, labels, softcap=softcap)
    _check_inputs(h, w, labels)
    out = _launch_fwd(build.load(), build.stream_ptr(h), h, w, labels,
                      softcap=softcap)
    xent_fwd.launches += 1
    return out


xent_fwd.launches = 0


def xent_bwd(h, w, labels, lse, g, *, softcap=0.0):
    """dh (T, D) and dw (D, V), fp32, for upstream per-token gradient g."""
    if h.device.type == "cpu":
        return xent_bwd_plain(h, w, labels, lse, g, softcap=softcap)
    _check_inputs(h, w, labels)
    out = _launch_bwd(build.load(), build.stream_ptr(h), h, w, labels, lse,
                      g, softcap=softcap)
    xent_bwd.launches += 1
    return out


xent_bwd.launches = 0
