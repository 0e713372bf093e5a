"""Flash attention as a ``torch.autograd.Function`` around the kernel pair.

Public layout matches the model code: q (B, S, Hkv, G, hd); k, v
(B, Skv, Hkv, hd).  As ``repro.kernels.flash_attention.ops``: the inputs
are laid out as the kernels' (BH, S, hd) / (BKV, Skv, hd) views and padded
to block multiples; the saved residuals are the padded kernel-layout
q/k/v/o/lse, so the backward never re-pads them; ``do`` is cast to fp32
and laid out once, feeding both ``delta = sum(dO * O)`` (over the fp32
kernel output) and the kernel; the output comes back in the input dtype.

On CUDA tensors the wrappers launch the Hopper kernels; on CPU tensors
they run the kernels' plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as K


def _pad_to(x, dim, mult):
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _sublane(dtype) -> int:
    """Rows of the reference's minimum tile: 8 for 4-byte, 16 for 2-byte,
    32 for 1-byte element types."""
    return {4: 8, 2: 16, 1: 32}.get(torch.empty((), dtype=dtype).element_size(), 8)


def _block_sizes(S, Skv, block_q, block_k, dtype=torch.float32):
    """The reference's padding blocks: clamped toward the sequence, rounded
    up to the dtype's sublane tile."""
    sub = _sublane(dtype)
    bq = min(block_q, max(sub, S))
    bk = min(block_k, max(sub, Skv))
    return -(-bq // sub) * sub, -(-bk // sub) * sub


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, block_q,
                block_k):
        B, S, Hkv, G, hd = q.shape
        Skv = k.shape[1]
        qk = q.permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, hd)
        kk = k.permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)
        vk = v.permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)
        bq, bk = _block_sizes(S, Skv, block_q, block_k, q.dtype)
        qp = _pad_to(qk, 1, bq).contiguous()
        kp = _pad_to(kk, 1, bk).contiguous()
        vp = _pad_to(vk, 1, bk).contiguous()
        op, lsep = K.flash_fwd(qp, kp, vp, group=G, causal=causal,
                               window=window, softcap=softcap, scale=scale,
                               kv_len=Skv)
        ctx.save_for_backward(qp, kp, vp, op, lsep)
        ctx.cfg = (causal, window, softcap, scale, block_q, block_k, Skv)
        return (op[:, :S].reshape(B, Hkv, G, S, hd).permute(0, 3, 1, 2, 4)
                .to(q.dtype))

    @staticmethod
    def backward(ctx, do):
        qp, kp, vp, op, lsep = ctx.saved_tensors
        causal, window, softcap, scale, block_q, block_k, Skv = ctx.cfg
        B, S, Hkv, G, hd = do.shape
        bq, _ = _block_sizes(S, Skv, block_q, block_k, qp.dtype)
        # one fp32 cast + layout pass over do; padded rows are zero, so
        # delta (and every gradient contribution) vanishes there
        dok = _pad_to(do.permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, hd)
                      .float(), 1, bq).contiguous()
        delta = torch.sum(dok * op, dim=-1)
        dq, dk, dv = K.flash_bwd_fused(qp, kp, vp, dok, lsep, delta, group=G,
                                       causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       kv_len=Skv)
        dq = dq[:, :S].reshape(B, Hkv, G, S, hd).permute(0, 3, 1, 2, 4)
        dk = dk[:, :Skv].reshape(B, Hkv, Skv, hd).permute(0, 2, 1, 3)
        dv = dv[:, :Skv].reshape(B, Hkv, Skv, hd).permute(0, 2, 1, 3)
        return (dq.to(qp.dtype), dk.to(kp.dtype), dv.to(vp.dtype),
                None, None, None, None, None, None)


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0, scale=1.0,
                    block_q=128, block_k=128, bwd_strategy="fused"):
    """Returns (B, S, Hkv, G, hd) attention output in the input dtype."""
    if bwd_strategy == "split":
        raise NotImplementedError(
            "bwd_strategy='split' needs flash_bwd_dq/flash_bwd_dkv, which "
            "are not ported yet (ROADMAP.md queue B)")
    if bwd_strategy != "fused":
        raise ValueError(f"unknown bwd_strategy: {bwd_strategy!r}")
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 block_q, block_k)
