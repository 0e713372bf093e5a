"""Quadratic oracle for flash attention (materializes the scores)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=1.0):
    """q: (B, S, Hkv, G, hd); k, v: (B, Skv, Hkv, hd).  fp32 output, plus
    the row logsumexp (B, S, Hkv, G)."""
    S, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bsngd,bcnd->bsngc", q.float() * scale, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bsngc,bcnd->bsngd", p, v.float()) / l[..., None]
    return o, m + torch.log(l)
