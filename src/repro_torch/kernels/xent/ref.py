"""Materializing oracle for the fused cross-entropy (test scale only)."""

from __future__ import annotations

import torch


def cross_entropy_ref(hidden, w, labels, mask=None, softcap: float = 0.0):
    """hidden (T, D); w (D, V); labels (T,); mask (T,) or None.

    Returns (mean_loss, per_token_loss)."""
    logits = hidden.float() @ w.float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    lse = torch.logsumexp(logits, dim=-1)
    correct = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    per_token = lse - correct
    mask = torch.ones_like(per_token) if mask is None else mask.float()
    loss = torch.sum(per_token * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, per_token
