"""Loss functions of the LM path."""

from __future__ import annotations

import torch

from repro_torch.kernels.xent import ops as xent_ops


def lm_loss_from_hidden(hidden, head_w, tokens, *, softcap: float = 0.0,
                        loss_mask=None):
    """Next-token CE computed from the final hidden states through the
    fused xent op (logits are never materialized on the kernel path).

    hidden: (B, S, D) post-final-norm; head_w: (D, V); tokens: (B, S).
    Position t predicts token t+1; the last position is masked out.
    """
    B, S, D = hidden.shape
    h = hidden[:, :-1].reshape(B * (S - 1), D)
    labels = tokens[:, 1:].reshape(B * (S - 1))
    if loss_mask is None:
        mask = torch.ones((B * (S - 1),), device=hidden.device)
    else:
        mask = loss_mask[:, 1:].reshape(B * (S - 1)).float()
    loss, _ = xent_ops.cross_entropy(h, head_w, labels, mask,
                                     softcap=softcap)
    return loss, {"loss": loss}


def lm_loss_from_logits(logits, tokens, loss_mask=None):
    """Next-token CE from materialized logits (evaluation path)."""
    logf = logits[:, :-1].float()
    labels = tokens[:, 1:].long()
    lse = torch.logsumexp(logf, dim=-1)
    corr = torch.gather(logf, -1, labels[..., None])[..., 0]
    per = lse - corr
    mask = torch.ones_like(per) if loss_mask is None \
        else loss_mask[:, 1:].float()
    loss = torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"loss": loss}
