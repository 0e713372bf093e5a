"""Fused (never-materialize-the-logits) cross entropy over huge vocabularies.

* ``impl="kernel"`` — :class:`_FusedXent`, a ``torch.autograd.Function``
  around the ``xent_fwd``/``xent_bwd`` kernel pair (Hopper kernels on CUDA
  tensors, their plain versions on CPU tensors).  This is the port's path.
* ``impl="sharded"`` — :func:`_sharded_per_token`, plain PyTorch ops whose
  fp32 logits are annotated ("batch", "vocab"): on ``DTensor`` operands
  under a mesh binding the logits stay vocab-sharded and the reductions
  become collectives.  This is the path the dry-run traces; without a
  binding it is a materializing loss recomputed in the backward.
* ``impl="xla"``    — :func:`_blockwise_per_token`, plain PyTorch ops over
  vocab tiles carrying the online (max, sumexp, correct-logit) statistics,
  each tile checkpointed so the backward recomputes its logits: the JAX
  package's blockwise loss, the route its dry-run costs the device round
  on.
* ``impl="ref"``    — the materializing oracle (test scale only).

All support gemma2's final-logit softcap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.xent import kernel as K
from repro_torch.kernels.xent.ref import cross_entropy_ref
from repro_torch.observability.profiling import annotate
from repro_torch.sharding.annotations import (current_mesh, logical_to_spec,
                                              mesh_axis_sizes, shard)

# the profiler range of both launches (--profile): the reference's name
# for its kernel entry point
RANGE = "fused_xent_pallas"


class _FusedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, labels, softcap):
        with annotate(RANGE):
            loss, lse = K.xent_fwd(h, w, labels, softcap=softcap)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.softcap = softcap
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        with annotate(RANGE):
            dh, dw = K.xent_bwd(h, w, labels, lse, g, softcap=ctx.softcap)
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def fused_xent(h, w, labels, softcap: float = 0.0):
    """Per-token cross-entropy (T,) through the kernel pair."""
    return _FusedXent.apply(h, w, labels, softcap)


def _blockwise_tile(hf, w_blk, labels, m, l, corr, base: int, V: int,
                    softcap: float):
    """One vocab tile's update of the online (m, l, correct) statistics."""
    block = w_blk.shape[1]
    logits = hf @ w_blk.float()                               # (T, block)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    ids = base + torch.arange(block, device=logits.device)
    logits = torch.where((ids < V)[None, :], logits, float("-inf"))
    m_new = torch.maximum(m, torch.amax(logits, dim=-1))
    l_new = l * torch.exp(m - m_new) + torch.sum(
        torch.exp(logits - m_new[:, None]), dim=-1)
    is_here = (labels >= base) & (labels < base + block)
    local = torch.clamp(labels - base, 0, block - 1).long()
    got = torch.gather(logits, 1, local[:, None])[:, 0]
    return m_new, l_new, torch.where(is_here, got, corr)


def _blockwise_per_token(hidden, w, labels, softcap: float, block: int):
    """Per-token CE from online (max, sumexp, correct-logit) statistics
    over vocab tiles of ``block`` (the last padded and masked with -inf);
    no (T, V) logits are kept: each tile is checkpointed.  The tiles are
    one ``split`` of the table, whose backward concatenates the tiles'
    gradients once (a slice a tile would zero-fill a whole-table gradient
    for each)."""
    T, V = hidden.shape[0], w.shape[1]
    pad = (-V) % block
    if pad:
        w = F.pad(w, (0, pad))
    hf = hidden.float()
    m = torch.full((T,), float("-inf"), device=hidden.device)
    l = torch.zeros((T,), device=hidden.device)
    corr = torch.zeros((T,), device=hidden.device)
    for j, w_blk in enumerate(w.split(block, dim=1)):
        m, l, corr = checkpoint(_blockwise_tile, hf, w_blk, labels, m, l,
                                corr, j * block, V, softcap,
                                use_reentrant=False)
    return (torch.log(l) + m) - corr


def _vocab_shards() -> int:
    """Size of the mesh axes bound to the logical "vocab" axis (1 when no
    mesh binding is active)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    spec = logical_to_spec("vocab")[0]
    if spec is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in ((spec,) if isinstance(spec, str) else spec):
        n *= sizes[a]
    return n


def _sharded_per_token(hidden, w, labels, softcap: float):
    """Per-token CE over logits materialized *sharded* over (batch x
    vocab) and reduced with collectives (under a binding); the checkpoint
    makes the backward recompute the logits instead of saving (T, V) fp32.

    Vocabularies that do not divide the vocab-shard count are padded up to
    a multiple and masked with -1e30 (an uneven vocab would replicate the
    logits)."""
    V = w.shape[1]
    pad = (-V) % _vocab_shards()
    if pad:
        w = F.pad(w, (0, pad))

    def f(h, wv):
        logits = torch.einsum("td,dv->tv", h.float(), wv.float())
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        logits = shard(logits, "batch", "vocab")
        ids = torch.arange(logits.shape[1], device=logits.device)[None, :]
        if pad:
            logits = torch.where(ids < V, logits, -1e30)
        # the vocab reductions land replicated over the vocab shards (one
        # all-reduce each), never vocab-scattered token vectors
        m = shard(torch.amax(logits, dim=-1, keepdim=True).detach(),
                  "batch", None)
        sumexp = shard(torch.sum(torch.exp(logits - m), dim=-1), "batch")
        corr = shard(torch.sum(torch.where(ids == labels[:, None], logits,
                                           0.0), dim=-1), "batch")
        return m[:, 0] + torch.log(sumexp) - corr

    return checkpoint(f, hidden, w, use_reentrant=False)


def cross_entropy(hidden, w, labels, mask=None, *, softcap: float = 0.0,
                  impl: str = "kernel", block: int = 2048):
    """Mean cross-entropy; hidden (T, D), w (D, V), labels (T,).

    Returns (loss, per_token_loss); differentiable wrt hidden and w.
    ``block`` is the vocab tile of ``impl="xla"``."""
    if impl == "ref":
        return cross_entropy_ref(hidden, w, labels, mask, softcap)
    if impl == "sharded":
        per_token = _sharded_per_token(hidden, w, labels, softcap)
    elif impl == "xla":
        per_token = _blockwise_per_token(hidden, w, labels, softcap, block)
    elif impl == "kernel":
        per_token = fused_xent(hidden, w, labels, softcap)
    else:
        raise ValueError(f"unknown xent impl {impl!r}")
    mask = torch.ones_like(per_token) if mask is None else mask.float()
    loss = torch.sum(per_token * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, per_token
