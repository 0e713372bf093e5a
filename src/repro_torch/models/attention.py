"""Attention: GQA/MQA with RoPE/M-RoPE, sliding windows, logit soft-capping,
per-head qk-norm and QKV bias — the training mode of
``repro.models.attention``.

Two implementations sit behind one interface:

* ``impl="kernel"`` — :func:`repro_torch.kernels.flash_attention.ops
  .flash_attention`, the hand-written Hopper kernel pair on CUDA tensors
  and its plain version on CPU tensors.  The port's path.
* ``impl="xla"``    — :func:`chunked_attention`, the eager counterpart of
  the JAX package's chunked online-softmax ``"xla"`` path.

``":split"`` selects the two-sweep backward (``bwd_strategy="split"``);
the default is the fused one.  Both repeat bit for bit on the card.
The prefill and decode modes (KV cache) come with the serving slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_attention(gen, cfg, device="cpu", lead=()):
    hd, D = cfg.head_dim, cfg.d_model
    kw = dict(param_dtype=cfg.param_dtype, device=device, lead=lead)
    p = {"wq": L.init_dense(gen, D, cfg.num_heads * hd, bias=cfg.qkv_bias, **kw),
         "wk": L.init_dense(gen, D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw),
         "wv": L.init_dense(gen, D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw),
         "wo": L.init_dense(gen, cfg.num_heads * hd, D, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = L.init_rmsnorm(hd, cfg.param_dtype, device, lead)
        p["k_norm"] = L.init_rmsnorm(hd, cfg.param_dtype, device, lead)
    return p


def _scale(cfg) -> float:
    return cfg.attention_multiplier or 1.0 / math.sqrt(cfg.head_dim)


def _mask(Sq, Skv, *, causal, window, q_offset, kv_valid_len, device):
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    if kv_valid_len is not None:
        mask = mask & (k_pos < kv_valid_len)
    return mask


def chunked_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                      scale: float, q_offset=0, kv_valid_len=None,
                      kv_block: int = 1024):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hkv, G, hd); k, v: (B, Skv, Hkv, hd).  Returns
    (B, Sq, Hkv, G, hd) in fp32."""
    B, Sq, Hkv, G, hd = q.shape
    Skv = k.shape[1]
    kv_block = min(kv_block, Skv)
    if Skv % kv_block:  # pad KV to a block multiple; padding is masked out
        pad = kv_block - Skv % kv_block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = Skv
        Skv = k.shape[1]
    qf = q.float() * scale
    m = torch.full((B, Sq, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, hd), device=q.device)
    full = _mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                 kv_valid_len=kv_valid_len, device=q.device)
    for c0 in range(0, Skv, kv_block):
        kb = k[:, c0:c0 + kv_block].float()
        vb = v[:, c0:c0 + kv_block].float()
        s = torch.einsum("bsngd,bcnd->bsngc", qf, kb)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = full[:, c0:c0 + kv_block]
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsngc,bcnd->bsngd", p, vb)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def dot_attention(q, k, v, *, causal: bool, window: int, softcap: float,
                  scale: float, q_offset=0, kv_valid_len=None):
    """Direct quadratic attention.  Shapes as :func:`chunked_attention`."""
    Sq, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bsngd,bcnd->bsngc", q.float() * scale, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                 kv_valid_len=kv_valid_len, device=q.device)
    s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bsngc,bcnd->bsngd", p, v.float())


def attention(cfg, p, x, positions, window: int, *, cache=None,
              impl: str = "kernel", kv_block: int = 1024,
              fa_bwd_strategy: str = "fused"):
    """Training-mode attention sublayer: projections, rope, core,
    out-projection.  Returns (y, None)."""
    if cache is not None:
        raise NotImplementedError(
            "prefill/decode attention comes with the serving slice "
            "(ROADMAP.md queue A)")
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    cd = cfg.dtype

    q = L.dense(p["wq"], x, cd).reshape(B, S, H, hd)
    k = L.dense(p["wk"], x, cd).reshape(B, S, Hkv, hd)
    v = L.dense(p["wv"], x, cd).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps, cd)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps, cd)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    qg = q.reshape(B, S, Hkv, G, hd)
    kw = dict(causal=True, window=window, softcap=cfg.attn_softcap,
              scale=_scale(cfg))
    if impl == "kernel":
        o = fa_ops.flash_attention(qg, k, v, bwd_strategy=fa_bwd_strategy, **kw)
    elif impl == "xla":
        o = chunked_attention(qg, k, v, kv_block=kv_block, **kw)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    o = o.reshape(B, S, H * hd).to(L.dt(cd))
    return L.dense(p["wo"], o, cd), None
