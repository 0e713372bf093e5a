"""Attention: GQA/MQA with RoPE/M-RoPE, sliding windows, logit soft-capping,
per-head qk-norm, QKV bias and a KV cache for prefill and decode, as
``repro.models.attention``.

Two implementations sit behind one interface:

* ``impl="kernel"`` — :func:`repro_torch.kernels.flash_attention.ops
  .flash_attention`, the hand-written Hopper kernel pair on CUDA tensors
  and its plain version on CPU tensors.  The port's path.
* ``impl="xla"``    — :func:`chunked_attention`, the eager counterpart of
  the JAX package's chunked online-softmax ``"xla"`` path.

``":split"`` selects the two-sweep backward (``bwd_strategy="split"``);
the default is the fused one.  Both repeat bit for bit on the card.
Cache layout: ``{"k": (B, Smax, Hkv, hd), "v": (B, Smax, Hkv, hd)}``, views
into the caller's stacked caches that prefill and decode write in place,
plus a position ``cache_index`` held by the caller (shared by the layers).
Prefill attends over the prompt alone (through the same two impls);
decode attends over the whole cache with :func:`dot_attention`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.sharding.annotations import shard, write_at

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
              cache_index=None, impl: str = "kernel", kv_block: int = 1024,
              fa_bwd_strategy: str = "fused"):
    """Attention sublayer: projections, rope, core, out-projection.

    Modes: no cache -> training (full-sequence causal); a cache and S > 1
    -> prefill (writes cache[:, 0:S]); a cache and S == 1 -> one decode
    token at ``cache_index`` (an int).  Returns (y, cache)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    cd = cfg.dtype

    # under a mesh binding: heads whole on every rank (a DTensor cannot
    # split a head dim sharded finer than a head), the queries sharded over
    # the sequence ("seq": the one place the sequence shards) and the keys
    # and values whole
    q = shard(L.dense(p["wq"], x, cd), "batch", "seq", None).reshape(
        B, S, H, hd)
    k = shard(L.dense(p["wk"], x, cd), "batch", None, None).reshape(
        B, S, Hkv, hd)
    v = shard(L.dense(p["wv"], x, cd), "batch", None, None).reshape(
        B, S, Hkv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps, cd)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps, cd)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    qg = q.reshape(B, S, Hkv, G, hd)
    kw = dict(window=window, softcap=cfg.attn_softcap, scale=_scale(cfg))
    if cache is not None and S == 1:
        idx = cache_index
        write_at(cache["k"], 1, idx, k[:, 0])
        write_at(cache["v"], 1, idx, v[:, 0])
        o = dot_attention(qg, cache["k"], cache["v"], causal=False,
                          q_offset=idx, kv_valid_len=idx + 1, **kw)
    else:
        if cache is not None:  # prefill: the prompt fills cache[:, :S]
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        if impl == "kernel":
            o = fa_ops.flash_attention(qg, k, v, causal=True,
                                       bwd_strategy=fa_bwd_strategy, **kw)
        elif impl == "xla":
            o = chunked_attention(qg, k, v, causal=True, kv_block=kv_block,
                                  **kw)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")
    o = shard(o.reshape(B, S, H * hd).to(L.dt(cd)), "batch", None, None)
    return L.dense(p["wo"], o, cd), cache


def init_cache(cfg, batch: int, max_len: int, dtype="bfloat16",
               device="cpu"):
    """Zero K and V caches of one attention layer."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.dt(dtype), device=device),
            "v": torch.zeros(shape, dtype=L.dt(dtype), device=device)}
