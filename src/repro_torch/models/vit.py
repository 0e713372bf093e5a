"""ViT-S and Swin-T-style classifiers of the paper's evaluation, as
``repro.models.vit``.

Layer-indexed like the CNN path: layer 0 = patch embedding, layers
1..depth = encoder blocks, mean-pool + FC head.  Swin runs window
attention with cyclic shifts (``torch.roll``) on every even layer, at a
constant resolution (no patch merging).  Attention is fp32 ``einsum`` and
softmax, as the reference computes it; the gelu is the tanh form, which
is ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def num_patches(cfg) -> int:
    return (cfg.img_size // cfg.patch_size) ** 2


def vit_scaled_dims(cfg, width_scale: float = 1.0):
    """(D, heads, F) of a (possibly width-scaled) encoder block."""
    D = max(8, int(round(cfg.d_model * width_scale)))
    H = max(1, int(round(cfg.num_heads * width_scale)))
    while D % H:
        H -= 1
    F_ = int(D * cfg.mlp_ratio)
    return D, H, F_


def init_vit_layer(gen, cfg, layer_idx: int, in_dim: Optional[int] = None,
                   width_scale: float = 1.0, device="cpu"):
    pd = cfg.param_dtype
    D, _, F_ = vit_scaled_dims(cfg, width_scale)

    def dense(i, o):
        return L.init_dense(gen, i, o, bias=True, param_dtype=pd,
                            device=device)

    if layer_idx == 0:
        cin = in_dim if in_dim is not None else cfg.in_channels
        return {"proj": dense(cfg.patch_size * cfg.patch_size * cin, D),
                "pos": L.normal_init(gen, (num_patches(cfg), D), 0.02, pd,
                                     device)}
    din = in_dim if in_dim is not None else D
    return {
        "norm1": L.init_layernorm(din, pd, device),
        "wq": dense(din, D), "wk": dense(din, D), "wv": dense(din, D),
        "wo": dense(D, din),
        "norm2": L.init_layernorm(din, pd, device),
        "wi": dense(din, F_), "wom": dense(F_, din),
    }


def patchify(cfg, images):
    """(B, s, s, C) images -> (B, patches, P*P*C), row-major patches."""
    B = images.shape[0]
    P = cfg.patch_size
    Hn = cfg.img_size // P
    x = images.reshape(B, Hn, P, Hn, P, images.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hn * Hn, -1)


def _mha(p, x, heads: int, window: int = 0, shift: int = 0, grid: int = 0,
         compute_dtype="float32"):
    B, N, _ = x.shape
    q = L.dense(p["wq"], x, compute_dtype)
    k = L.dense(p["wk"], x, compute_dtype)
    v = L.dense(p["wv"], x, compute_dtype)
    D = q.shape[-1]
    hd = D // heads

    if window:
        # (B, g, g, D) -> shifted -> windows of (window x window)
        g, nw = grid, grid // window

        def towin(t):
            t = t.reshape(B, g, g, D)
            if shift:
                t = torch.roll(t, (-shift, -shift), dims=(1, 2))
            t = t.reshape(B, nw, window, nw, window, D)
            return t.permute(0, 1, 3, 2, 4, 5).reshape(B * nw * nw,
                                                       window * window, D)
        q, k, v = towin(q), towin(k), towin(v)
    Bw, Nw = q.shape[0], q.shape[1]

    qh, kh, vh = (t.reshape(Bw, Nw, heads, hd).float() for t in (q, k, v))
    s = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(hd)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", a, vh).reshape(Bw, Nw, D)

    if window:
        o = o.reshape(B, nw, nw, window, window, D)
        o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, g, g, D)
        if shift:
            o = torch.roll(o, (shift, shift), dims=(1, 2))
        o = o.reshape(B, N, D)
    return L.dense(p["wo"], o.to(L.dt(compute_dtype)), compute_dtype)


def apply_vit_layer(cfg, p, x, layer_idx: int, heads: Optional[int] = None):
    cd = cfg.dtype
    if layer_idx == 0:
        x = L.dense(p["proj"], patchify(cfg, x), cd)
        return x + L.cast(p["pos"], cd)
    heads = heads if heads is not None else cfg.num_heads
    window, shift, grid = 0, 0, 0
    if cfg.family == "swin" and cfg.window_size:
        grid = cfg.img_size // cfg.patch_size
        window = cfg.window_size
        shift = (cfg.window_size // 2) if (layer_idx % 2 == 0) else 0
    h = L.layernorm(p["norm1"], x, cfg.norm_eps, cd)
    x = x + _mha(p, h, heads, window, shift, grid, cd)
    h = L.layernorm(p["norm2"], x, cfg.norm_eps, cd)
    u = F.gelu(L.dense(p["wi"], h, cd).float(), approximate="tanh")
    return x + L.dense(p["wom"], u.to(L.dt(cd)), cd)
