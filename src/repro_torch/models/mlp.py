"""MLP sublayers: SwiGLU / GeGLU (gated) and plain GELU two-layer."""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def init_mlp(gen, cfg, d_ff: int = 0, device="cpu", lead=()):
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    kw = dict(param_dtype=cfg.param_dtype, device=device, lead=lead)
    if cfg.mlp_activation in ("silu", "geglu"):
        return {"wg": L.init_dense(gen, D, F, **kw),
                "wi": L.init_dense(gen, D, F, **kw),
                "wo": L.init_dense(gen, F, D, **kw)}
    return {"wi": L.init_dense(gen, D, F, **kw),
            "wo": L.init_dense(gen, F, D, **kw)}


def mlp(cfg, p, x):
    cd = cfg.dtype
    act = L.activation_fn(cfg.mlp_activation)
    if "wg" in p:
        h = act(L.dense(p["wg"], x, cd).to(torch.float32)).to(L.dt(cd))
        h = h * L.dense(p["wi"], x, cd)
    else:
        h = act(L.dense(p["wi"], x, cd).to(torch.float32)).to(L.dt(cd))
    return L.dense(p["wo"], h, cd)
