"""Decoder-LM composition (attention and Mamba-2 mixers) with
period-stacked parameters and layer-range execution, as
``repro.models.transformer``.

Parameter layout::

    {"embed": {...},
     "blocks": {"pos0": <stacked over R reps>, ..., "pos{P-1}": ...},
     "final_norm": {...},
     "head": {...}}            # absent when cfg.tie_embeddings

where P = cfg.pattern_period and R = num_layers // P; layer i = r*P + j
lives at blocks[f"pos{j}"] leaf index [r].  The JAX ``lax.scan`` over
period repetitions is a loop over slices here, and ``remat="block"``
checkpoints each period body with ``torch.utils.checkpoint``.

MoE layers raise ``NotImplementedError``: they are a later slice
(ROADMAP.md queue A).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mlp as MLP


def _layer_kind(cfg, layer_idx: int):
    """(mixer, window) of a layer; MoE layers are not ported yet."""
    mixer, window, is_moe = cfg.layer_kind(layer_idx)
    if is_moe:
        raise NotImplementedError(
            f"{cfg.name}: layer {layer_idx} is {mixer}+moe; MoE is not "
            "ported yet (ROADMAP.md queue A)")
    return mixer, window


def init_block(gen, cfg, layer_idx: int, device="cpu", lead=()):
    mixer, _ = _layer_kind(cfg, layer_idx)
    pd = cfg.param_dtype
    p = {"pre_norm": L.init_rmsnorm(cfg.d_model, pd, device, lead)}
    if mixer == "attn":
        p["attn"] = A.init_attention(gen, cfg, device, lead)
    else:
        p["mamba"] = M.init_mamba(gen, cfg, device, lead)
    if cfg.d_ff > 0:
        p["pre_mlp_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
        p["mlp"] = MLP.init_mlp(gen, cfg, device=device, lead=lead)
    if cfg.post_block_norm:
        p["post_mixer_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
        if cfg.d_ff > 0:
            p["post_mlp_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
    return p


def _parse_impl(impl: str):
    base, _, fa_bwd = impl.partition(":")
    return base, fa_bwd or "fused"


def block_apply(cfg, p, x, positions, layer_idx: int, *, impl="kernel"):
    """One decoder block.  Returns x.  ``impl`` may carry the flash
    attention backward suffix (``"kernel:split"``); the base impl is what
    mamba sees."""
    mixer, window = _layer_kind(cfg, layer_idx)
    impl, fa_bwd = _parse_impl(impl)
    h = L.rmsnorm(p["pre_norm"], x, cfg.norm_eps, cfg.dtype)
    if mixer == "attn":
        mix, _ = A.attention(cfg, p["attn"], h, positions, window, impl=impl,
                             fa_bwd_strategy=fa_bwd)
    else:
        mix = M.mamba(cfg, p["mamba"], h, impl=impl)
    if cfg.post_block_norm:
        mix = L.rmsnorm(p["post_mixer_norm"], mix, cfg.norm_eps, cfg.dtype)
    x = x + mix
    if cfg.d_ff > 0:
        h = L.rmsnorm(p["pre_mlp_norm"], x, cfg.norm_eps, cfg.dtype)
        y = MLP.mlp(cfg, p["mlp"], h)
        if cfg.post_block_norm:
            y = L.rmsnorm(p["post_mlp_norm"], y, cfg.norm_eps, cfg.dtype)
        x = x + y
    return x


def checkpointed_block_apply(cfg, p, x, positions, layer_idx: int, *,
                             impl="kernel"):
    """block_apply recomputed in the backward (``jax.checkpoint``)."""
    return checkpoint(block_apply, cfg, p, x, positions, layer_idx,
                      impl=impl, use_reentrant=False)


def tree_index(t, r):
    """Leaf-wise ``a[r]`` over a nested dict (r an int or a slice)."""
    if isinstance(t, dict):
        return {k: tree_index(v, r) for k, v in t.items()}
    return t[r]


def init_lm(cfg, gen, device="cpu"):
    P = cfg.pattern_period
    R = cfg.num_layers // P
    params = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.param_dtype, device)}
    params["blocks"] = {f"pos{j}": init_block(gen, cfg, j, device, lead=(R,))
                        for j in range(P)}
    params["final_norm"] = L.init_rmsnorm(cfg.d_model, cfg.param_dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                      param_dtype=cfg.param_dtype,
                                      device=device)
    return params


def run_blocks(cfg, blocks, x, positions, *, lo: int = 0,
               hi: Optional[int] = None, impl="kernel", remat: str = "block"):
    """Run layers [lo, hi) of the period-stacked ``blocks``.

    Full period repetitions run as one period body each (checkpointed as a
    unit under ``remat="block"``, as the JAX scan body); the partial periods
    at either end run layer by layer (checkpointed per layer)."""
    hi = cfg.num_layers if hi is None else hi
    P = cfg.pattern_period
    ck = remat in ("block", "nested")
    one = checkpointed_block_apply if ck else block_apply

    def layer(x, i):
        r, j = divmod(i, P)
        return one(cfg, tree_index(blocks[f"pos{j}"], r), x, positions, i,
                   impl=impl)

    if hi - lo < 2 * P:
        for i in range(lo, hi):
            x = layer(x, i)
        return x

    r_start, r_end = -(-lo // P), hi // P
    for i in range(lo, min(r_start * P, hi)):
        x = layer(x, i)

    inner = checkpointed_block_apply if remat == "nested" else block_apply

    def body(x, bl):
        for j in range(P):
            x = inner(cfg, bl[f"pos{j}"], x, positions, j, impl=impl)
        return x

    for r in range(r_start, r_end):
        bl = {f"pos{j}": tree_index(blocks[f"pos{j}"], r) for j in range(P)}
        x = (checkpoint(body, x, bl, use_reentrant=False) if ck
             else body(x, bl))
    for i in range(max(r_end * P, lo), hi):
        x = layer(x, i)
    return x


def default_positions(cfg, batch: int, seq: int, device="cpu", offset=0):
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        return pos[None].expand(3, batch, seq)
    return pos


def forward(cfg, params, inputs, *, positions=None, lo: int = 0,
            hi: Optional[int] = None, impl="kernel", remat="block",
            return_logits=True):
    """Run layers [lo, hi) of the LM.

    ``inputs``: int token ids (B, S) when lo == 0, else activations
    (B, S, D).  Returns dict(hidden, logits)."""
    hi = cfg.num_layers if hi is None else hi
    if lo == 0:
        B, S = inputs.shape
        x = L.embed(params["embed"], inputs, cfg.dtype,
                    multiplier=cfg.embedding_multiplier)
    else:
        B, S = inputs.shape[:2]
        x = inputs.to(L.dt(cfg.dtype))
    if positions is None:
        positions = default_positions(cfg, B, S, x.device)
    x = run_blocks(cfg, params["blocks"], x, positions, lo=lo, hi=hi,
                   impl=impl, remat=remat)
    out = {"hidden": x, "logits": None}
    if hi == cfg.num_layers and return_logits:
        h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.dtype)
        if cfg.tie_embeddings:
            logits = L.unembed(params["embed"], h, cfg.dtype)
        else:
            logits = L.dense(params["head"], h, cfg.dtype)
        out["logits"] = L.softcap(logits, cfg.final_softcap)
        out["hidden"] = h
    return out


def head_weight(cfg, params):
    """The (D, V) output-projection matrix (transposed view when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["head"]["w"]
