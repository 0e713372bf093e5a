"""Decoder-LM composition (attention and Mamba-2 mixers, dense or MoE
MLPs) with period-stacked parameters and layer-range execution, as
``repro.models.transformer``.

Parameter layout::

    {"embed": {...},
     "blocks": {"pos0": <stacked over R reps>, ..., "pos{P-1}": ...},
     "final_norm": {...},
     "head": {...}}            # absent when cfg.tie_embeddings

where P = cfg.pattern_period and R = num_layers // P; layer i = r*P + j
lives at blocks[f"pos{j}"] leaf index [r].  The JAX ``lax.scan`` over
period repetitions is a loop over slices here, and ``remat="block"``
checkpoints each period body with ``torch.utils.checkpoint``.  Every
block also returns its MoE load-balancing loss (a 0-d fp32 zero for a
layer without MoE), and ``run_blocks`` sums it over the layers it runs.

Serving: :func:`init_caches` lays the caches out as the parameters
(``caches[f"pos{j}"]`` leaves stacked over R), and a cached call writes
each layer's new entries in place through views of that stack, so the
caller's tree is the updated one.  Cached calls never checkpoint.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.sharding import shard


def _has_mlp(cfg, is_moe: bool) -> bool:
    return is_moe or cfg.d_ff > 0


def init_block(gen, cfg, layer_idx: int, device="cpu", lead=()):
    mixer, _, is_moe = cfg.layer_kind(layer_idx)
    pd = cfg.param_dtype
    p = {"pre_norm": L.init_rmsnorm(cfg.d_model, pd, device, lead)}
    if mixer == "attn":
        p["attn"] = A.init_attention(gen, cfg, device, lead)
    else:
        p["mamba"] = M.init_mamba(gen, cfg, device, lead)
    if _has_mlp(cfg, is_moe):
        p["pre_mlp_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
        if is_moe:
            p["moe"] = MOE.init_moe(gen, cfg, device, lead)
        else:
            p["mlp"] = MLP.init_mlp(gen, cfg, device=device, lead=lead)
    if cfg.post_block_norm:
        p["post_mixer_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
        if _has_mlp(cfg, is_moe):
            p["post_mlp_norm"] = L.init_rmsnorm(cfg.d_model, pd, device, lead)
    return p


def _parse_impl(impl: str):
    base, _, fa_bwd = impl.partition(":")
    return base, fa_bwd or "fused"


def block_apply(cfg, p, x, positions, layer_idx: int, *, cache=None,
                cache_index=None, impl="kernel"):
    """One decoder block.  Returns (x, aux): ``aux`` is the MoE
    load-balancing loss, a 0-d fp32 tensor (zero without MoE).  ``impl``
    may carry the flash attention backward suffix (``"kernel:split"``);
    the base impl is what mamba sees.  ``cache``, the layer's view of the
    stacked caches, is written in place (prefill or decode)."""
    mixer, window, is_moe = cfg.layer_kind(layer_idx)
    impl, fa_bwd = _parse_impl(impl)
    # the residual stream shards over the batch only: a (batch, seq) pair
    # over two mesh dims flattens into matmul rows as a strided shard,
    # which DTensor plans for exponentially in the mesh dims; the sequence
    # shards inside attention (attention.py)
    x = shard(x, "batch", None, None)
    h = L.rmsnorm(p["pre_norm"], x, cfg.norm_eps, cfg.dtype)
    if mixer == "attn":
        mix, _ = A.attention(cfg, p["attn"], h, positions, window,
                             cache=cache, cache_index=cache_index, impl=impl,
                             fa_bwd_strategy=fa_bwd)
    else:
        mix, _ = M.mamba(cfg, p["mamba"], h, cache=cache, impl=impl)
    if cfg.post_block_norm:
        mix = L.rmsnorm(p["post_mixer_norm"], mix, cfg.norm_eps, cfg.dtype)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_mlp(cfg, is_moe):
        x = shard(x, "batch", None, None)
        h = L.rmsnorm(p["pre_mlp_norm"], x, cfg.norm_eps, cfg.dtype)
        if is_moe:
            y, aux = MOE.moe_mlp(cfg, p["moe"], h)
        else:
            y = MLP.mlp(cfg, p["mlp"], h)
        if cfg.post_block_norm:
            y = L.rmsnorm(p["post_mlp_norm"], y, cfg.norm_eps, cfg.dtype)
        x = x + y
    return shard(x, "batch", None, None), aux


def checkpointed_block_apply(cfg, p, x, positions, layer_idx: int, *,
                             cache=None, cache_index=None, impl="kernel"):
    """block_apply recomputed in the backward (``jax.checkpoint``)."""
    return checkpoint(block_apply, cfg, p, x, positions, layer_idx,
                      cache=cache, cache_index=cache_index, impl=impl,
                      use_reentrant=False)


def tree_index(t, r):
    """Leaf-wise ``a[r]`` over a nested dict (r an int or a slice)."""
    if isinstance(t, dict):
        return {k: tree_index(v, r) for k, v in t.items()}
    return t[r]


def init_caches(cfg, batch: int, max_len: int, *, kv_dtype="bfloat16",
                device="cpu"):
    """Zero caches of every layer, ``caches[f"pos{j}"]`` leaves stacked
    over the R period repetitions: K and V in ``kv_dtype`` for attention
    layers, the Mamba conv and SSM state in fp32."""
    P = cfg.pattern_period
    R = cfg.num_layers // P
    caches = {}
    for j in range(P):
        if cfg.layer_kind(j)[0] == "attn":
            one = A.init_cache(cfg, batch, max_len, kv_dtype, device)
        else:
            one = M.init_mamba_cache(cfg, batch, "float32", device)
        caches[f"pos{j}"] = {k: v.expand((R,) + v.shape).clone()
                             for k, v in one.items()}
    return caches


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
               hi: Optional[int] = None, caches=None, cache_index=None,
               impl="kernel", remat: str = "block"):
    """Run layers [lo, hi) of the period-stacked ``blocks``.

    Full period repetitions run as one period body each (checkpointed as a
    unit under ``remat="block"``, as the JAX scan body); the partial periods
    at either end run layer by layer (checkpointed per layer).  With
    ``caches`` each layer reads and writes its slice of them in place, and
    nothing is checkpointed.  Returns (x, the layers' summed MoE
    load-balancing loss)."""
    hi = cfg.num_layers if hi is None else hi
    P = cfg.pattern_period
    ck = remat in ("block", "nested") and caches is None
    one = checkpointed_block_apply if ck else block_apply
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def cache_of(r, j):
        return None if caches is None else tree_index(caches[f"pos{j}"], r)

    def layer(x, aux_total, i):
        r, j = divmod(i, P)
        x, aux = one(cfg, tree_index(blocks[f"pos{j}"], r), x, positions, i,
                     cache=cache_of(r, j), cache_index=cache_index, impl=impl)
        return x, aux_total + aux

    if hi - lo < 2 * P:
        for i in range(lo, hi):
            x, aux_total = layer(x, aux_total, i)
        return x, aux_total

    r_start, r_end = -(-lo // P), hi // P
    for i in range(lo, min(r_start * P, hi)):
        x, aux_total = layer(x, aux_total, i)

    nested = remat == "nested" and ck
    inner = checkpointed_block_apply if nested else block_apply

    def body(x, aux_total, bl, r):
        for j in range(P):
            x, aux = inner(cfg, bl[f"pos{j}"], x, positions, j,
                           cache=cache_of(r, j), cache_index=cache_index,
                           impl=impl)
            aux_total = aux_total + aux
        return x, aux_total

    for r in range(r_start, r_end):
        bl = {f"pos{j}": tree_index(blocks[f"pos{j}"], r) for j in range(P)}
        x, aux_total = (
            checkpoint(body, x, aux_total, bl, r, use_reentrant=False) if ck
            else body(x, aux_total, bl, r))
    for i in range(max(r_end * P, lo), hi):
        x, aux_total = layer(x, aux_total, i)
    return x, aux_total


def default_positions(cfg, batch: int, seq: int, device="cpu", offset=0):
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        return pos[None].expand(3, batch, seq)
    return pos


def forward(cfg, params, inputs, *, positions=None, lo: int = 0,
            hi: Optional[int] = None, caches=None, cache_index=None,
            impl="kernel", remat="block", return_logits=True):
    """Run layers [lo, hi) of the LM.

    ``inputs``: int token ids (B, S) when lo == 0, else activations
    (B, S, D).  With ``caches`` (:func:`init_caches`) the call is prefill
    (S > 1, from position 0) or one decode token at ``cache_index``, and
    the default positions start there.  Returns dict(hidden, logits, aux,
    caches): ``caches`` the same tree, updated in place."""
    hi = cfg.num_layers if hi is None else hi
    if lo == 0:
        B, S = inputs.shape
        x = L.embed(params["embed"], inputs, cfg.dtype,
                    multiplier=cfg.embedding_multiplier)
    else:
        B, S = inputs.shape[:2]
        x = inputs.to(L.dt(cfg.dtype))
    if positions is None:
        off = 0 if cache_index is None else cache_index
        positions = default_positions(cfg, B, S, x.device, offset=off)
    x = shard(x, "batch", None, None)
    x, aux = run_blocks(cfg, params["blocks"], x, positions, lo=lo, hi=hi,
                        caches=caches, cache_index=cache_index, impl=impl,
                        remat=remat)
    out = {"hidden": x, "logits": None, "aux": aux, "caches": caches}
    if hi == cfg.num_layers and return_logits:
        out["hidden"], logits = head(cfg, params, x)
        out["logits"] = shard(logits, "batch", None, "vocab")
    return out


def head(cfg, params, x):
    """The final norm and the head over rows ``x`` of the last layer's
    hidden states (any positions of them): (normed hidden, logits)."""
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.dtype)
    return h, logits_from_hidden(cfg, params, h)


def logits_from_hidden(cfg, params, h):
    """The head over final-normed hidden states: the tied unembed or the
    head's dense, then the final softcap."""
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"], h, cfg.dtype)
    else:
        logits = L.dense(params["head"], h, cfg.dtype)
    return L.softcap(logits, cfg.final_softcap)


def head_weight(cfg, params):
    """The (D, V) output-projection matrix (transposed view when tied)."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["head"]["w"]
