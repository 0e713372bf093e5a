"""Split-point machinery (Ampere §3.2.1), static cut.

Splits a model at layer ``p`` into a *device block* (embedding + layers
[0, p)) and a *server block* (layers [p, L) + final norm + head), provides
the forward functions of each half, and re-merges the halves for
end-to-end evaluation — as ``repro.core.splitting``, with the same trees:
the device block carries its layers as a list of loose per-layer trees,
the server block keeps loose ``layers_head`` for the partial leading
period plus the stacked trailing repetitions, and a tied head is
materialized as an untied (D, V) head at split time.  A vision model's
halves are ``{"layers": [...]}`` and ``{"layers": [...], "head": ...}``,
and its server forward returns the logits.

Heterogeneous cuts (``loose_until``, ``entry``) are the fleet slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import model_api as M
from repro_torch.models import transformer as T
from repro_torch.models.cnn import apply_head


def loose_layer(blocks, layer_idx: int, period: int):
    r, j = divmod(layer_idx, period)
    return T.tree_index(blocks[f"pos{j}"], r)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def split_params(model, params, p: int):
    cfg = model.cfg
    if model.kind != "lm":
        return ({"layers": list(params["layers"][:p])},
                {"layers": list(params["layers"][p:]),
                 "head": params["head"]})
    P = cfg.pattern_period
    R = cfg.num_layers // P
    r0 = -(-p // P)  # first complete repetition owned by the server
    device = {"embed": params["embed"],
              "layers": [loose_layer(params["blocks"], i, P) for i in range(p)]}
    server = {
        "layers_head": [loose_layer(params["blocks"], i, P)
                        for i in range(p, min(r0 * P, cfg.num_layers))],
        "blocks": ({f"pos{j}": T.tree_index(params["blocks"][f"pos{j}"],
                                            slice(r0, R))
                    for j in range(P)} if r0 < R else None),
        "final_norm": params["final_norm"],
    }
    if cfg.tie_embeddings:
        server["head"] = {"w": params["embed"]["table"].t().contiguous()}
    else:
        server["head"] = params["head"]
    return device, server


def merged_config(model):
    """Config of the merged model: tied archs become untied because the
    server head was materialized at split time."""
    cfg = model.cfg
    if model.kind == "lm" and cfg.tie_embeddings:
        return dataclasses.replace(cfg, tie_embeddings=False)
    return cfg


def merge_params(model, device, server, p: int):
    """Re-assemble a full parameter tree from the two halves (the loose /
    stacked boundary comes from ``len(server["layers_head"])``)."""
    cfg = model.cfg
    if model.kind != "lm":
        return {"layers": list(device["layers"][:p]) + list(server["layers"]),
                "head": server["head"]}
    P = cfg.pattern_period
    R = cfg.num_layers // P
    lh_end = p + len(server["layers_head"])
    r0 = lh_end // P

    def layer_at(i):
        if i < p:
            return device["layers"][i]
        if i < lh_end:
            return server["layers_head"][i - p]
        r, j = divmod(i, P)
        return T.tree_index(server["blocks"][f"pos{j}"], r - r0)

    blocks = {f"pos{j}": _stack([layer_at(r * P + j) for r in range(R)])
              for j in range(P)}
    return {"embed": device["embed"], "blocks": blocks,
            "final_norm": server["final_norm"], "head": server["head"]}


def device_forward(model, device_params, inputs, p: int, *, positions=None,
                   impl="kernel", remat: str = "none"):
    """Embedding + layers [0, p) -> activations xi (the one-shot payload)."""
    cfg = model.cfg
    if model.kind != "lm":
        x = inputs
        for i in range(p):
            x = M.apply_vision_layer(cfg, device_params["layers"][i], x, i)
        return x
    B, S = inputs.shape
    x = L.embed(device_params["embed"], inputs, cfg.dtype,
                multiplier=cfg.embedding_multiplier)
    if positions is None:
        positions = T.default_positions(cfg, B, S, x.device)
    fn = T.checkpointed_block_apply if remat == "block" else T.block_apply
    for i in range(p):
        x = fn(cfg, device_params["layers"][i], x, positions, i, impl=impl)
    return x


def server_forward(model, server_params, activations, p: int, *,
                   positions=None, impl="kernel", remat="block"):
    """Layers [p, L) + final norm, the head weight exposed separately; a
    vision model's layers [p, L) and head, with its logits."""
    cfg = model.cfg
    x = activations.to(L.dt(cfg.dtype))
    if model.kind != "lm":
        for k, lp in enumerate(server_params["layers"]):
            x = M.apply_vision_layer(cfg, lp, x, p + k)
        return {"hidden": x,
                "logits": apply_head(cfg, server_params["head"], x)}
    B, S = activations.shape[:2]
    if positions is None:
        positions = T.default_positions(cfg, B, S, x.device)
    fn = T.checkpointed_block_apply if remat == "block" else T.block_apply
    lh_end = p + len(server_params["layers_head"])
    for k, lp in enumerate(server_params["layers_head"]):
        x = fn(cfg, lp, x, positions, p + k, impl=impl)
    if server_params["blocks"] is not None:
        x = T.run_blocks(cfg, server_params["blocks"], x, positions, lo=0,
                         hi=cfg.num_layers - lh_end, impl=impl, remat=remat)
    h = L.rmsnorm(server_params["final_norm"], x, cfg.norm_eps, cfg.dtype)
    return {"hidden": h, "logits": None}


def server_head_weight(server_params):
    return server_params["head"]["w"]
