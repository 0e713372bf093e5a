"""Lightweight auxiliary network (Ampere §3.2.2), as
``repro.core.auxiliary``.

theta~(d) connects the device block's output to a local loss so the device
trains with no server gradients.  Layer 1 is a clone of the first
server-block layer (layer p) with its internal widths scaled by
``aux_ratio``.  LM: the residual width is kept, and layer 2 is the LM
head — tied to the device-side embedding table by default, or a dense
(D, V) head with ``aux_head="dense"``.  Vision: ViT and Swin keep
``d_model`` and scale the heads and MLP; a CNN clone scales its output
channels and exists only while ``p < num_layers``; layer 2 is GAP + FC
to the classes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import losses
from repro_torch.models import cnn as CNN
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vit as VIT
from repro_torch.models.model_api import apply_vision_layer, is_vit


def scaled_lm_cfg(cfg, ratio: float):
    """An LMConfig whose internal widths are scaled by ``ratio`` while the
    residual width d_model stays fixed (dense and SSM families)."""
    def s(x, lo=1):
        return max(lo, int(round(x * ratio)))

    mamba = cfg.mamba
    if cfg.family in ("ssm", "hybrid"):
        mamba = dataclasses.replace(
            mamba, expand=max(1, int(round(mamba.expand * ratio))),
            d_state=s(mamba.d_state, 8))
    n_kv = s(cfg.num_kv_heads) if cfg.num_kv_heads else 0
    n_q = s(cfg.num_heads) if cfg.num_heads else 0
    if n_kv and n_q % n_kv:
        n_q = max(n_kv, (n_q // n_kv) * n_kv)  # keep GQA divisibility
    return dataclasses.replace(cfg, num_heads=n_q, num_kv_heads=n_kv,
                               d_ff=s(cfg.d_ff, 8) if cfg.d_ff else 0,
                               mamba=mamba)


def resolve_aux_head(split_cfg) -> str:
    mode = getattr(split_cfg, "aux_head", "auto")
    return "tied" if mode == "auto" else mode


def init_aux(model, gen, split_cfg, device="cpu"):
    """Build theta~(d) for splitting ``model`` at split_cfg.split_point."""
    if model.kind != "lm":
        return _init_vision_aux(model.cfg, gen, split_cfg, device)
    cfg = model.cfg
    aux = {}
    if split_cfg.aux_clone_first_server_layer:
        acfg = scaled_lm_cfg(cfg, split_cfg.aux_ratio)
        aux["block"] = T.init_block(gen, acfg, split_cfg.split_point, device)
    aux["norm"] = L.init_rmsnorm(cfg.d_model, cfg.param_dtype, device)
    if resolve_aux_head(split_cfg) == "dense":
        aux["head"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size,
                                   param_dtype=cfg.param_dtype, device=device)
    return aux


def _init_vision_aux(cfg, gen, split_cfg, device):
    p, ratio = split_cfg.split_point, split_cfg.aux_ratio
    clone = split_cfg.aux_clone_first_server_layer
    aux = {}
    if is_vit(cfg):
        if clone:
            aux["block"] = VIT.init_vit_layer(gen, cfg, max(1, p),
                                              in_dim=cfg.d_model,
                                              width_scale=ratio,
                                              device=device)
        aux["head"] = CNN.init_head(gen, cfg, cfg.d_model, device)
        return aux
    in_ch = CNN.cnn_channels(cfg, p - 1) if p > 0 else cfg.in_channels
    out_ch = in_ch
    if clone and p < cfg.num_layers:
        aux["block"] = CNN.init_vision_layer(gen, cfg, p, in_ch=in_ch,
                                             width_scale=ratio, device=device)
        out_ch = CNN.cnn_channels(cfg, p, ratio)
    aux["head"] = CNN.init_head(gen, cfg, out_ch, device)
    return aux


def aux_hidden(model, aux_params, activations, split_cfg, *, positions=None,
               impl="kernel"):
    """Run the aux layer-1 clone (if present) over split activations."""
    cfg = model.cfg
    x = activations.to(L.dt(cfg.dtype))
    if model.kind != "lm":
        if "block" not in aux_params:
            return x
        p = split_cfg.split_point
        if is_vit(cfg):
            _, heads, _ = VIT.vit_scaled_dims(cfg, split_cfg.aux_ratio)
            return apply_vision_layer(cfg, aux_params["block"], x, max(1, p),
                                      heads=heads)
        return apply_vision_layer(cfg, aux_params["block"], x, p)
    if "block" in aux_params:
        acfg = scaled_lm_cfg(cfg, split_cfg.aux_ratio)
        B, S = x.shape[:2]
        if positions is None:
            positions = T.default_positions(cfg, B, S, x.device)
        x = T.block_apply(acfg, aux_params["block"], x, positions,
                          split_cfg.split_point, impl=impl)
    return L.rmsnorm(aux_params["norm"], x, cfg.norm_eps, cfg.dtype)


def aux_loss(model, aux_params, device_params, activations, batch, split_cfg,
             *, positions=None, impl="kernel"):
    """Local loss F_k^(d) (Eq. 8): aux network over the device-block
    activations against the next tokens or the labels.  Returns (loss,
    metrics)."""
    h = aux_hidden(model, aux_params, activations, split_cfg,
                   positions=positions, impl=impl)
    if model.kind != "lm":
        logits = CNN.apply_head(model.cfg, aux_params["head"], h)
        return losses.classification_loss(logits, batch["labels"])
    if resolve_aux_head(split_cfg) == "dense":
        head_w = aux_params["head"]["w"]
    else:
        # a transposed view: the xent kernels read the (V, D) table in place
        head_w = device_params["embed"]["table"].t()
    return losses.lm_loss_from_hidden(h, head_w, batch["tokens"],
                                      softcap=model.cfg.final_softcap,
                                      loss_mask=batch.get("loss_mask"))
