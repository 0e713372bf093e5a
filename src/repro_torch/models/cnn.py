"""CNN classifiers of the paper's evaluation, as ``repro.models.cnn``:
a MobileNetV3-Large-style inverted-residual CNN and VGG-11.

Layer-indexed (layer 0 = stem, 1..n = blocks, the head applied at the end)
so Ampere's split point and auxiliary network work as on the LM path.
Normalization is GroupNorm (no cross-device batch statistics).

The layouts are the reference's, in the parameter tree and on the wire:
conv weights HWIO, activations NHWC, so the split activations (Ampere's
payload) are (B, H, W, C).  :func:`conv2d` hands ``F.conv2d`` permuted
views (an NHWC tensor seen as NCHW has ``channels_last`` strides, which
cuDNN runs without a copy; the weight is viewed as OIHW) and pads as
XLA's ``"SAME"`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def init_conv(gen, kh, kw, cin, cout, param_dtype="float32", device="cpu"):
    fan_in = kh * kw * cin
    return {"w": L.normal_init(gen, (kh, kw, cin, cout),
                               math.sqrt(2.0 / fan_in), param_dtype, device),
            "b": L.zeros_init((cout,), param_dtype, device)}


def same_padding(n: int, k: int, s: int):
    """XLA's ``"SAME"`` padding of one spatial axis: ``ceil(n / s)``
    outputs, the total split with the smaller half in front (so k 3, s 2
    on an even input pads (0, 1))."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p, x, stride=1, groups=1, compute_dtype="float32"):
    """NHWC ``x`` by an HWIO weight, ``"SAME"`` padding; NHWC out."""
    w = L.cast(p["w"], compute_dtype)
    xc = L.cast(x, compute_dtype).permute(0, 3, 1, 2)
    kh, kw = w.shape[:2]
    (ht, hb), (wl, wr) = (same_padding(xc.shape[2], kh, stride),
                          same_padding(xc.shape[3], kw, stride))
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        xc, pad = F.pad(xc, (wl, wr, ht, hb)), 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1) + L.cast(p["b"], compute_dtype)


def init_groupnorm(ch, param_dtype="float32", device="cpu"):
    return {"scale": L.ones_init((ch,), param_dtype, device),
            "bias": L.zeros_init((ch,), param_dtype, device)}


def groupnorm(p, x, groups=8, eps=1e-5):
    """GroupNorm over NHWC with ``gcd(groups, C)`` groups, statistics over
    (H, W, C/g) in fp32 with the population variance."""
    B, H, W, C = x.shape
    g = math.gcd(groups, C)
    xf = x.float().reshape(B, H, W, g, C // g)
    mu = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xf, dim=(1, 2, 4), keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def hardswish(x):
    return x * F.relu6(x + 3.0) / 6.0


# ---------------------------------------------------------------------------
# MobileNet-style inverted residual
# ---------------------------------------------------------------------------


def init_ir_block(gen, cin, cout, stride, expand_ratio, use_se,
                  param_dtype="float32", device="cpu"):
    mid = cin * expand_ratio
    p = {
        "expand": init_conv(gen, 1, 1, cin, mid, param_dtype, device),
        "expand_norm": init_groupnorm(mid, param_dtype, device),
        "dw": init_conv(gen, 3, 3, 1, mid, param_dtype, device),  # I=1
        "dw_norm": init_groupnorm(mid, param_dtype, device),
        "project": init_conv(gen, 1, 1, mid, cout, param_dtype, device),
        "project_norm": init_groupnorm(cout, param_dtype, device),
    }
    if use_se:
        se_mid = max(8, mid // 4)
        p["se_reduce"] = L.init_dense(gen, mid, se_mid, bias=True,
                                      param_dtype=param_dtype, device=device)
        p["se_expand"] = L.init_dense(gen, se_mid, mid, bias=True,
                                      param_dtype=param_dtype, device=device)
    return p


def ir_block(p, x, stride, compute_dtype="float32"):
    cin = x.shape[-1]
    h = conv2d(p["expand"], x, 1, compute_dtype=compute_dtype)
    h = hardswish(groupnorm(p["expand_norm"], h))
    mid = h.shape[-1]
    h = conv2d(p["dw"], h, stride, groups=mid, compute_dtype=compute_dtype)
    h = hardswish(groupnorm(p["dw_norm"], h))
    if "se_reduce" in p:
        s = torch.mean(h, dim=(1, 2))
        s = F.relu(L.dense(p["se_reduce"], s, compute_dtype))
        s = torch.sigmoid(L.dense(p["se_expand"], s, compute_dtype))
        h = h * s[:, None, None, :]
    h = groupnorm(p["project_norm"],
                  conv2d(p["project"], h, 1, compute_dtype=compute_dtype))
    if stride == 1 and h.shape[-1] == cin:
        h = h + x
    return h


# ---------------------------------------------------------------------------
# VGG block
# ---------------------------------------------------------------------------


def init_vgg_block(gen, cin, cout, param_dtype="float32", device="cpu"):
    return {"conv": init_conv(gen, 3, 3, cin, cout, param_dtype, device),
            "norm": init_groupnorm(cout, param_dtype, device)}


def vgg_block(p, x, stride, compute_dtype="float32"):
    h = conv2d(p["conv"], x, 1, compute_dtype=compute_dtype)
    h = F.relu(groupnorm(p["norm"], h))
    if stride == 2:   # 2x2 max pool, VALID (floor)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return h


# ---------------------------------------------------------------------------
# Layer-indexed model API
# ---------------------------------------------------------------------------


def cnn_channels(cfg, layer_idx: int, width_scale: float = 1.0):
    """Output channels of layer ``layer_idx`` (0 = stem)."""
    if layer_idx == 0:
        ch = cfg.stem_channels if cfg.family == "cnn" else cfg.block_channels[0]
    else:
        ch = cfg.block_channels[layer_idx - 1]
    return max(4, int(round(ch * width_scale)))


def init_vision_layer(gen, cfg, layer_idx: int, in_ch: Optional[int] = None,
                      width_scale: float = 1.0, device="cpu"):
    """Init CNN/VGG layer ``layer_idx``; ``width_scale`` scales its output
    width (Ampere's auxiliary clone)."""
    pd = cfg.param_dtype
    cout = cnn_channels(cfg, layer_idx, width_scale)
    if layer_idx == 0:
        cin = in_ch if in_ch is not None else cfg.in_channels
        if cfg.family == "cnn":
            return {"conv": init_conv(gen, 3, 3, cin, cout, pd, device),
                    "norm": init_groupnorm(cout, pd, device)}
        return init_vgg_block(gen, cin, cout, pd, device)
    cin = in_ch if in_ch is not None else cnn_channels(cfg, layer_idx - 1)
    if cfg.family == "cnn":
        return init_ir_block(gen, cin, cout,
                             cfg.block_strides[layer_idx - 1],
                             cfg.expand_ratio, cfg.use_se, pd, device)
    return init_vgg_block(gen, cin, cout, pd, device)


def apply_vision_layer(cfg, p, x, layer_idx: int):
    cd = cfg.dtype
    if layer_idx == 0:
        if cfg.family == "cnn":
            return hardswish(groupnorm(p["norm"],
                                       conv2d(p["conv"], x, cfg.stem_stride,
                                              compute_dtype=cd)))
        return vgg_block(p, x, cfg.block_strides[0] if cfg.block_strides else 1,
                         compute_dtype=cd)
    stride = cfg.block_strides[layer_idx - 1]
    if cfg.family == "cnn":
        return ir_block(p, x, stride, compute_dtype=cd)
    return vgg_block(p, x, stride, compute_dtype=cd)


def init_head(gen, cfg, in_ch: int, device="cpu"):
    return {"fc": L.init_dense(gen, in_ch, cfg.num_classes, bias=True,
                               param_dtype=cfg.param_dtype, device=device)}


def apply_head(cfg, p, x):
    """Global average pool (over H, W, or over the tokens) + FC."""
    feat = torch.mean(x, dim=(1, 2)) if x.dim() == 4 else torch.mean(x, dim=1)
    return L.dense(p["fc"], feat, cfg.dtype)
