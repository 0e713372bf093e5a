"""Unified model API over the LM families (dense, SSM, MoE and hybrid)
and the paper's vision classifiers, as ``repro.models.model_api``.

A :class:`Model` exposes ``init(gen, device)`` and
``apply(params, inputs, lo=, hi=)``, which runs layers [lo, hi) and
returns a dict with "hidden" (the activations Ampere ships at the split
point), "logits" when hi == num_layers, "aux" (the MoE load-balancing
loss summed over those layers; zero for a vision model) and "caches"
(an LM's serving caches, updated in place; None for a vision model);
``input_spec`` and ``activation_spec`` give shapes and dtypes as tensors
on the ``meta`` device (nothing allocated), and ``split_params`` cuts a
parameter tree at a split point: ``core.comm_model.split_sizes`` prices
a split through these three.  A vision model's tree is ``{"layers": [per-layer trees],
"head": ...}``, its inputs (B, s, s, C) fp32 images.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import LMConfig, VisionConfig
from repro_torch.models import cnn as CNN
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import vit as VIT


def is_vit(cfg) -> bool:
    return cfg.family in ("vit", "swin")


def apply_vision_layer(cfg, p, x, i: int, **kw):
    if is_vit(cfg):
        return VIT.apply_vit_layer(cfg, p, x, i, **kw)
    return CNN.apply_vision_layer(cfg, p, x, i)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    kind: str  # "lm" | "vision"

    @property
    def input_key(self) -> str:
        """The batch key of the model's input."""
        return "tokens" if self.kind == "lm" else "images"

    @property
    def label_key(self) -> str:
        """The batch key of its targets (an LM predicts its own tokens)."""
        return "tokens" if self.kind == "lm" else "labels"

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    def init(self, gen, device="cpu"):
        """Random params from ``gen`` (a ``torch.Generator`` on ``device``)."""
        if self.kind == "lm":
            return T.init_lm(self.cfg, gen, device)
        cfg = self.cfg
        init_layer = (VIT.init_vit_layer if is_vit(cfg)
                      else CNN.init_vision_layer)
        layers = [init_layer(gen, cfg, i, device=device)
                  for i in range(cfg.num_layers)]
        head_in = (cfg.d_model if is_vit(cfg)
                   else CNN.cnn_channels(cfg, cfg.num_layers - 1))
        return {"layers": layers,
                "head": CNN.init_head(gen, cfg, head_in, device)}

    def apply(self, params, inputs, *, lo: int = 0, hi: Optional[int] = None,
              positions=None, caches=None, cache_index=None, impl="kernel",
              remat: str = "block", return_logits=True):
        if self.kind == "lm":
            return T.forward(self.cfg, params, inputs, positions=positions,
                             lo=lo, hi=hi, caches=caches,
                             cache_index=cache_index, impl=impl, remat=remat,
                             return_logits=return_logits)
        cfg = self.cfg
        hi = self.num_layers if hi is None else hi
        x = inputs.to(L.dt(cfg.dtype)) if lo > 0 else inputs
        for i in range(lo, hi):
            x = apply_vision_layer(cfg, params["layers"][i], x, i)
        out = {"hidden": x, "logits": None, "caches": None,
               "aux": torch.zeros((), dtype=torch.float32, device=x.device)}
        if hi == self.num_layers and return_logits:
            out["logits"] = CNN.apply_head(cfg, params["head"], x)
        return out

    def input_spec(self, batch: int, seq_len: int = 0) -> torch.Tensor:
        """The input on ``meta``: (batch, seq_len) int32 tokens, or
        (batch, s, s, C) fp32 images."""
        if self.kind == "lm":
            return torch.empty((batch, seq_len), dtype=torch.int32,
                               device="meta")
        s = self.cfg.img_size
        return torch.empty((batch, s, s, self.cfg.in_channels),
                           dtype=torch.float32, device="meta")

    def activation_spec(self, batch: int, seq_len: int = 0,
                        split_point: int = 1,
                        dtype: str = "bfloat16") -> torch.Tensor:
        """The activations at the split point in ``dtype``, on ``meta``:
        (batch, seq_len, d_model) for an LM (its width does not depend on
        the split point); for a vision model whatever layers [0, p) make
        of the input, run on ``meta`` params (nothing allocated)."""
        if self.kind == "lm":
            return torch.empty((batch, seq_len, self.cfg.d_model),
                               dtype=L.dt(dtype), device="meta")
        # staticcheck: ok=unseeded-rng meta tensors: nothing is drawn
        params = self.init(torch.Generator(), "meta")
        out = self.apply(params, self.input_spec(batch), lo=0,
                         hi=split_point, return_logits=False)["hidden"]
        return torch.empty(out.shape, dtype=L.dt(dtype), device="meta")

    def split_params(self, params, p: int):
        """(device_params, server_params) at split point ``p``
        (:func:`repro_torch.core.splitting.split_params`)."""
        from repro_torch.core import splitting
        return splitting.split_params(self, params, p)


def build_model(cfg) -> Model:
    if isinstance(cfg, LMConfig):
        return Model(cfg=cfg, kind="lm")
    if isinstance(cfg, VisionConfig):
        return Model(cfg=cfg, kind="vision")
    raise TypeError(f"unsupported config type {type(cfg)}")
