"""Unified model API (every LM family but MoE and hybrid), as
``repro.models.model_api``.

A :class:`Model` exposes ``init(gen, device)`` and
``apply(params, inputs, lo=, hi=)``, which runs layers [lo, hi) and
returns a dict with "hidden" (the activations Ampere ships at the split
point) and "logits" when hi == num_layers; ``input_spec`` and
``activation_spec`` give shapes and dtypes as tensors on the ``meta``
device (nothing allocated), and ``split_params`` cuts a parameter tree at
a split point: ``core.comm_model.split_sizes`` prices a split through
these three.  The vision classifiers are a later slice (ROADMAP.md
queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import LMConfig, VisionConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    kind: str  # "lm"

    @property
    def num_layers(self) -> int:
        return self.cfg.num_layers

    def init(self, gen, device="cpu"):
        """Random params from ``gen`` (a ``torch.Generator`` on ``device``)."""
        return T.init_lm(self.cfg, gen, device)

    def apply(self, params, inputs, *, lo: int = 0, hi: Optional[int] = None,
              positions=None, impl="kernel", remat: str = "block",
              return_logits=True):
        return T.forward(self.cfg, params, inputs, positions=positions,
                         lo=lo, hi=hi, impl=impl, remat=remat,
                         return_logits=return_logits)

    def input_spec(self, batch: int, seq_len: int = 0) -> torch.Tensor:
        """The (batch, seq_len) int32 token input, on ``meta``."""
        return torch.empty((batch, seq_len), dtype=torch.int32,
                           device="meta")

    def activation_spec(self, batch: int, seq_len: int = 0,
                        split_point: int = 1,
                        dtype: str = "bfloat16") -> torch.Tensor:
        """The activations at the split point, (batch, seq_len, d_model)
        in ``dtype``, on ``meta`` (the LM width does not depend on the
        split point)."""
        return torch.empty((batch, seq_len, self.cfg.d_model),
                           dtype=L.dt(dtype), device="meta")

    def split_params(self, params, p: int):
        """(device_params, server_params) at split point ``p``
        (:func:`repro_torch.core.splitting.split_params`)."""
        from repro_torch.core import splitting
        return splitting.split_params(self, params, p)


def build_model(cfg) -> Model:
    if isinstance(cfg, LMConfig):
        if cfg.moe.enabled or cfg.attn_layer_period:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): the MoE and hybrid LM "
                "families are a later slice (ROADMAP.md queue A)")
        return Model(cfg=cfg, kind="lm")
    if isinstance(cfg, VisionConfig):
        raise NotImplementedError(
            f"{cfg.name}: the vision models are a later slice "
            "(ROADMAP.md queue A)")
    raise TypeError(f"unsupported config type {type(cfg)}")
