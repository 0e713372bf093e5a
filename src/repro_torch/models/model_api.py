"""Unified model API (LM dense family), as ``repro.models.model_api``.

A :class:`Model` exposes ``init(gen, device)`` and
``apply(params, inputs, lo=, hi=)``, which runs layers [lo, hi) and
returns a dict with "hidden" (the activations Ampere ships at the split
point) and "logits" when hi == num_layers.  The vision classifiers are a
later slice (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import LMConfig, VisionConfig
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


def build_model(cfg) -> Model:
    if isinstance(cfg, LMConfig):
        if cfg.family not in ("dense",) or cfg.moe.enabled or \
                cfg.attn_layer_period:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): only the dense LM family is "
                "ported (ROADMAP.md queue A)")
        return Model(cfg=cfg, kind="lm")
    if isinstance(cfg, VisionConfig):
        raise NotImplementedError(
            f"{cfg.name}: the vision models are a later slice "
            "(ROADMAP.md queue A)")
    raise TypeError(f"unsupported config type {type(cfg)}")
