"""Optimizers written out as ``repro.optim.optimizers`` writes them (not
``torch.optim``, whose momentum and weight decay differ): SGD,
SGD+momentum, Adam, AdamW and fp32 master weights, as functional
(init, update) pairs over nested dicts of tensors.  ``update`` returns new
tensors and leaves its inputs untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.layers import dt


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params, lr) -> (new_params, new_state)
    name: str = ""


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads), g


def sgd(weight_decay: float = 0.0):
    def init(params):
        return {"count": 0}

    def update(grads, state, params, lr):
        def upd(p, g):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            return (p.float() - lr * g).to(p.dtype)
        return tree_map(upd, params, grads), {"count": state["count"] + 1}
    return Optimizer(init, update, "sgd")


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             state_dtype: str = "float32"):
    sd = dt(state_dtype)

    def init(params):
        return {"count": 0,
                "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=sd,
                                                     device=p.device), params)}

    def update(grads, state, params, lr):
        def upd_mu(m, g, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            return (beta * m.float() + g).to(sd)
        mu = tree_map(upd_mu, state["mu"], grads, params)
        new_params = tree_map(
            lambda p, m: (p.float() - lr * m.float()).to(p.dtype), params, mu)
        return new_params, {"count": state["count"] + 1, "mu": mu}
    return Optimizer(init, update, "momentum")


def _adam_core(beta1, beta2, eps, weight_decay, decoupled, state_dtype):
    sd = dt(state_dtype)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=sd, device=p.device)
        return {"count": 0, "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        b1c = float(1.0 - torch.tensor(beta1, dtype=torch.float32) ** c)
        b2c = float(1.0 - torch.tensor(beta2, dtype=torch.float32) ** c)

        def upd(p, g, m, v):
            gf = g.float()
            pf = p.float()
            if weight_decay and not decoupled:
                gf = gf + weight_decay * pf
            mf = beta1 * m.float() + (1 - beta1) * gf
            vf = beta2 * v.float() + (1 - beta2) * torch.square(gf)
            step = lr * (mf / b1c) / (torch.sqrt(vf / b2c) + eps)
            if weight_decay and decoupled:
                step = step + lr * weight_decay * pf
            return (pf - step).to(p.dtype), mf.to(sd), vf.to(sd)

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_p, m, v = (tree_map(lambda _, t, i=i: t[i], params, out)
                       for i in range(3))
        return new_p, {"count": c, "m": m, "v": v}
    return init, update


def adam(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
         state_dtype="float32"):
    i, u = _adam_core(beta1, beta2, eps, weight_decay, False, state_dtype)
    return Optimizer(i, u, "adam")


def adamw(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
          state_dtype="float32"):
    i, u = _adam_core(beta1, beta2, eps, weight_decay, True, state_dtype)
    return Optimizer(i, u, "adamw")


def with_master_weights(inner: Optimizer) -> Optimizer:
    """Mixed-precision training with fp32 master weights: the optimizer
    folds fp32 masters into its state and emits the low-precision copy."""
    def init(params):
        master = tree_map(lambda p: p.float(), params)
        return {"inner": inner.init(master), "master": master}

    def update(grads, state, params, lr):
        new_master, new_inner = inner.update(grads, state["inner"],
                                             state["master"], lr)
        new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, {"inner": new_inner, "master": new_master}

    return Optimizer(init, update, inner.name + "+master")


def make_optimizer(cfg) -> Optimizer:
    """cfg: OptimConfig."""
    sd = cfg.optimizer_state_dtype
    if cfg.name == "sgd":
        opt = sgd(cfg.weight_decay)
    elif cfg.name == "momentum":
        opt = momentum(cfg.momentum, cfg.weight_decay, sd)
    elif cfg.name == "adam":
        opt = adam(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, sd)
    elif cfg.name == "adamw":
        opt = adamw(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, sd)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    if getattr(cfg, "master_weights", False):
        opt = with_master_weights(opt)
    return opt
