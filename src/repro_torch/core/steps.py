"""Training steps of Ampere's two phases, as ``repro.core.steps``.

* :func:`make_client_round_fn` — H local-SGD iterations of one client on
  (device block + auxiliary network), the update done in fp32 and cast
  back (Eq. 9).
* :func:`make_device_round_step` — one federated round: every cohort
  client runs its round from the same global state (a loop over the K
  clients where the JAX package vmaps), then weighted FedAvg (Eq. 10).
* :func:`make_server_train_step` / :func:`make_server_epoch_fn` — the
  centralized server phase over consolidated activations (Eq. 11+12).

Gradients come from ``torch.autograd.grad`` over detached leaf copies of
the parameter trees; every update returns new tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import aggregation, auxiliary, losses, splitting
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.layers import dt
from repro_torch.optim import clip_by_global_norm, make_optimizer, make_schedule
from repro_torch.runtime import compression


def _leaves_requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss, tree):
    """d loss / d leaf for every leaf of ``tree`` (zeros where unused, as
    JAX returns)."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(l) if g is None else g
               for l, g in zip(leaves, gs)])
    return tree_map(lambda _: next(it), tree)


def value_and_grad(loss_fn, tree, *args):
    """``(loss, d loss / d tree)`` of ``loss_fn(tree, *args)``, as
    ``jax.value_and_grad``: the loss detached, one gradient a leaf."""
    tree = _leaves_requiring_grad(tree)
    loss = loss_fn(tree, *args)
    return loss.detach(), _grads(loss, tree)


@torch.no_grad()
def sgd(par, grads, lr):
    """One plain SGD step, done in fp32 and cast back to each leaf's dtype
    (Eq. 9)."""
    return tree_map(lambda q, g: (q.float() - lr * g.float()).to(q.dtype),
                    par, grads)


# ---------------------------------------------------------------------------
# Ampere device phase
# ---------------------------------------------------------------------------


def make_client_round_fn(model, run_cfg, *, impl="kernel"):
    """``client_round(device_params, aux_params, client_batches, lr)`` with
    batch leaves shaped (H, b, ...); returns the trained trees and the mean
    loss over the H steps."""
    split_cfg = run_cfg.split
    p = split_cfg.split_point
    H = run_cfg.fed.local_steps

    def local_loss(device_params, aux_params, batch):
        acts = splitting.device_forward(model, device_params,
                                        batch[model.input_key], p, impl=impl)
        loss, _ = auxiliary.aux_loss(model, aux_params, device_params, acts,
                                     batch, split_cfg, impl=impl)
        return loss

    def client_round(device_params, aux_params, client_batches, lr):
        par = (device_params, aux_params)
        losses_h = []
        for h in range(H):
            batch = {k: v[h] for k, v in client_batches.items()}
            loss, grads = value_and_grad(
                lambda par, batch: local_loss(*par, batch), par, batch)
            par = sgd(par, grads, lr)
            losses_h.append(loss)
        return par[0], par[1], torch.stack(losses_h).mean()

    return client_round


def make_device_round_step(model, run_cfg, *, impl="kernel"):
    client_round = make_client_round_fn(model, run_cfg, impl=impl)

    def device_round_step(state, batches, weights, lr):
        """state: {"device", "aux"}; batch leaves (K, H, b, ...);
        weights: (K,) aggregation weights (zero = padded client)."""
        dev_k, aux_k, loss_k = [], [], []
        for c in range(len(weights)):
            d, a, l = client_round(state["device"], state["aux"],
                                   {k: v[c] for k, v in batches.items()}, lr)
            dev_k.append(d)
            aux_k.append(a)
            loss_k.append(l)
        with torch.no_grad():
            new_state = {"device": aggregation.fedavg_stacked(dev_k, weights),
                         "aux": aggregation.fedavg_stacked(aux_k, weights)}
            w = aggregation.normalize_weights(weights, loss_k[0].device)
            loss = torch.sum(torch.stack(loss_k) * w)
        return new_state, {"loss": loss}

    return device_round_step


# ---------------------------------------------------------------------------
# Ampere server phase
# ---------------------------------------------------------------------------


def make_server_train_step(model, run_cfg, *, impl="kernel"):
    cfg = model.cfg
    p = run_cfg.split.split_point
    opt = make_optimizer(run_cfg.optim)
    sched = make_schedule(run_cfg.optim)
    remat = run_cfg.sharding.remat

    def loss_fn(server_params, batch):
        acts = batch["acts"]
        if "acts_scale" in batch:   # an int8 payload, quantized until here
            acts = compression.dequantize_int8(acts, batch["acts_scale"])
        out = splitting.server_forward(model, server_params, acts, p,
                                       impl=impl, remat=remat)
        if model.kind != "lm":
            return losses.classification_loss(out["logits"], batch["labels"])
        return losses.lm_loss_from_hidden(
            out["hidden"], splitting.server_head_weight(server_params),
            batch["tokens"], softcap=cfg.final_softcap,
            loss_mask=batch.get("loss_mask"))

    def server_train_step(state, batch):
        params = _leaves_requiring_grad(state["server"])
        loss, m = loss_fn(params, batch)
        grads = _grads(loss, params)
        with torch.no_grad():
            if run_cfg.optim.grad_dtype:
                gd = dt(run_cfg.optim.grad_dtype)
                grads = tree_map(lambda g: g.to(gd), grads)
            if run_cfg.optim.grad_clip:
                grads, _ = clip_by_global_norm(grads, run_cfg.optim.grad_clip)
            lr = sched(state["step"])
            new_params, new_opt = opt.update(
                grads, state["opt"], tree_map(lambda t: t.detach(), params),
                lr)
        new_state = {"server": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "lr": lr}

    return server_train_step


def init_server_state(model, run_cfg, server_params):
    opt = make_optimizer(run_cfg.optim)
    return {"server": server_params, "opt": opt.init(server_params),
            "step": 0}


def make_server_epoch_fn(model, run_cfg, *, impl="kernel"):
    """``epoch_fn(state, pool, idx)``: one server epoch over ``idx``, an
    (nb, batch) index matrix into the device-resident consolidated
    ``pool`` (an int8 payload stays quantized there; the step dequantizes
    each batch); returns the new state and the (nb,) per-batch losses."""
    step = make_server_train_step(model, run_cfg, impl=impl)

    def epoch_fn(state, pool, idx):
        out = []
        for idx_b in idx:
            state, m = step(state, {k: v[idx_b] for k, v in pool.items()})
            out.append(m["loss"])
        losses_nb = (torch.stack(out) if out else
                     torch.zeros((0,), device=idx.device))
        return state, losses_nb

    return epoch_fn
