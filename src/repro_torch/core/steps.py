"""Training steps of Ampere's two phases, as ``repro.core.steps``.

* :func:`make_client_round_fn` — H local-SGD iterations of one client on
  (device block + auxiliary network), the update done in fp32 and cast
  back (Eq. 9).
* :func:`make_device_round_step` — one federated round: every cohort
  client runs its round from the same global state (a loop over the K
  clients where the JAX package vmaps), then weighted FedAvg (Eq. 10).
* :func:`make_buffered_round_step` — one buffered (FedBuff) aggregation:
  each client trains from its own, possibly stale, snapshot, and the
  staleness-weighted deltas fold into the current global state.
* :func:`make_server_train_step` / :func:`make_server_epoch_fn` — the
  centralized server phase over consolidated activations (Eq. 11+12).
* :func:`make_e2e_train_step` — end-to-end, unsplit training (the
  non-split reference; the dry-run's e2e cell).
* :func:`make_prefill_step` / :func:`make_decode_step` — serving the
  merged model: fill the caches for a prompt, then one greedy token a
  call.

Gradients come from ``torch.autograd.grad`` over detached leaf copies of
the parameter trees; every update returns new tensors.  ``xent_impl``
picks the LM loss's cross-entropy route
(``repro_torch.kernels.xent.ops.cross_entropy``): the fused kernels by
default, ``"sharded"`` for the dry-run's vocab-sharded logits.
"""

from __future__ import annotations

import torch

from repro_torch.core import aggregation, auxiliary, losses, splitting
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.models.layers import dt, rmsnorm
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


def make_client_round_fn(model, run_cfg, *, impl="kernel",
                         xent_impl="kernel"):
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
                                     batch, split_cfg, impl=impl,
                                     xent_impl=xent_impl)
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


def make_device_round_step(model, run_cfg, *, impl="kernel",
                           xent_impl="kernel"):
    client_round = make_client_round_fn(model, run_cfg, impl=impl,
                                        xent_impl=xent_impl)

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


def make_buffered_round_step(model, run_cfg, *, impl="kernel",
                             xent_impl="kernel"):
    """``buffered_round_step(state, snapshots, batches, weights, lr)``:
    ``state`` the current global {"device", "aux"} (left intact: past
    versions stay live for still-in-flight clients), ``snapshots`` each
    buffered client's init state (a list of {"device", "aux"} trees, the
    JAX package's leading client axis), batch leaves (K, H, b, ...).  Each
    client's round runs from its own snapshot, then the FedBuff delta fold
    into ``state``."""
    client_round = make_client_round_fn(model, run_cfg, impl=impl,
                                        xent_impl=xent_impl)

    def buffered_round_step(state, snapshots, batches, weights, lr):
        dev_k, aux_k, loss_k = [], [], []
        for c, snap in enumerate(snapshots):
            d, a, l = client_round(snap["device"], snap["aux"],
                                   {k: v[c] for k, v in batches.items()}, lr)
            dev_k.append(d)
            aux_k.append(a)
            loss_k.append(l)
        with torch.no_grad():
            new_state = {
                "device": aggregation.fedbuff_stacked(
                    state["device"], dev_k, [s["device"] for s in snapshots],
                    weights),
                "aux": aggregation.fedbuff_stacked(
                    state["aux"], aux_k, [s["aux"] for s in snapshots],
                    weights)}
            w = aggregation.normalize_weights(weights, loss_k[0].device)
            loss = torch.sum(torch.stack(loss_k) * w)
        return new_state, {"loss": loss}

    return buffered_round_step


# ---------------------------------------------------------------------------
# Ampere server phase
# ---------------------------------------------------------------------------


def _redistribute_like(grads, placements):
    """Each ``DTensor`` gradient moved to its placements (a list a leaf
    of ``placements``, a tree over the same dict keys)."""
    if isinstance(grads, dict):
        return {k: _redistribute_like(v, placements[k])
                for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(_redistribute_like(g, p)
                           for g, p in zip(grads, placements))
    if hasattr(grads, "redistribute"):
        return grads.redistribute(grads.device_mesh, placements)
    return grads


def make_server_train_step(model, run_cfg, *, impl="kernel",
                           xent_impl="kernel", grad_placements=None,
                           entry=None):
    """``grad_placements``: optional placements tree of the server params
    (``repro_torch.sharding.rules.to_placements``); each ``DTensor``
    gradient is redistributed to its param's placements right at the grad
    boundary, before clipping and the optimizer (the JAX package's
    ``grad_shardings``: a reduce-scatter in place of an all-reduce).

    ``entry``: the cut depth this step's activations were made at (a
    heterogeneous-cut server phase trains one server block from several
    entry points; the layers below ``entry`` get zero gradients, as in
    JAX, and the optimizer still moves them); ``None`` = the split
    point."""
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
                                       impl=impl, remat=remat, entry=entry)
        if model.kind != "lm":
            loss, _ = losses.classification_loss(out["logits"],
                                                 batch["labels"])
        else:
            loss, _ = losses.lm_loss_from_hidden(
                out["hidden"], splitting.server_head_weight(server_params),
                batch["tokens"], softcap=cfg.final_softcap, impl=xent_impl,
                loss_mask=batch.get("loss_mask"))
        # the task loss is what the step records; the MoE balance loss
        # only enters the gradient
        return loss, out["aux"]

    def server_train_step(state, batch):
        params = _leaves_requiring_grad(state["server"])
        loss, aux = loss_fn(params, batch)
        grads = _grads(loss + aux, params)
        with torch.no_grad():
            if run_cfg.optim.grad_dtype:
                gd = dt(run_cfg.optim.grad_dtype)
                grads = tree_map(lambda g: g.to(gd), grads)
            if grad_placements is not None:
                grads = _redistribute_like(grads, grad_placements)
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


def make_server_epoch_fn(model, run_cfg, *, impl="kernel",
                         xent_impl="kernel", grad_placements=None,
                         entry=None):
    """``epoch_fn(state, pool, idx)``: one server epoch over ``idx``, an
    (nb, batch) index matrix into the device-resident consolidated
    ``pool`` (an int8 payload stays quantized there; the step dequantizes
    each batch); returns the new state and the (nb,) per-batch losses.
    The keywords are :func:`make_server_train_step`'s."""
    step = make_server_train_step(model, run_cfg, impl=impl,
                                  xent_impl=xent_impl,
                                  grad_placements=grad_placements,
                                  entry=entry)

    def epoch_fn(state, pool, idx):
        out = []
        for idx_b in idx:
            state, m = step(state, {k: v[idx_b] for k, v in pool.items()})
            out.append(m["loss"])
        losses_nb = (torch.stack(out) if out else
                     torch.zeros((0,), device=idx.device))
        return state, losses_nb

    return epoch_fn


# ---------------------------------------------------------------------------
# End-to-end baseline step (FL / SplitFed-V2-like)
# ---------------------------------------------------------------------------


def _lm_hidden_and_loss(cfg, params, tokens, *, impl, xent_impl, remat,
                        loss_mask=None):
    """(task loss, MoE balance loss) of the whole LM."""
    out = T.forward(cfg, params, tokens, impl=impl, remat=remat,
                    return_logits=False)
    h = rmsnorm(params["final_norm"], out["hidden"], cfg.norm_eps, cfg.dtype)
    loss, _ = losses.lm_loss_from_hidden(
        h, T.head_weight(cfg, params), tokens, softcap=cfg.final_softcap,
        impl=xent_impl, loss_mask=loss_mask)
    return loss, out["aux"]


def make_e2e_train_step(model, run_cfg, *, impl="kernel", xent_impl="kernel"):
    """``e2e_train_step(state, batch)``: one step of the whole model (no
    split): the LM or classifier loss, its gradient, optional global-norm
    clipping and the scheduled optimizer update.  The recorded loss is the
    task loss; the MoE balance loss only enters the gradient."""
    cfg = model.cfg
    opt = make_optimizer(run_cfg.optim)
    sched = make_schedule(run_cfg.optim)
    remat = run_cfg.sharding.remat

    def loss_fn(params, batch):
        if model.kind == "lm":
            loss, aux = _lm_hidden_and_loss(
                cfg, params, batch["tokens"], impl=impl, xent_impl=xent_impl,
                remat=remat, loss_mask=batch.get("loss_mask"))
            return loss, aux, {}
        out = model.apply(params, batch["images"], remat=remat)
        loss, m = losses.classification_loss(out["logits"], batch["labels"])
        return loss, out["aux"], {"acc": m["acc"].detach()}

    def e2e_train_step(state, batch):
        params = _leaves_requiring_grad(state["params"])
        loss, aux, m = loss_fn(params, batch)
        grads = _grads(loss + aux, params)
        with torch.no_grad():
            if run_cfg.optim.grad_clip:
                grads, _ = clip_by_global_norm(grads, run_cfg.optim.grad_clip)
            lr = sched(state["step"])
            new_params, new_opt = opt.update(
                grads, state["opt"], tree_map(lambda t: t.detach(), params),
                lr)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1},
                dict(m, loss=loss.detach(), lr=lr))

    return e2e_train_step


def init_e2e_state(model, run_cfg, params):
    opt = make_optimizer(run_cfg.optim)
    return {"params": params, "opt": opt.init(params), "step": 0}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def make_prefill_step(model, run_cfg, *, impl="kernel"):
    """``prefill_step(params, tokens, caches)`` -> (last-position logits
    (B, V), caches): the prompt fills the caches from position 0.  Only
    the last position goes through the head; (B, S, V) is never made."""
    cfg = model.cfg

    def prefill_step(params, tokens, caches):
        out = T.forward(cfg, params, tokens, caches=caches, cache_index=0,
                        impl=impl, remat="none", return_logits=False)
        _, logits = T.head(cfg, params, out["hidden"][:, -1:])
        return logits[:, 0], out["caches"]

    return prefill_step


def make_decode_step(model, run_cfg, *, impl="kernel"):
    """``decode_step(params, caches, token (B, 1), index)`` -> (greedy next
    token (B,), its logits (B, V), caches): one token at position
    ``index``."""
    cfg = model.cfg

    def decode_step(params, caches, token, index):
        out = T.forward(cfg, params, token, caches=caches, cache_index=index,
                        impl=impl, remat="none")
        logits = out["logits"][:, -1]
        return torch.argmax(logits, dim=-1), logits, out["caches"]

    return decode_step
