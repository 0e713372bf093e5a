"""Evaluation of the merged model (validation metrics of the server
phase), as ``repro.core.evaluate``: for an LM full (B, S, V) logits,
next-token loss and accuracy, for a classifier the cross-entropy and
accuracy over the labels; and :class:`EarlyStopper`, the paper's patience
rule on those metrics."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import losses


@torch.no_grad()
def eval_step(model, params, batch):
    if model.kind != "lm":
        out = model.apply(params, batch["images"])
        loss, m = losses.classification_loss(out["logits"], batch["labels"])
        return loss, m["acc"]
    out = model.apply(params, batch["tokens"], remat="none")
    loss, _ = losses.lm_loss_from_logits(out["logits"], batch["tokens"])
    pred = torch.argmax(out["logits"][:, :-1], dim=-1)
    acc = torch.mean((pred == batch["tokens"][:, 1:].long()).float())
    return loss, acc


def evaluate(model, params, dataset, device, batch_size: int = 64,
             max_batches: int = 50) -> dict:
    n = len(dataset)
    batch_size = min(batch_size, n)
    ls, accs = [], []
    for s in range(0, n - batch_size + 1, batch_size):
        batch = {k: torch.as_tensor(v[s:s + batch_size], device=device)
                 for k, v in dataset.arrays.items()}
        loss, acc = eval_step(model, params, batch)
        ls.append(float(loss))
        accs.append(float(acc))
        if len(ls) >= max_batches:
            break
    return {"loss": float(np.mean(ls)) if ls else float("nan"),
            "acc": float(np.mean(accs)) if accs else float("nan")}


class EarlyStopper:
    """Paper §5.2.1: stop when no validation improvement for ``patience``
    consecutive epochs."""

    def __init__(self, patience: int = 15, mode: str = "max",
                 min_delta: float = 1e-4):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = -np.inf if mode == "max" else np.inf
        self.bad = 0
        self.best_round = 0
        self.round = 0

    def update(self, value: float) -> bool:
        """Returns True when training should STOP."""
        self.round += 1
        better = (value > self.best + self.min_delta if self.mode == "max"
                  else value < self.best - self.min_delta)
        if better:
            self.best = value
            self.bad = 0
            self.best_round = self.round
        else:
            self.bad += 1
        return self.bad >= self.patience

    # checkpointable state: a resumed run must stop at the same round an
    # uninterrupted one would have (the Runner keeps it in the checkpoint
    # metadata; json carries the +-inf sentinel)
    def state_dict(self) -> dict:
        return {"best": float(self.best), "bad": int(self.bad),
                "best_round": int(self.best_round), "round": int(self.round)}

    def load_state_dict(self, state: dict):
        self.best = float(state["best"])
        self.bad = int(state["bad"])
        self.best_round = int(state["best_round"])
        self.round = int(state["round"])
