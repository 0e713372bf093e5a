"""Evaluation of the merged model (validation metrics of the server
phase), as ``repro.core.evaluate``: for an LM the next-token loss and
accuracy of its (B, S, V) logits (made a chunk of positions at a time),
for a classifier the cross-entropy and accuracy over the labels; and
:class:`EarlyStopper`, the paper's patience rule on those metrics."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import losses
from repro_torch.models import transformer as T

# the most logits the head makes at once: past it the loss runs over
# chunks of positions (gemma2-2b's 4 x 8192 x 256000 would be 16.8 GB in
# bf16, and the loss's fp32 copies twice that each)
MAX_EVAL_LOGITS = 2 ** 30


@torch.no_grad()
def token_losses(model, params, tokens):
    """An LM's next-token loss and hit (argmax == label) at every position
    but the last, (B, S - 1) each, as the reference's full (B, S, V)
    logits give them, the head run over at most MAX_EVAL_LOGITS logits at
    a time."""
    cfg = model.cfg
    x = model.apply(params, tokens, remat="none",
                    return_logits=False)["hidden"]
    h = x[:, :-1].reshape(-1, x.shape[-1])
    labels = tokens[:, 1:].reshape(-1).long()
    n = max(1, MAX_EVAL_LOGITS // cfg.vocab_size)
    per, hit = [], []
    for i in range(0, h.shape[0], n):
        logf = T.head(cfg, params, h[i:i + n])[1].float()
        lab = labels[i:i + n]
        per.append(torch.logsumexp(logf, dim=-1)
                   - torch.gather(logf, -1, lab[:, None])[:, 0])
        hit.append(torch.argmax(logf, dim=-1) == lab)
        del logf
    shape = (tokens.shape[0], tokens.shape[1] - 1)
    return torch.cat(per).reshape(shape), torch.cat(hit).reshape(shape)


@torch.no_grad()
def eval_step(model, params, batch):
    """Loss and accuracy of one batch.  For an LM: the mean of
    :func:`token_losses`."""
    if model.kind != "lm":
        out = model.apply(params, batch["images"])
        loss, m = losses.classification_loss(out["logits"], batch["labels"])
        return loss, m["acc"]
    per, hit = token_losses(model, params, batch["tokens"])
    return per.mean(), hit.float().mean()


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
