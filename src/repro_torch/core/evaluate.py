"""Evaluation of the merged model (validation metrics of the server
phase), as ``repro.core.evaluate`` for the LM path: full (B, S, V) logits,
next-token loss and accuracy."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import losses


@torch.no_grad()
def eval_step(model, params, batch):
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
