"""Classic FL (FedAvg [McMahan et al., AISTATS'17]), as
``repro.core.baselines.fedavg``: the whole model trains on every cohort
client, H local-SGD steps each (a Python loop over the clients where the
JAX package vmaps), then weighted FedAvg.  The LM loss is the reference's
from materialized logits (plain PyTorch, no cross-entropy kernel), so the
LM path launches only the attention kernels.  Each round moves the whole
model down and up for every cohort client.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, comm_model, evaluate, losses
from repro_torch.core.steps import sgd, value_and_grad
from repro_torch.data.pipeline import (ClientData, generators_state,
                                       load_generators_state, round_batches)
from repro_torch.device import resolve_device
from repro_torch.experiments.runner import Runner, StepOutcome
from repro_torch.interop import tree_map
from repro_torch.optim import make_schedule


def make_fedavg_round_step(model, run_cfg):
    """``round_step(params, batches, weights, lr)``: batch leaves
    (K, H, b, ...), weights (K,) (zero = padded client)."""
    H = run_cfg.fed.local_steps

    def loss_fn(params, batch):
        if model.kind == "lm":
            out = model.apply(params, batch["tokens"], remat="none")
            loss, _ = losses.lm_loss_from_logits(out["logits"],
                                                 batch["tokens"])
        else:
            out = model.apply(params, batch["images"])
            loss, _ = losses.classification_loss(out["logits"],
                                                 batch["labels"])
        return loss     # + the MoE balance loss: zero on every ported arch

    def client_round(params, client_batches, lr):
        losses_h = []
        for h in range(H):
            loss, grads = value_and_grad(
                loss_fn, params, {k: v[h] for k, v in client_batches.items()})
            params = sgd(params, grads, lr)
            del grads
            losses_h.append(loss)
        return params, torch.stack(losses_h).mean()

    def round_step(params, batches, weights, lr):
        par_k, loss_k = [], []
        for c in range(len(weights)):
            pk, lk = client_round(params, {k: v[c] for k, v in
                                           batches.items()}, lr)
            par_k.append(pk)
            loss_k.append(lk)
        new_params = aggregation.fedavg_stacked(par_k, weights)
        w = aggregation.normalize_weights(weights, loss_k[0].device)
        return new_params, {"loss": torch.sum(torch.stack(loss_k) * w)}

    return round_step


class FedAvgTrainer:
    """Host loop of classic FL, as ``repro.core.baselines.FedAvgTrainer``,
    through the shared :class:`~repro_torch.experiments.runner.Runner`."""

    def __init__(self, model, run_cfg, clients: List[ClientData], eval_data,
                 workdir: Optional[str] = None, patience: int = 15,
                 log_echo: bool = False, *, device=None):
        self.model = model
        self.run = run_cfg
        self.clients = clients
        self.eval_data = eval_data
        self.patience = patience
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(run_cfg.fed.seed)
        self._round = make_fedavg_round_step(model, run_cfg)
        self.runner = Runner(workdir, patience=patience, log_echo=log_echo,
                             log_name="fedavg.jsonl",
                             history={"rounds": [], "comm_bytes": 0,
                                      "sim_time": 0.0},
                             device=self.device,
                             host_state=(
                                 lambda: generators_state(self.rng, clients),
                                 lambda st: load_generators_state(
                                     self.rng, clients, st)))
        self.log = self.runner.log
        self.history = self.runner.history
        self._sched = make_schedule(run_cfg.optim)
        seq = (clients[0].dataset.arrays["tokens"].shape[1]
               if model.kind == "lm" else 0)
        self.seq_len = seq
        self.sizes = comm_model.split_sizes(model, run_cfg.split,
                                            seq_len=max(seq, 1))

    def _init_params(self, gen: torch.Generator):
        """Random init from ``gen`` on its own device, moved to the
        trainer's device."""
        return tree_map(lambda t: t.to(self.device),
                        self.model.init(gen, gen.device))

    def run_rounds(self, max_rounds: int, gen=None, cohort_plan=None, *,
                   init=None):
        """``max_rounds`` rounds from ``gen``'s init (``None``: a CPU
        generator seeded from ``run.seed``), or from ``init``, an
        ``_init_params`` result handed over in a one-element list (emptied
        here), or from the newest checkpoint.  A ``cohort_plan``
        (fleet-trace replay) is ROADMAP.md queue A5."""
        if cohort_plan is not None:
            raise ValueError("cohort_plan (fleet-trace replay) is not "
                             "ported yet (ROADMAP.md queue A5)")
        fed = self.run.fed
        gen = gen if gen is not None else \
            torch.Generator().manual_seed(self.run.seed)
        params, start_round = self.runner.restore(
            "fedavg",
            init.pop() if init is not None else self._init_params(gen))
        full_bytes = comm_model.tree_bytes(params)
        K = fed.clients_per_round
        round_time = comm_model.epoch_time(
            "fedavg", self.model, self.run.split, comm_model.TimeModel(),
            n_samples=fed.local_steps * fed.device_batch_size,
            batch_size=fed.device_batch_size, seq_len=self.seq_len,
            sizes=self.sizes)

        def body(params, rnd, _plan):
            cohort = aggregation.sample_cohort(self.rng, fed, rnd)
            ids, w = aggregation.pad_cohort(cohort["clients"],
                                            cohort["weights"], K)
            batches = {k: torch.as_tensor(v, device=self.device)
                       for k, v in round_batches(
                           self.clients, ids, fed.local_steps,
                           fed.device_batch_size).items()}
            params, metrics = self._round(params, batches, w,
                                          self._sched(rnd))
            del batches
            val = evaluate.evaluate(self.model, params, self.eval_data,
                                    self.device)
            return StepOutcome(
                state=params,
                record={"round": rnd, "loss": float(metrics["loss"]),
                        "val_loss": val["loss"], "val_acc": val["acc"]},
                comm_bytes=2 * len(cohort["clients"]) * full_bytes,
                sim_time=round_time,
                log={"variant": "fedavg"})

        held = [params]   # handed over: the Runner empties it
        del params
        params = self.runner.run_phase(
            "fedavg", held,
            ((r, None) for r in range(start_round, max_rounds)),
            body, history_key="rounds", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)
        return {"params": params, "history": self.history}
