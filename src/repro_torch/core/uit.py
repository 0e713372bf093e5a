"""Unidirectional Inter-Block Training — the Ampere orchestrator (paper
§3.3, Algorithm 1), static cut, as ``repro.core.uit.AmpereTrainer``.

The phases run in the order ``AmpereSystem.run`` drives them:

1. :meth:`AmpereTrainer._init_states` — init, split, auxiliary network;
2. :meth:`run_device_phase` — federated rounds: cohort sampling, H
   local-SGD steps per client on the auxiliary local loss, weighted
   FedAvg, auxiliary validation;
3. :meth:`generate_activations` — one-shot activations of the converged
   device block into the consolidated :class:`ActivationStore`;
4. :meth:`run_server_phase` — server epochs over the device-resident pool,
   merged-model validation after each;
5. :meth:`merged_params`.

History records match the JAX trainer's: ``device`` rows (round, loss,
val_loss, val_acc) and ``server`` rows (epoch, loss, val_loss, val_acc).
The Runner (checkpoint, journal, early stop), transport, observability,
streaming, fleet, heterogeneous cuts, comm accounting and int8
activations are later slices (ROADMAP.md).
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, auxiliary, evaluate, splitting, steps
from repro_torch.data.activation_store import ActivationStore
from repro_torch.data.pipeline import ClientData, client_pool
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import make_schedule


class AmpereTrainer:
    def __init__(self, model, run_cfg, clients: List[ClientData], eval_data,
                 *, device=None, log_echo: bool = False):
        self.model = model
        self.run = run_cfg
        self.clients = clients
        self.eval_data = eval_data
        self.device = resolve_device(device)
        self.log_echo = log_echo
        self.rng = np.random.default_rng(run_cfg.fed.seed)
        self.history = {"device": [], "server": []}
        self._device_round = steps.make_device_round_step(model, run_cfg)
        self._server_epoch = steps.make_server_epoch_fn(model, run_cfg)
        self._sched = make_schedule(run_cfg.optim)

    def _record(self, phase: str, rec: dict):
        self.history[phase].append(rec)
        if self.log_echo:
            print(json.dumps({"phase": phase, **rec}), flush=True)

    def _tensors(self, arrays: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    def _init_states(self, gen: torch.Generator):
        """Random init from ``gen`` (on the trainer's device), then split."""
        params = self.model.init(gen, self.device)
        dev, srv = splitting.split_params(self.model, params,
                                          self.run.split.split_point)
        aux = auxiliary.init_aux(self.model, gen, self.run.split, self.device)
        return dev, srv, aux

    # ------------------------------------------------------------------
    # Phase 3: federated device training
    # ------------------------------------------------------------------
    def run_device_phase(self, dev_state, max_rounds: Optional[int] = None):
        fed = self.run.fed
        # every client's samples live on the device; each round gathers its
        # (K, H, b) batches from an index matrix (the JAX pool-fed round)
        pool_np, offsets = client_pool(self.clients)
        pool = self._tensors(pool_np)
        rounds = max_rounds if max_rounds is not None else fed.device_epochs
        state = dev_state
        for rnd in range(rounds):
            cohort = aggregation.sample_cohort(self.rng, fed, rnd)
            ids, w = aggregation.pad_cohort(cohort["clients"],
                                            cohort["weights"],
                                            fed.clients_per_round)
            idx = np.stack([
                offsets[c] + self.clients[c].batch_indices(
                    fed.device_batch_size, fed.local_steps)
                for c in ids])
            idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
            batches = {k: v[idx] for k, v in pool.items()}
            state, metrics = self._device_round(state, batches, w,
                                                self._sched(rnd))
            self._record("device", {"round": rnd,
                                    "loss": float(metrics["loss"]),
                                    **self._aux_eval(state)})
        return state

    @torch.no_grad()
    def _aux_eval(self, dev_state, max_batches: int = 8,
                  batch_size: int = 64):
        p = self.run.split.split_point
        n = len(self.eval_data)
        bs = min(batch_size, n)
        ls, accs = [], []
        for s in range(0, min(n, max_batches * bs) - bs + 1, bs):
            batch = self._tensors({k: v[s:s + bs] for k, v in
                                   self.eval_data.arrays.items()})
            acts = splitting.device_forward(self.model, dev_state["device"],
                                            batch["tokens"], p)
            loss, m = auxiliary.aux_loss(self.model, dev_state["aux"],
                                         dev_state["device"], acts, batch,
                                         self.run.split)
            ls.append(float(loss))
            accs.append(float(m.get("acc", 0.0)))
        return {"val_loss": float(np.mean(ls)), "val_acc": float(np.mean(accs))}

    # ------------------------------------------------------------------
    # Phase 4: one-shot activation generation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate_activations(self, dev_state, store: ActivationStore,
                             batch_size: int = 64):
        p = self.run.split.split_point
        for client in self.clients:
            tokens = client.dataset.arrays["tokens"]
            for s in range(0, len(client.dataset), batch_size):
                tok = tokens[s:s + batch_size]
                acts = splitting.device_forward(
                    self.model, dev_state["device"],
                    torch.as_tensor(tok, device=self.device), p)
                store.add(client.client_id,
                          {"acts": acts.float().cpu().numpy(), "tokens": tok})
        return store

    # ------------------------------------------------------------------
    # Phase 5: centralized server training on the consolidated set
    # ------------------------------------------------------------------
    def run_server_phase(self, dev_state, srv_params, store: ActivationStore,
                         max_epochs: Optional[int] = None):
        run = self.run
        state = steps.init_server_state(self.model, run, srv_params)
        merged_model = build_model(splitting.merged_config(self.model))
        pool = self._tensors(store.pool())
        epochs = max_epochs if max_epochs is not None else run.fed.server_epochs
        for epoch in range(epochs):
            idx = torch.as_tensor(store.epoch_indices(run.fed.server_batch_size),
                                  dtype=torch.long, device=self.device)
            state, losses = self._server_epoch(state, pool, idx)
            ls = losses.double().cpu().numpy()   # one host sync per epoch
            val = evaluate.evaluate(merged_model,
                                    self.merged_params(dev_state,
                                                       state["server"]),
                                    self.eval_data, self.device)
            self._record("server", {
                "epoch": epoch,
                "loss": float(np.mean(ls)) if len(ls) else float("nan"),
                "val_loss": val["loss"], "val_acc": val["acc"]})
        return state

    def merged_params(self, dev_state, server_params):
        return splitting.merge_params(self.model, dev_state["device"],
                                      server_params,
                                      self.run.split.split_point)
