"""Unidirectional Inter-Block Training — the Ampere orchestrator (paper
§3.3, Algorithm 1), static cut, as ``repro.core.uit.AmpereTrainer``.

The phases run in the order ``AmpereSystem.run`` drives them:

1. :meth:`AmpereTrainer._init_states` — init, split, auxiliary network;
2. :meth:`run_device_phase` — federated rounds: cohort sampling, H
   local-SGD steps per client on the auxiliary local loss, weighted
   FedAvg, auxiliary validation, early stop on its loss; or
   :meth:`run_fleet_device_phase`, the same rounds on the cohorts,
   dropouts and clock of a :class:`~repro_torch.fleet.FleetTrace`;
3. :meth:`generate_activations` — one-shot activations of the converged
   device block into the consolidated :class:`ActivationStore`, the
   upload priced through one shared link or, for a fleet, each device on
   its own link in parallel;
4. :meth:`run_server_phase` — server epochs over the device-resident pool,
   merged-model validation after each, early stop on its loss;
5. :meth:`merged_params`.

The loop machinery (checkpoint and resume, round journal, early stop,
metrics log, byte and simulated-time accounting) is the shared
:class:`~repro_torch.experiments.runner.Runner`.  The bytes are the
reference's analytic ones: each round moves the device block and the
auxiliary network down and up for every cohort client
(``2 K (s_d + s_aux)``, as ``repro.transport.cohort_exchange`` without a
transport), the upload moves the store's bytes once, and the clock adds
the round's slowest client, the upload over the testbed link and each
server epoch's analytic compute time.  History records and totals match
the JAX trainer's.  With ``run.split.quantize_activations`` the store
keeps int8 payloads, the upload moves those bytes, and the server pool
stays int8 on the device (its step dequantizes each batch).  A pool above
``run.device_pool_budget_mb`` stays on the host, as in the reference: the
device phase then uploads each round's ``round_batches``, and the server
phase streams the store's ``batches`` through a
:class:`~repro_torch.data.pipeline.DevicePrefetcher`; both draw what the
resident path draws, so the history is the same.  Transport,
observability, streaming and heterogeneous cuts are later slices
(ROADMAP.md queues A5b and A6).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import (aggregation, auxiliary, comm_model, evaluate,
                              splitting, steps)
from repro_torch.data.activation_store import ActivationStore
from repro_torch.data.pipeline import (ClientData, DevicePrefetcher,
                                       client_pool, generators_state,
                                       load_generators_state, round_batches)
from repro_torch.device import resolve_device
from repro_torch.experiments.runner import Runner, StepOutcome
from repro_torch.interop import tree_map
from repro_torch.models import build_model
from repro_torch.optim import make_schedule


class AmpereTrainer:
    def __init__(self, model, run_cfg, clients: List[ClientData], eval_data,
                 workdir: Optional[str] = None, patience: int = 15,
                 log_echo: bool = False, *,
                 device=None):
        self.model = model
        self.run = run_cfg
        self.clients = clients
        self.eval_data = eval_data
        self.workdir = workdir
        self.patience = patience
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(run_cfg.fed.seed)
        self._store: Optional[ActivationStore] = None
        self.runner = Runner(workdir, patience=patience, log_echo=log_echo,
                             history={"device": [], "server": [],
                                      "comm_bytes": 0, "sim_time": 0.0},
                             device=self.device,
                             host_state=(self._host_state,
                                         self._load_host_state))
        self.log = self.runner.log
        self.ckpt = self.runner.ckpt
        self.journal = self.runner.journal
        self.history = self.runner.history
        self._device_round = steps.make_device_round_step(model, run_cfg)
        self._server_step = steps.make_server_train_step(model, run_cfg)
        self._server_epoch = steps.make_server_epoch_fn(model, run_cfg)
        self._sched = make_schedule(run_cfg.optim)

    # ------------------------------------------------------------------
    @functools.cached_property
    def sizes(self) -> comm_model.SplitSizes:
        """The split's byte sizes for comm accounting (a meta-device init:
        nothing allocated), at the clients' sequence length, on first use."""
        return comm_model.split_sizes(self.model, self.run.split,
                                      seq_len=self._seq_len())

    def _seq_len(self) -> int:
        if self.model.kind != "lm":
            return 0
        return int(self.clients[0].dataset.arrays["tokens"].shape[1])

    def _one_way_bytes(self) -> int:
        """Device-block + aux bytes one model exchange moves per client."""
        return self.sizes.device + self.sizes.aux

    def _host_state(self) -> dict:
        """The host-side generators a resumed run must continue from: the
        cohort sampler, each client's batch stream and, in the server
        phase, the store's epoch permutation."""
        out = generators_state(self.rng, self.clients)
        if self._store is not None:
            out["store"] = self._store.rng.bit_generator.state
        return out

    def _load_host_state(self, state: dict):
        load_generators_state(self.rng, self.clients, state)
        if self._store is not None and "store" in state:
            self._store.rng.bit_generator.state = state["store"]

    def _tensors(self, arrays: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    def _fits(self, nbytes: int) -> bool:
        """Whether a pool of ``nbytes`` may live on the device."""
        return nbytes <= self.run.device_pool_budget_mb * 2 ** 20

    def _init_states(self, gen: torch.Generator):
        """Random init from ``gen`` on the generator's own device, moved to
        the trainer's device (a no-op when they agree), then split.  A CPU
        generator gives the same init whatever device trains."""
        params = self.model.init(gen, gen.device)
        aux = auxiliary.init_aux(self.model, gen, self.run.split, gen.device)
        params, aux = (tree_map(lambda t: t.to(self.device), tree)
                       for tree in (params, aux))
        dev, srv = splitting.split_params(self.model, params,
                                          self.run.split.split_point)
        return dev, srv, aux

    # ------------------------------------------------------------------
    # Phase 3: federated device training
    # ------------------------------------------------------------------
    def run_device_phase(self, dev_state, max_rounds: Optional[int] = None):
        fed = self.run.fed
        K = fed.clients_per_round
        dev_state, start_round = self.runner.restore("device", dev_state)
        # every client's samples live on the device when they fit the
        # budget, and each round gathers its (K, H, b) batches from an
        # index matrix (the JAX pool-fed round); otherwise each round
        # uploads its stacked host batches (the same draws)
        resident = self._fits(sum(a.nbytes for c in self.clients
                                  for a in c.dataset.arrays.values()))
        if resident:
            pool_np, offsets = client_pool(self.clients)
            pool = self._tensors(pool_np)
            del pool_np

        def body(state, rnd, _plan):
            cohort = aggregation.sample_cohort(self.rng, fed, rnd)
            ids, w = aggregation.pad_cohort(cohort["clients"],
                                            cohort["weights"], K)
            if resident:
                idx = np.stack([
                    offsets[int(c)] + self.clients[int(c)].batch_indices(
                        fed.device_batch_size, fed.local_steps)
                    for c in ids])
                idx = torch.as_tensor(idx, dtype=torch.long,
                                      device=self.device)
                batches = {k: v[idx] for k, v in pool.items()}
            else:
                batches = self._tensors(round_batches(
                    self.clients, ids, fed.local_steps,
                    fed.device_batch_size))
            state, metrics = self._device_round(state, batches, w,
                                                self._sched(rnd))
            return StepOutcome(
                state=state,
                record={"round": rnd, "loss": float(metrics["loss"]),
                        **self._aux_eval(state)},
                comm_bytes=2 * len(cohort["clients"]) * self._one_way_bytes(),
                sim_time=cohort["round_time"],
                log={"dropped": len(cohort["dropped"])})

        rounds = max_rounds if max_rounds is not None else fed.device_epochs
        return self.runner.run_phase(
            "device", dev_state, ((r, None) for r in range(start_round,
                                                           rounds)),
            body, history_key="device", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)

    # ------------------------------------------------------------------
    # Phase 3 (fleet mode): trace-driven federated device training
    # ------------------------------------------------------------------
    def run_fleet_device_phase(self, dev_state, trace,
                               max_rounds: Optional[int] = None):
        """Device phase driven by a :class:`repro_torch.fleet.FleetTrace`:
        cohorts, dropouts and the clock come from the event-driven
        scheduler instead of ``sample_cohort``, and each round runs through
        :class:`repro_torch.fleet.FleetEngine` (stateless per-round batch
        indices, so a run killed mid-phase resumes onto the same batches).
        Device ids in the trace index ``self.clients``.  Per-profile cuts
        are ROADMAP.md queue A5b: this is the uniform-cut phase."""
        from repro_torch.fleet.engine import FleetEngine

        engine = FleetEngine(self.model, self.run, self.clients,
                             device=self.device)
        dev_state, start_round = self.runner.restore("fleet", dev_state)

        def body(state, rnd, plan):
            state, metrics = engine.run_round(
                state, rnd, plan.clients, plan.weights, self._sched(rnd),
                pad_to=plan.cohort_size)
            return StepOutcome(
                state=state,
                record={"round": rnd, "loss": float(metrics["loss"]),
                        "t_end": plan.t_end, "cohort": plan.cohort_size,
                        "survivors": len(plan.clients),
                        **self._aux_eval(state)},
                comm_bytes=2 * len(plan.clients) * self._one_way_bytes(),
                sim_time=plan.round_time,
                log={"dropped": len(plan.dropped),
                     "sim_t": round(plan.t_end, 6)})

        plans = trace.rounds if max_rounds is None else \
            trace.rounds[:max_rounds]
        return self.runner.run_phase(
            "fleet", dev_state,
            ((p.round_idx, p) for p in plans if p.round_idx >= start_round),
            body, history_key="device", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)

    def run_fleet(self, trace, gen=None, max_rounds=None,
                  max_server_epochs=None, population=None):
        """The full trace-driven Ampere pipeline through
        :class:`repro_torch.experiments.systems.AmpereSystem` (prefer
        :func:`repro_torch.experiments.run_experiment` with a spec that
        sets ``trace_path`` / ``fleet``); ``population`` (the trace's
        :class:`~repro_torch.fleet.DeviceProfile` list) prices the
        one-shot upload on each participant's own link."""
        from repro_torch.experiments.systems import SystemContext, get_system

        ctx = SystemContext(
            model=self.model, run_cfg=self.run, clients=self.clients,
            eval_data=self.eval_data, trainer=self, trace=trace,
            population=population, max_rounds=max_rounds,
            max_server_epochs=max_server_epochs, gen=gen,
            device=self.device)
        return get_system("ampere")().run(ctx)

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
                                            batch[self.model.input_key], p)
            loss, m = auxiliary.aux_loss(self.model, dev_state["aux"],
                                         dev_state["device"], acts, batch,
                                         self.run.split)
            ls.append(float(loss))
            accs.append(float(m.get("acc", 0.0)))
        return {"val_loss": float(np.mean(ls)), "val_acc": float(np.mean(accs))}

    # ------------------------------------------------------------------
    # Phase 4: one-shot activation generation + upload
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate_activations(self, dev_state, store: ActivationStore,
                             batch_size: int = 64, upload: str = "serial",
                             client_bandwidth_bps=None):
        """Every client's activations into ``store``, with their labels
        (the tokens, or the classes).  ``upload`` prices the one-shot
        transfer's simulated clock over the stored bytes (int8 ones when
        the store quantizes): ``"serial"`` — all of them through one
        shared server link; ``"parallel"`` — each device pushes its own
        shard on its own link at once (fleet semantics), so the transfer
        takes as long as the slowest (shard bytes / link) pair.
        ``client_bandwidth_bps`` maps client id -> link bytes/s (a
        :class:`~repro_torch.fleet.DeviceProfile`'s ``bandwidth_bps``);
        without it every device has the testbed link (``BANDWIDTH_BPS``)
        and the largest shard is the slowest."""
        if upload not in ("serial", "parallel"):
            raise ValueError(f"upload={upload!r} not in serial|parallel")
        p = self.run.split.split_point
        for client in self.clients:
            arrays = client.dataset.arrays
            for s in range(0, len(client.dataset), batch_size):
                inp = arrays[self.model.input_key][s:s + batch_size]
                acts = splitting.device_forward(
                    self.model, dev_state["device"],
                    torch.as_tensor(inp, device=self.device), p)
                store.add(client.client_id,
                          {"acts": acts.float().cpu().numpy(),
                           self.model.label_key: arrays[self.model.label_key][
                               s:s + batch_size]})
        if upload == "parallel":
            # the bytes a sample ships, int8 payloads included
            per_sample = store.bytes_received / max(store.num_samples(), 1)
            bw = client_bandwidth_bps or {}
            t_up = max(len(c.dataset) * per_sample
                       / bw.get(c.client_id, comm_model.BANDWIDTH_BPS)
                       for c in self.clients)
        else:
            t_up = store.bytes_received / comm_model.BANDWIDTH_BPS
        self.runner.account(comm_bytes=store.bytes_received, sim_time=t_up)
        self.log.log(phase="transfer", bytes=store.bytes_received,
                     upload=upload)
        return store

    # ------------------------------------------------------------------
    # Phase 5: centralized server training on the consolidated set
    # ------------------------------------------------------------------
    def run_server_phase(self, dev_state, srv_params, store: ActivationStore,
                         max_epochs: Optional[int] = None):
        run = self.run
        self._store = store
        srv_state, start_epoch = self.runner.restore(
            "server", steps.init_server_state(self.model, run, srv_params),
            step_name="epoch")
        merged_model = build_model(splitting.merged_config(self.model))
        epochs = max_epochs if max_epochs is not None else run.fed.server_epochs
        bs = run.fed.server_batch_size
        # an int8 pool is admitted, uploaded and kept as int8; a pool too
        # small for one batch or over the budget streams from the host
        resident = store.num_samples() >= bs and self._fits(
            store.pool_nbytes())
        pool = self._tensors(store.pool()) if resident else None
        epoch_sim_time = comm_model.ampere_server_epoch_time(
            self.model, run.split, comm_model.TimeModel(),
            n_samples=store.num_samples(), seq_len=self._seq_len(),
            sizes=self.sizes)

        def body(srv_state, epoch, _plan):
            # rebinding drops the only reference to the old state (the
            # Runner keeps none), so its optimizer buffers are freed before
            # the merged evaluation, as the reference's donated epoch frees
            # them
            if resident:
                idx = torch.as_tensor(store.epoch_indices(bs),
                                      dtype=torch.long, device=self.device)
                srv_state, losses = self._server_epoch(srv_state, pool, idx)
            else:
                out = []
                for batch in DevicePrefetcher(
                        store.batches(bs, epochs=1),
                        self.device):
                    srv_state, m = self._server_step(srv_state, batch)
                    out.append(m["loss"])
                losses = (torch.stack(out) if out
                          else torch.zeros((0,), device=self.device))
            ls = losses.double().cpu().numpy()   # one host sync per epoch
            val = evaluate.evaluate(merged_model,
                                    self.merged_params(dev_state,
                                                       srv_state["server"]),
                                    self.eval_data, self.device)
            return StepOutcome(
                state=srv_state,
                record={"epoch": epoch,
                        "loss": float(np.mean(ls)) if len(ls) else float("nan"),
                        "val_loss": val["loss"], "val_acc": val["acc"]},
                sim_time=epoch_sim_time)

        held = [srv_state]   # handed over: the Runner empties it
        del srv_state
        try:
            return self.runner.run_phase(
                "server", held,
                ((e, None) for e in range(start_epoch, epochs)),
                body, history_key="server", monitor="val_loss",
                checkpoint_every=run.checkpoint_every, ckpt_offset=10_000,
                step_name="epoch")
        finally:
            self._store = None

    def merged_params(self, dev_state, server_params):
        return splitting.merge_params(self.model, dev_state["device"],
                                      server_params,
                                      self.run.split.split_point)
