"""Unidirectional Inter-Block Training — the Ampere orchestrator (paper
§3.3, Algorithm 1), as ``repro.core.uit.AmpereTrainer``.

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
resident path draws, so the history is the same.

Heterogeneous cuts (``cuts=``, a non-uniform
:class:`~repro_torch.fleet.cuts.CutAssignment`): each client trains and
uploads at its own cut depth.  The device stack is held at the deepest
cut ``p_max``, the server block is split at the shallowest ``p_min``
(``run.split.split_point``) with its loose region reaching ``p_max``,
and each depth ``d`` has its own auxiliary network (``aux["p{d}"]``).  A
fleet round buckets its survivors by cut, each bucket trains the
``[0, d)`` prefix of the stack, and
:func:`~repro_torch.core.aggregation.prefix_fedavg` folds the buckets
back over the layers they share; the store tags each shard with its cut,
and each server epoch runs one pass per depth that enters the server
block at that depth.

Transport and observability (``transport=``, ``quorum_frac=``, ``obs=``):
each round's model exchange goes through
:func:`~repro_torch.transport.cohort_exchange` (a client whose download
or verified upload exhausts its retries is excluded and the survivors
reweighted, unless fewer than the quorum survive), each activation shard
is one transfer, and ``comm_bytes`` is the bytes the wire moved, retries
included.  Without a transport, or with a fault-free one, the accounting
is the analytic one above; faults that retries absorb change only
``comm_bytes`` and ``sim_time``.  ``obs`` records the ``consolidate``,
``aux_eval`` and ``merged_eval`` spans and the per-phase metrics, and
changes no history.

Streaming (a :class:`~repro_torch.streaming.StreamingActivationStore`,
told apart by its ``sample_arrivals``): each shard is committed to the
activation ring with its simulated arrival time (its share of the
upload's clock, priced as the upload is), and a resident server phase
charges each epoch only its pipeline increment past the upload's
accounted end (:class:`~repro_torch.streaming.OverlapAccountant`), the
seconds hidden behind the device round landing in the ``overlap_s``
counter.  The computation is the serialized run's, so every history
record is too; only ``sim_time`` shrinks.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.observability import NULL_OBS
from repro_torch.optim import make_schedule
from repro_torch.streaming.overlap import OverlapAccountant
from repro_torch.transport import (QuorumError, cohort_exchange,
                                   required_quorum)


class AmpereTrainer:
    def __init__(self, model, run_cfg, clients: List[ClientData], eval_data,
                 workdir: Optional[str] = None, patience: int = 15,
                 log_echo: bool = False, *,
                 device=None, cuts=None, transport=None,
                 quorum_frac: float = 1.0, obs=None):
        self.model = model
        self.run = run_cfg
        self.clients = clients
        self.eval_data = eval_data
        self.workdir = workdir
        self.patience = patience
        self.device = resolve_device(device)
        # an optional fault-injecting transport; None keeps the analytic
        # accounting
        self.transport = transport
        self.quorum_frac = quorum_frac
        self.obs = obs if obs is not None else NULL_OBS
        # a non-uniform cut assignment switches the fleet device phase to
        # per-depth buckets and the server phase to per-depth entry
        # points; a uniform one is collapsed onto split_point upstream
        # (experiments.api does), keeping the single-cut path as it is
        self.cuts = None
        self._run_by_depth = {}
        if cuts is not None and not cuts.uniform:
            if cuts.depths[0] != run_cfg.split.split_point:
                raise ValueError(
                    f"run_cfg.split.split_point={run_cfg.split.split_point} "
                    f"must equal the shallowest cut {cuts.depths[0]} (the "
                    "server block is split there)")
            self.cuts = cuts
            self._run_by_depth = {
                d: dataclasses.replace(run_cfg, split=dataclasses.replace(
                    run_cfg.split, split_point=int(d)))
                for d in cuts.depths}
        self.rng = np.random.default_rng(run_cfg.fed.seed)
        self._store: Optional[ActivationStore] = None
        # the upload's accounted end, where a streamed server phase's
        # overlap accounting starts its frontier
        self._transfer_sim_s = 0.0
        self.runner = Runner(workdir, patience=patience, log_echo=log_echo,
                             history={"device": [], "server": [],
                                      "comm_bytes": 0, "sim_time": 0.0},
                             device=self.device,
                             host_state=(self._host_state,
                                         self._load_host_state),
                             fault_plan=(transport.fault_plan
                                         if transport is not None else None),
                             obs=self.obs)
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

    @functools.cached_property
    def _sizes_by_depth(self) -> dict:
        """Each cut depth's split sizes under a heterogeneous assignment."""
        return {d: comm_model.split_sizes(self.model, rc.split,
                                          seq_len=self._seq_len())
                for d, rc in self._run_by_depth.items()}

    def _one_way_bytes(self, client_id=None) -> int:
        """Device-block + aux bytes one model exchange moves for a client
        (at its own cut depth under a heterogeneous assignment)."""
        if self.cuts is None:
            return self.sizes.device + self.sizes.aux
        s = self._sizes_by_depth[self.cuts.cut_of(client_id)]
        return s.device + s.aux

    def _exchange(self, round_key: str, clients, weights, phase: str):
        """One round's model exchange over the transport: ``(survivors,
        weights, wire bytes, extra simulated seconds, excluded ids)``."""
        kept, wire, extra, excluded = cohort_exchange(
            self.transport, round_key=round_key, clients=clients,
            one_way_bytes=[self._one_way_bytes(c) for c in clients],
            quorum_frac=self.quorum_frac, phase=phase)
        return (*aggregation.survivors(clients, weights, kept, excluded),
                wire, extra, excluded)

    def _round_log(self, log: dict, phase: str, clients, excluded) -> dict:
        """:meth:`Runner.exchange_log` of one round of ``clients`` (the
        cohort, each at its own cut's bytes)."""
        return self.runner.exchange_log(
            self.transport, log, phase=phase, excluded=excluded,
            one_way_bytes=sum(self._one_way_bytes(c) for c in clients))

    @staticmethod
    def _device_prefix(device, d: int):
        """The ``[0, d)`` layer slice of a device tree (non-layer keys, the
        LM embedding, ride along whole).  It holds the stack's own tensors:
        every step returns new ones, so one bucket's round never changes
        what another starts from."""
        return dict(device, layers=list(device["layers"][:d]))

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
        generator gives the same init whatever device trains.

        Heterogeneous cuts: the device stack reaches the deepest cut, the
        server block is split at the shallowest with a loose region
        through the deepest (every entry point lands on a loose layer),
        and each depth's auxiliary network (key ``f"p{d}"``) comes from its
        own generator, seeded from one draw of ``gen``."""
        params = self.model.init(gen, gen.device)
        p = self.run.split.split_point
        if self.cuts is None:
            aux = auxiliary.init_aux(self.model, gen, self.run.split,
                                     gen.device)
        else:
            base = int(torch.randint(2 ** 62, (), generator=gen,
                                     device=gen.device))
            aux = {f"p{d}": auxiliary.init_aux(
                       self.model,
                       torch.Generator(gen.device).manual_seed(base + j),
                       self._run_by_depth[d].split, gen.device)
                   for j, d in enumerate(self.cuts.depths)}
        params, aux = (tree_map(lambda t: t.to(self.device), tree)
                       for tree in (params, aux))
        if self.cuts is None:
            dev, srv = splitting.split_params(self.model, params, p)
            return dev, srv, aux
        p_max = self.cuts.depths[-1]
        dev, _ = splitting.split_params(self.model, params, p_max)
        _, srv = splitting.split_params(self.model, params, p,
                                        loose_until=p_max)
        return dev, srv, aux

    # ------------------------------------------------------------------
    # Phase 3: federated device training
    # ------------------------------------------------------------------
    def run_device_phase(self, dev_state, max_rounds: Optional[int] = None):
        if self.cuts is not None:
            raise ValueError(
                "heterogeneous cuts run through the fleet device phase "
                "(a per_profile CutPolicy requires a fleet trace)")
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
            survivors, weights, wire, extra, excluded = self._exchange(
                f"ampere/device/{rnd}", cohort["clients"],
                cohort["weights"], "device")
            ids, w = aggregation.pad_cohort(survivors, weights, K)
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
            record = {"round": rnd, "loss": float(metrics["loss"]),
                      **self._aux_eval(state)}
            log = self._round_log({"dropped": len(cohort["dropped"])},
                                  "device", cohort["clients"], excluded)
            return StepOutcome(state=state, record=record, comm_bytes=wire,
                               sim_time=cohort["round_time"] + extra,
                               log=log)

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
        Device ids in the trace index ``self.clients``."""
        from repro_torch.fleet.engine import FleetEngine

        if self.cuts is not None:
            return self._run_fleet_device_phase_hetero(dev_state, trace,
                                                       max_rounds)
        engine = FleetEngine(self.model, self.run, self.clients,
                             device=self.device)
        dev_state, start_round = self.runner.restore("fleet", dev_state)

        def body(state, rnd, plan):
            survivors, weights, wire, extra, excluded = self._exchange(
                f"ampere/fleet/{rnd}", plan.clients, plan.weights, "fleet")
            state, metrics = engine.run_round(
                state, rnd, survivors, weights, self._sched(rnd),
                pad_to=plan.cohort_size)
            record = {"round": rnd, "loss": float(metrics["loss"]),
                      "t_end": plan.t_end, "cohort": plan.cohort_size,
                      "survivors": len(survivors), **self._aux_eval(state)}
            log = self._round_log({"dropped": len(plan.dropped),
                                   "sim_t": round(plan.t_end, 6)},
                                  "fleet", plan.clients, excluded)
            return StepOutcome(state=state, record=record, comm_bytes=wire,
                               sim_time=plan.round_time + extra, log=log)

        plans = trace.rounds if max_rounds is None else \
            trace.rounds[:max_rounds]
        return self.runner.run_phase(
            "fleet", dev_state,
            ((p.round_idx, p) for p in plans if p.round_idx >= start_round),
            body, history_key="device", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)

    def _run_fleet_device_phase_hetero(self, dev_state, trace,
                                       max_rounds: Optional[int] = None):
        """The fleet device phase with per-profile cut depths: one
        :class:`FleetEngine` per depth; each round buckets its survivors
        by cut, each bucket trains the ``[0, d)`` prefix of the device
        stack with its own auxiliary network (padded to the plan's cohort
        size), and :func:`aggregation.prefix_fedavg` folds the trained
        buckets back over their shared prefix; layers no bucket covers
        keep their value."""
        from repro_torch.fleet.engine import FleetEngine

        cuts = self.cuts
        engines = {d: FleetEngine(self.model, self._run_by_depth[d],
                                  self.clients, device=self.device)
                   for d in cuts.depths}
        dev_state, start_round = self.runner.restore("fleet", dev_state)

        def body(state, rnd, plan):
            lr = self._sched(rnd)
            survivors, weights, wire, extra, excluded = self._exchange(
                f"ampere/fleet/{rnd}", plan.clients, plan.weights, "fleet")
            buckets = {d: ([], []) for d in cuts.depths}
            for c, w in zip(survivors, weights):
                ids, ws = buckets[cuts.cut_of(c)]
                ids.append(c)
                ws.append(w)
            trained, bucket_w = {}, {}
            loss_num = 0.0
            for d, (ids, ws) in buckets.items():
                if not ids:
                    continue
                sub = {"device": self._device_prefix(state["device"], d),
                       "aux": state["aux"][f"p{d}"]}
                trained[d], metrics = engines[d].run_round(
                    sub, rnd, ids, ws, lr, pad_to=plan.cohort_size)
                bucket_w[d] = float(sum(ws))
                loss_num += bucket_w[d] * float(metrics["loss"])
            with torch.no_grad():
                device = aggregation.prefix_fedavg(
                    state["device"],
                    {d: t["device"] for d, t in trained.items()}, bucket_w)
            aux = dict(state["aux"],
                       **{f"p{d}": t["aux"] for d, t in trained.items()})
            state = {"device": device, "aux": aux}
            total_w = sum(bucket_w.values())
            record = {"round": rnd,
                      "loss": loss_num / total_w if total_w else 0.0,
                      "t_end": plan.t_end, "cohort": plan.cohort_size,
                      "survivors": len(survivors), **self._aux_eval(state)}
            log = self._round_log(
                {"dropped": len(plan.dropped), "sim_t": round(plan.t_end, 6),
                 "buckets": {f"p{d}": len(ids)
                             for d, (ids, _) in buckets.items()}},
                "fleet", plan.clients, excluded)
            return StepOutcome(state=state, record=record, comm_bytes=wire,
                               sim_time=plan.round_time + extra, log=log)

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

    def _aux_heads(self, dev_state):
        """(cut depth, split config, auxiliary network) of each depth."""
        if self.cuts is None:
            return [(self.run.split.split_point, self.run.split,
                     dev_state["aux"])]
        return [(d, self._run_by_depth[d].split, dev_state["aux"][f"p{d}"])
                for d in self.cuts.depths]

    @torch.no_grad()
    def _aux_eval(self, dev_state, max_batches: int = 8,
                  batch_size: int = 64):
        """Auxiliary validation; under heterogeneous cuts each depth's head
        on its own prefix of the stack, averaged over the depths."""
        with self.obs.tracer.span("aux_eval", track="eval") as sp:
            n = len(self.eval_data)
            bs = min(batch_size, n)
            ls, accs = [], []
            for s in range(0, min(n, max_batches * bs) - bs + 1, bs):
                batch = self._tensors({k: v[s:s + bs] for k, v in
                                       self.eval_data.arrays.items()})
                for p, split_cfg, aux in self._aux_heads(dev_state):
                    acts = splitting.device_forward(
                        self.model, dev_state["device"],
                        batch[self.model.input_key], p)
                    loss, m = auxiliary.aux_loss(self.model, aux,
                                                 dev_state["device"], acts,
                                                 batch, split_cfg)
                    ls.append(float(loss))
                    accs.append(float(m.get("acc", 0.0)))
            out = {"val_loss": float(np.mean(ls)),
                   "val_acc": float(np.mean(accs))}
            sp.set(**out)
        return out

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
        and the largest shard is the slowest.  Under heterogeneous cuts
        each client's activations come from its own prefix of the device
        stack, and its shards carry its cut tag.

        The store's writer thread stores the shards while the next ones
        are computed; each reaches it as a host copy (a synchronous
        device-to-host copy, so no shard is read before it has landed).
        Under a transport each shard is one transfer
        (``acts/{client}/{i}``, stable across retries and a resumed
        rerun), a duplicate is absorbed by its idempotency key, and under
        faults a client's shards are held back until all of them verify,
        so a client that fails mid-stream never half-lands; too few
        verified clients raise :class:`~repro_torch.transport.QuorumError`.
        ``comm_bytes`` is then the wire's total, retries included."""
        if upload not in ("serial", "parallel"):
            raise ValueError(f"upload={upload!r} not in serial|parallel")
        with self.obs.tracer.span("consolidate", track="transfer",
                                  upload=upload) as sp:
            return self._generate_activations(dev_state, store, batch_size,
                                              upload, client_bandwidth_bps,
                                              sp)

    def _generate_activations(self, dev_state, store, batch_size, upload,
                              client_bandwidth_bps, sp):
        transport = self.transport
        faulty = transport is not None and transport.faulty
        lab_key = self.model.label_key
        wire_total = 0
        client_extra: dict = {}
        failed: set = set()
        pending: dict = {}
        # a streaming store: each shard carries its simulated arrival,
        # serial: the stored bytes so far through the shared link plus
        # every retry's extra so far (the last lands at the upload's
        # accounted end); parallel: the client's bytes so far on its own
        # link plus its own extras
        streams = hasattr(store, "sample_arrivals")
        bytes_cum: dict = {None: 0}

        def arrival(cid, nbytes):
            if upload == "parallel":
                bytes_cum[cid] = bytes_cum.get(cid, 0) + nbytes
                bw_c = (client_bandwidth_bps.get(cid,
                                                 comm_model.BANDWIDTH_BPS)
                        if client_bandwidth_bps is not None
                        else comm_model.BANDWIDTH_BPS)
                return bytes_cum[cid] / bw_c + client_extra.get(cid, 0.0)
            bytes_cum[None] += nbytes
            return (bytes_cum[None] / comm_model.BANDWIDTH_BPS
                    + sum(client_extra.values()))

        def submit(cid, shard, t_arr, cut):
            if streams:
                store.submit(cid, shard, t_arrival=t_arr, cut=cut)
            else:
                store.submit(cid, shard, cut=cut)

        store.start_writer()
        try:
            for client in self.clients:
                cid = client.client_id
                cut = None if self.cuts is None else self.cuts.cut_of(cid)
                p = self.run.split.split_point if cut is None else cut
                arrays = client.dataset.arrays
                for i, s in enumerate(range(0, len(client.dataset),
                                            batch_size)):
                    inp = arrays[self.model.input_key][s:s + batch_size]
                    acts = splitting.device_forward(
                        self.model, dev_state["device"],
                        torch.as_tensor(inp, device=self.device), p)
                    shard = {"acts": acts.float().cpu().numpy(),
                             lab_key: arrays[lab_key][s:s + batch_size]}
                    del acts
                    if transport is not None:
                        bw = (client_bandwidth_bps.get(
                                  cid, comm_model.BANDWIDTH_BPS)
                              if client_bandwidth_bps is not None else None)
                        res = transport.transfer(
                            f"acts/{cid}/{i}",
                            ActivationStore.shard_nbytes(shard,
                                                         store.quantize),
                            device=cid, bandwidth_bps=bw, phase="transfer")
                        wire_total += res.wire_bytes
                        client_extra[cid] = client_extra.get(cid, 0.0) \
                            + res.extra_time
                        if not res.ok:
                            failed.add(cid)
                            continue
                        if not res.first_delivery:
                            continue    # a duplicate, absorbed
                    t_arr = (arrival(cid, ActivationStore.shard_nbytes(
                        shard, store.quantize)) if streams else 0.0)
                    if faulty:
                        pending.setdefault(cid, []).append(
                            (shard, t_arr, cut))
                    else:
                        submit(cid, shard, t_arr, cut)
            for cid, shards in pending.items():
                if cid not in failed:
                    for shard, t_arr, cut in shards:
                        submit(cid, shard, t_arr, cut)
        finally:
            store.finish()
        if faulty and failed:
            survivors = len(self.clients) - len(failed)
            need = required_quorum(len(self.clients), self.quorum_frac)
            if survivors < need:
                raise QuorumError(
                    f"activation upload: only {survivors}/"
                    f"{len(self.clients)} clients verified, quorum needs "
                    f"{need} (failed: {sorted(failed)})")
        if upload == "parallel":
            # the bytes a sample ships, int8 payloads included
            per_sample = store.bytes_received / max(store.num_samples(), 1)
            bw = client_bandwidth_bps or {}
            t_up = max(len(c.dataset) * per_sample
                       / bw.get(c.client_id, comm_model.BANDWIDTH_BPS)
                       for c in self.clients)
        else:
            t_up = store.bytes_received / comm_model.BANDWIDTH_BPS
        extra_total = 0.0
        if client_extra:
            extra_total = (max(client_extra.values()) if upload == "parallel"
                           else sum(client_extra.values()))
        self._transfer_sim_s = t_up + extra_total
        self.runner.account(
            comm_bytes=(wire_total if transport is not None
                        else store.bytes_received),
            sim_time=t_up + extra_total, phase="transfer", direction="up")
        if self.obs.enabled and failed:
            self.obs.metrics.counter("excluded_devices", len(failed),
                                     phase="transfer")
        sp.set(bytes=store.bytes_received, sim_time_s=round(t_up, 9),
               excluded=len(failed))
        if streams:
            rs = store.ring.stats
            sp.set(streaming=True, ring_segments=rs["segments"],
                   ring_stalls=rs["stalls"],
                   ring_max_occupancy=rs["max_occupancy"])
            self.obs.metrics.counter("ring_backpressure_stalls",
                                     rs["stalls"], phase="transfer")
            if rs["torn_repairs"]:
                self.obs.metrics.counter("ring_torn_repairs",
                                         rs["torn_repairs"],
                                         phase="transfer")
        if faulty:
            self.log.log(phase="transfer", bytes=store.bytes_received,
                         upload=upload, wire=wire_total,
                         excluded=len(failed))
        else:
            self.log.log(phase="transfer", bytes=store.bytes_received,
                         upload=upload)
        return store

    # ------------------------------------------------------------------
    # Phase 5: centralized server training on the consolidated set
    # ------------------------------------------------------------------
    def run_server_phase(self, dev_state, srv_params, store: ActivationStore,
                         max_epochs: Optional[int] = None):
        """Server epochs over the consolidated pool, merged-model
        validation after each.  Under heterogeneous cuts the device-trained
        overlap layers are first copied into the server block, and each
        epoch runs one pass per cut depth (:meth:`_depth_epochs`)."""
        run = self.run
        self._store = store
        try:
            if self.cuts is not None:
                srv_params = self._sync_overlap_from_device(
                    dev_state["device"], srv_params)
            srv_state, start_epoch = self.runner.restore(
                "server", steps.init_server_state(self.model, run,
                                                  srv_params),
                step_name="epoch")
            merged_model = build_model(splitting.merged_config(self.model))
            epochs = max_epochs if max_epochs is not None \
                else run.fed.server_epochs
            train_epoch = (self._one_cut_epochs(store) if self.cuts is None
                           else self._depth_epochs(store))

            def body(srv_state, epoch, _plan):
                # handed over: the Runner keeps no reference and neither
                # does this frame, so each step frees the state it replaced
                # (the reference donates it)
                held = [srv_state]
                del srv_state
                srv_state, ls, epoch_sim_time = train_epoch(held, epoch)
                with self.obs.tracer.span("merged_eval", track="eval",
                                          epoch=epoch) as esp:
                    val = evaluate.evaluate(
                        merged_model,
                        self.merged_params(dev_state, srv_state["server"]),
                        self.eval_data, self.device)
                    esp.set(val_loss=val["loss"], val_acc=val["acc"])
                return StepOutcome(
                    state=srv_state,
                    record={"epoch": epoch,
                            "loss": float(np.mean(ls)) if len(ls)
                            else float("nan"),
                            "val_loss": val["loss"], "val_acc": val["acc"]},
                    sim_time=epoch_sim_time)

            held = [srv_state]   # handed over: the Runner empties it
            del srv_state
            return self.runner.run_phase(
                "server", held,
                ((e, None) for e in range(start_epoch, epochs)),
                body, history_key="server", monitor="val_loss",
                checkpoint_every=run.checkpoint_every, ckpt_offset=10_000,
                step_name="epoch")
        finally:
            self._store = None

    def _one_cut_epochs(self, store: ActivationStore):
        """``train_epoch`` at one cut: an epoch over the device-resident
        pool (an int8 pool is admitted, uploaded and kept as int8), or, for
        a pool too small for one batch or over the budget, over the
        store's batches streamed from the host.  ``train_epoch(held,
        epoch)`` takes the state out of the one-element list ``held`` and
        returns the new state, the epoch's losses on the host (one sync)
        and the epoch's simulated seconds: the analytic epoch time, or,
        over a streamed resident pool, its increment past the accounted
        frontier (``stream_consume`` span, ``overlap_s`` counter)."""
        bs = self.run.fed.server_batch_size
        resident = store.num_samples() >= bs and self._fits(
            store.pool_nbytes())
        # pool() concatenates: a streamed pool's read-only segment views
        # never reach a tensor
        pool = self._tensors(store.pool()) if resident else None
        epoch_sim_time = comm_model.ampere_server_epoch_time(
            self.model, self.run.split, comm_model.TimeModel(),
            n_samples=store.num_samples(), seq_len=self._seq_len(),
            sizes=self.sizes)
        accountant = None
        if resident and hasattr(store, "sample_arrivals"):
            accountant = OverlapAccountant(
                store.sample_arrivals(), device_end=self._transfer_sim_s,
                per_batch_s=epoch_sim_time / max(1, store.num_samples()
                                                 // bs))

        def train_epoch(held, epoch):
            sim = epoch_sim_time
            if resident:
                idx_np = store.epoch_indices(bs)
                idx = torch.as_tensor(idx_np, dtype=torch.long,
                                      device=self.device)
                if accountant is None:
                    srv_state, losses = self._server_epoch(held.pop(), pool,
                                                           idx)
                else:
                    with self.obs.tracer.span("stream_consume",
                                              track="streaming",
                                              epoch=epoch) as csp:
                        srv_state, losses = self._server_epoch(held.pop(),
                                                               pool, idx)
                        sim, overlapped = accountant.epoch(idx_np)
                        csp.set(sim_s=round(sim, 9),
                                overlap_s=round(overlapped, 9))
                    self.obs.metrics.counter("overlap_s", overlapped,
                                             phase="server")
            else:
                srv_state, out = held.pop(), []
                for batch in DevicePrefetcher(store.batches(bs, epochs=1),
                                              self.device):
                    srv_state, m = self._server_step(srv_state, batch)
                    out.append(m["loss"])
                losses = (torch.stack(out) if out
                          else torch.zeros((0,), device=self.device))
            return srv_state, losses.double().cpu().numpy(), sim

        return train_epoch

    def _depth_epochs(self, store: ActivationStore):
        """``train_epoch`` (as :meth:`_one_cut_epochs`'s) over a
        heterogeneous-cut pool:
        the shards are bucketed by their cut tag, and an epoch runs one
        pass per depth, in sorted order (so the store's rng stream is
        deterministic), each entering the server block at its depth.  The
        pool must fit the device budget (no host-streaming fallback, as in
        the reference), and the simulated epoch is the sum of each
        bucket's, priced at its depth."""
        run = self.run
        if not self._fits(store.pool_nbytes()):
            raise ValueError(
                f"heterogeneous-cut pool ({store.pool_nbytes()} bytes) "
                f"exceeds device_pool_budget_mb={run.device_pool_budget_mb}"
                "; per-bucket server epochs require a resident pool")
        present = [d for d in store.cut_depths()
                   if store.num_samples(cut=d) > 0]
        if not present:
            raise ValueError("heterogeneous server phase: store has no "
                             "cut-tagged activation shards")
        pools = {d: self._tensors(store.pool(cut=d)) for d in present}
        epoch_fns = {d: steps.make_server_epoch_fn(self.model, run, entry=d)
                     for d in present}
        bs = run.fed.server_batch_size

        epoch_sim_time = sum(
            comm_model.ampere_server_epoch_time(
                self.model, self._run_by_depth[d].split,
                comm_model.TimeModel(), n_samples=store.num_samples(cut=d),
                seq_len=self._seq_len(), sizes=self._sizes_by_depth[d])
            for d in present)

        def train_epoch(held, _epoch):
            ls = []
            for d in present:
                idx = store.epoch_indices(min(bs, store.num_samples(cut=d)),
                                          cut=d)
                srv_state, losses = epoch_fns[d](
                    held.pop(), pools[d],
                    torch.as_tensor(idx, dtype=torch.long,
                                    device=self.device))
                held.append(srv_state)
                del srv_state
                ls.append(losses.double().cpu().numpy())
            return held.pop(), np.concatenate(ls), epoch_sim_time

        return train_epoch

    def _sync_overlap_from_device(self, device, server):
        """The server block with the device-trained overlap layers
        ``[p_min, p_max)`` of the device stack in its loose region: the
        block was carved at init, and the device phase has since trained
        those layers for the deeper buckets."""
        p_min = self.run.split.split_point
        key = "layers_head" if self.model.kind == "lm" else "layers"
        layers = list(server[key])
        for layer in range(p_min, self.cuts.depths[-1]):
            layers[layer - p_min] = device["layers"][layer]
        return dict(server, **{key: layers})

    def merged_params(self, dev_state, server_params):
        """The full merged model.  Under heterogeneous cuts the device
        stack is oversized: ``merge_params`` reads its first
        ``split_point`` layers, and the overlap layers come from the server
        block's loose region, which holds the server-trained copy."""
        return splitting.merge_params(self.model, dev_state["device"],
                                      server_params,
                                      self.run.split.split_point)
