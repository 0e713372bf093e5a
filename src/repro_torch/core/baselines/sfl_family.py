"""SFL baselines the paper evaluates against (§5.1), as
``repro.core.baselines.sfl_family``:

* ``splitfed``    — SplitFed V1 [Thapa et al., AAAI'22]: per-client device
  AND server blocks, end-to-end split training, both sides FedAvg'd each
  round.
* ``splitfedv2``  — one shared server block, trained sequentially over the
  cohort's clients (padded zero-weight slots too); device blocks FedAvg'd.
* ``splitgp``     — SplitGP [Han et al., INFOCOM'23]: the device carries a
  local (auxiliary) head; loss = 0.5 global + 0.5 local; everything
  aggregated.
* ``scaffold``    — SplitFed + SCAFFOLD [Karimireddy et al., ICML'20]
  control variates on the client-held blocks.
* ``pipar``       — PiPar [Zhang et al., JPDC'24]: SplitFed's mathematics;
  its pipeline overlap changes only the simulated clock.
* ``splitfed_mb`` — minibatch-SGD SplitFed [Oh et al., arXiv:2308.11953]:
  the cohort's gradients are weight-averaged every iteration and one
  global SGD step is taken.
* ``splitfed_pa`` — collaborative / parallel-aggregation SplitFed
  [arXiv:2504.15724]: SplitFed's per-iteration split training, the
  server folding client *deltas* into the global model on a buffered
  asynchronous schedule (:func:`repro_torch.core.aggregation
  .fedbuff_stacked` with the schedule's staleness weights; the schedule
  comes from the fleet scheduler priced with SplitFed's exchange, see
  ``SplitFedPASystem``).

The K cohort clients train one after another (a Python loop where the JAX
package vmaps), each update done in fp32 and cast back.  Every iteration
exchanges activations and their gradients with the server; the trainer
counts those bytes and the model exchange per round as the reference does.
Under a transport (``transport=``, ``quorum_frac=``) each client's round
exchange is one :func:`~repro_torch.transport.cohort_exchange` message
each way: excluded clients drop out of the round and the survivors are
reweighted, and ``comm_bytes`` is what the wire moved.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import (aggregation, auxiliary, comm_model, evaluate,
                              losses, splitting)
from repro_torch.core.steps import sgd, value_and_grad
from repro_torch.data.pipeline import (ClientData, generators_state,
                                       load_generators_state, round_batches)
from repro_torch.device import resolve_device
from repro_torch.experiments.runner import Runner, StepOutcome
from repro_torch.interop import tree_map
from repro_torch.models import build_model
from repro_torch.optim import make_schedule
from repro_torch.transport import cohort_exchange

def _e2e_split_loss(model, run_cfg, dev, srv, batch):
    """Device forward, server forward and the task loss plus the server
    layers' MoE balance loss in one graph."""
    p = run_cfg.split.split_point
    acts = splitting.device_forward(model, dev, batch[model.input_key], p)
    out = splitting.server_forward(model, srv, acts, p, remat="none")
    if model.kind == "lm":
        loss, _ = losses.lm_loss_from_hidden(
            out["hidden"], splitting.server_head_weight(srv),
            batch["tokens"], softcap=model.cfg.final_softcap)
    else:
        loss, _ = losses.classification_loss(out["logits"], batch["labels"])
    return loss + out["aux"]


def _client(batches: dict, c: int) -> dict:
    return {k: v[c] for k, v in batches.items()}


@torch.no_grad()
def _weighted_sum(trees, w):
    """sum_k w[k] trees[k], leaf by leaf, in fp32 (the reference's
    ``einsum("k,k...->...", w, .)``)."""
    def agg(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        return torch.sum(stacked * w.reshape((-1,) + (1,) * leaves[0].dim()),
                         dim=0)
    return tree_map(agg, *trees)


def make_sfl_round_step(model, run_cfg, variant: str = "splitfed"):
    """One federated round.  state: {"device", "server"[, "aux"]}; batch
    leaves (K, H, b, ...); weights (K,) (zero = padded client).  SCAFFOLD's
    step also takes and returns ``(c, c_k)``, ``c_k`` stacked over the
    cohort."""
    H = run_cfg.fed.local_steps
    split_cfg = run_cfg.split
    p = split_cfg.split_point

    def joint_loss(par, batch):
        if variant == "splitgp":
            dev, srv, aux = par
            g = _e2e_split_loss(model, run_cfg, dev, srv, batch)
            acts = splitting.device_forward(model, dev,
                                            batch[model.input_key], p)
            l, _ = auxiliary.aux_loss(model, aux, dev, acts, batch, split_cfg)
            return 0.5 * g + 0.5 * l
        dev, srv = par
        return _e2e_split_loss(model, run_cfg, dev, srv, batch)

    def local_steps(par, client_batches, lr, controls=None):
        """H SGD steps of one client from ``par``; SCAFFOLD corrects each
        gradient by ``c - c_k``.  The mean loss over the steps."""
        losses_h = []
        for h in range(H):
            loss, grads = value_and_grad(
                joint_loss, par, {k: v[h] for k, v in client_batches.items()})
            if controls is not None:
                c_global, c_k = controls
                grads = tree_map(lambda g, ck, c: g.float() - ck + c,
                                 grads, c_k, c_global)
            par = sgd(par, grads, lr)
            del grads
            losses_h.append(loss)
        return par, torch.stack(losses_h).mean()

    def weighted_loss(loss_k, weights):
        w = aggregation.normalize_weights(weights, loss_k[0].device)
        return torch.sum(torch.stack(loss_k) * w)

    if variant in ("splitfed", "pipar", "splitgp"):
        keys = (("device", "server", "aux") if variant == "splitgp"
                else ("device", "server"))

        def round_step(state, batches, weights, lr):
            par = tuple(state[k] for k in keys)
            par_k, loss_k = [], []
            for c in range(len(weights)):
                pk, lk = local_steps(par, _client(batches, c), lr)
                par_k.append(pk)
                loss_k.append(lk)
            agg = aggregation.fedavg_stacked(par_k, weights)
            return dict(zip(keys, agg)), {"loss": weighted_loss(loss_k,
                                                                weights)}
        return round_step

    if variant == "splitfedv2":
        def round_step(state, batches, weights, lr):
            # the shared server trains on every slot in turn, padded
            # zero-weight repeats too (the reference scans them all)
            server, dev_k, loss_k = state["server"], [], []
            for c in range(len(weights)):
                (dev, server), lk = local_steps((state["device"], server),
                                                _client(batches, c), lr)
                dev_k.append(dev)
                loss_k.append(lk)
            return ({"device": aggregation.fedavg_stacked(dev_k, weights),
                     "server": server},
                    {"loss": weighted_loss(loss_k, weights)})
        return round_step

    if variant == "scaffold":
        def round_step(state, controls, batches, weights, lr):
            c_global, c_k = controls
            par = (state["device"], state["server"])
            # the reference's H * lr, an fp32 product
            hlr = float(np.float32(H) * np.float32(lr))
            par_k, ck_new, loss_k = [], [], []
            for c in range(len(weights)):
                ck = tree_map(lambda x: x[c], c_k)
                pk, lk = local_steps(par, _client(batches, c), lr,
                                     controls=(c_global, ck))
                with torch.no_grad():
                    # c_k' = c_k - c + (x - y) / (H lr)
                    ck_new.append(tree_map(
                        lambda ck_, c_, x, y: ck_ - c_ + (x.float()
                                                         - y.float()) / hlr,
                        ck, c_global, par, pk))
                par_k.append(pk)
                loss_k.append(lk)
            agg = aggregation.fedavg_stacked(par_k, weights)
            with torch.no_grad():
                w = aggregation.normalize_weights(weights, lk.device)
                # c <- c + sum_k w_k (c_k' - c) |{w > 0}| / N: the
                # reference subtracts the global c here, not c_k
                frac = float(np.float32(sum(x > 0 for x in weights))
                             / np.float32(run_cfg.fed.num_clients))
                deltas = [tree_map(lambda new, old: new - old, n, c_global)
                          for n in ck_new]
                dc = tree_map(lambda d: d * frac, _weighted_sum(deltas, w))
                new_c = tree_map(lambda c_, d: c_ + d, c_global, dc)
                c_k_new = tree_map(lambda *xs: torch.stack(xs), *ck_new)
            return ({"device": agg[0], "server": agg[1]},
                    (new_c, c_k_new), {"loss": weighted_loss(loss_k,
                                                             weights)})
        return round_step

    if variant == "splitfed_mb":
        def round_step(state, batches, weights, lr):
            par = (state["device"], state["server"])
            w = aggregation.normalize_weights(
                weights, next(iter(batches.values())).device)
            losses_h = []
            for h in range(H):
                grads_k, loss_k = [], []
                for c in range(len(weights)):
                    lk, gk = value_and_grad(
                        joint_loss, par,
                        {k: v[c, h] for k, v in batches.items()})
                    grads_k.append(gk)
                    loss_k.append(lk)
                par = sgd(par, _weighted_sum(grads_k, w), lr)
                del grads_k
                losses_h.append(torch.sum(torch.stack(loss_k) * w))
            return ({"device": par[0], "server": par[1]},
                    {"loss": torch.stack(losses_h).mean()})
        return round_step

    if variant == "splitfed_pa":
        def round_step(state, batches, weights, lr):
            par = (state["device"], state["server"])
            par_k, loss_k = [], []
            for c in range(len(weights)):
                pk, lk = local_steps(par, _client(batches, c), lr)
                par_k.append(pk)
                loss_k.append(lk)
            # the buffered delta fold: replayed in process, every buffered
            # client trains from the current global, so with its snapshots
            # all the global this is staleness-weighted FedAvg; parameter
            # lag enters through the plan's 1/sqrt(1+s) weights
            with torch.no_grad():
                new = aggregation.fedbuff_stacked(par, par_k,
                                                  [par] * len(par_k),
                                                  weights)
            return ({"device": new[0], "server": new[1]},
                    {"loss": weighted_loss(loss_k, weights)})
        return round_step

    raise ValueError(f"unknown SFL variant {variant!r}")


class SFLTrainer:
    """Host loop shared by the SFL-family baselines, as
    ``repro.core.baselines.SFLTrainer``: cohort sampling, the round step,
    the merged model's evaluation every round, and the reference's
    analytic accounting, through the shared
    :class:`~repro_torch.experiments.runner.Runner` (checkpoints carry the
    ``(state, controls)`` pack and the host generators)."""

    def __init__(self, model, run_cfg, clients: List[ClientData], eval_data,
                 variant: str = "splitfed", workdir: Optional[str] = None,
                 patience: int = 15, log_echo: bool = False, *,
                 device=None, transport=None, quorum_frac: float = 1.0,
                 obs=None):
        self.model = model
        self.run = run_cfg
        self.variant = variant
        self.clients = clients
        self.eval_data = eval_data
        self.patience = patience
        self.device = resolve_device(device)
        self.transport = transport
        self.quorum_frac = quorum_frac
        self.rng = np.random.default_rng(run_cfg.fed.seed)
        self._round = make_sfl_round_step(model, run_cfg, variant)
        self.runner = Runner(workdir, patience=patience, log_echo=log_echo,
                             log_name=f"{variant}.jsonl",
                             history={"rounds": [], "comm_bytes": 0,
                                      "sim_time": 0.0},
                             device=self.device,
                             host_state=(
                                 lambda: generators_state(self.rng, clients),
                                 lambda st: load_generators_state(
                                     self.rng, clients, st)),
                             fault_plan=(transport.fault_plan
                                         if transport is not None else None),
                             obs=obs)
        self.log = self.runner.log
        self.history = self.runner.history
        self._sched = make_schedule(run_cfg.optim)
        seq = (clients[0].dataset.arrays["tokens"].shape[1]
               if model.kind == "lm" else 0)
        self.sizes = comm_model.split_sizes(model, run_cfg.split,
                                            seq_len=max(seq, 1))
        self.seq_len = seq

    def _init_state(self, gen: torch.Generator):
        """Random init from ``gen`` on its own device (a CPU generator gives
        the same init whatever device trains), moved to the trainer's
        device and split; SCAFFOLD's controls ``c`` and every client's
        ``c_k`` start at zero."""
        params = self.model.init(gen, gen.device)
        dev, srv = splitting.split_params(self.model, params,
                                          self.run.split.split_point)
        state = {"device": dev, "server": srv}
        if self.variant == "splitgp":
            state["aux"] = auxiliary.init_aux(self.model, gen,
                                              self.run.split, gen.device)
        state = tree_map(lambda t: t.to(self.device), state)
        controls = None
        if self.variant == "scaffold":
            par = (state["device"], state["server"])
            n = self.run.fed.num_clients
            controls = (
                tree_map(lambda x: torch.zeros(x.shape, device=self.device),
                         par),
                tree_map(lambda x: torch.zeros((n,) + x.shape,
                                               device=self.device), par))
        return state, controls

    def run_rounds(self, max_rounds: int, gen=None, cohort_plan=None, *,
                   init=None):
        """``max_rounds`` rounds from ``gen``'s init (``None``: a CPU
        generator seeded from ``run.seed``), or from ``init``, an
        ``_init_state`` result handed over in a one-element list (emptied
        here), or from the newest checkpoint.

        ``cohort_plan``: an optional list of ``sample_cohort``-shaped
        dicts, one a round, replacing the i.i.d. cohort sampling, so a
        baseline replays the churn and dropout schedule a fleet trace
        recorded (at most ``len(cohort_plan)`` rounds; each round padded
        to the entry's ``cohort_size``).  An entry's ``round_time``, when
        it carries one, prices the round's clock; otherwise (and always
        for the bytes) this trainer's analytic model does.
        :func:`repro_torch.experiments.systems.replay_plan` builds one."""
        fed = self.run.fed
        p = self.run.split.split_point
        gen = gen if gen is not None else \
            torch.Generator().manual_seed(self.run.seed)
        pack, start_round = self.runner.restore(
            f"sfl-{self.variant}",
            init.pop() if init is not None else self._init_state(gen))
        merged_model = build_model(splitting.merged_config(self.model))
        K = fed.clients_per_round
        tm = comm_model.TimeModel()
        if cohort_plan is not None:
            max_rounds = min(max_rounds, len(cohort_plan))
        iters, b = fed.local_steps, fed.device_batch_size
        # per round and client: H iterations of activations down and their
        # gradients up, and the model exchange (SplitGP's head too;
        # SCAFFOLD's controls double it), each one way
        act_bytes = 2 * self.sizes.act_per_sample * b * iters
        model_bytes = 2 * (self.sizes.device
                           + (self.sizes.aux if self.variant == "splitgp"
                              else 0))
        if self.variant == "scaffold":
            model_bytes *= 2
        one_way = (act_bytes + model_bytes) // 2
        phase = f"sfl-{self.variant}"
        # every variant but PiPar is priced as SplitFed, as the reference
        # prices it
        round_time = comm_model.epoch_time(
            "pipar" if self.variant == "pipar" else "splitfed", self.model,
            self.run.split, tm, n_samples=b * iters, batch_size=b,
            seq_len=self.seq_len, sizes=self.sizes)

        def body(pack, rnd, _plan):
            state, controls = pack
            del pack
            if cohort_plan is not None:
                cohort = cohort_plan[rnd]
                pad_k = int(cohort.get("cohort_size",
                                       len(cohort["clients"])))
            else:
                cohort = aggregation.sample_cohort(self.rng, fed, rnd)
                pad_k = K
            kept, wire, extra, excluded = cohort_exchange(
                self.transport, round_key=f"sfl-{self.variant}/{rnd}",
                clients=cohort["clients"], one_way_bytes=one_way,
                quorum_frac=self.quorum_frac, phase=phase)
            ids, w = aggregation.pad_cohort(*aggregation.survivors(
                cohort["clients"], cohort["weights"], kept, excluded), pad_k)
            batches = {k: torch.as_tensor(v, device=self.device)
                       for k, v in round_batches(self.clients, ids, iters,
                                                 b).items()}
            lr = self._sched(rnd)
            if self.variant == "scaffold":
                c, c_k_all = controls
                idx = torch.as_tensor(ids, device=self.device)
                state, (c, c_k_cohort), metrics = self._round(
                    state, (c, tree_map(lambda x: x[idx], c_k_all)),
                    batches, w, lr)
                # a repeated id (a padded slot) is written more than once,
                # and which write wins is unspecified, as in the reference
                controls = (c, tree_map(
                    lambda full, upd: full.index_put((idx,), upd),
                    c_k_all, c_k_cohort))
                del c_k_all, c_k_cohort
            else:
                state, metrics = self._round(state, batches, w, lr)
            del batches
            merged = splitting.merge_params(self.model, state["device"],
                                            state["server"], p)
            val = evaluate.evaluate(merged_model, merged, self.eval_data,
                                    self.device)
            del merged
            log = self.runner.exchange_log(
                self.transport, {"variant": self.variant}, phase=phase,
                one_way_bytes=one_way * len(cohort["clients"]),
                excluded=excluded)
            return StepOutcome(
                state=(state, controls),
                record={"round": rnd, "loss": float(metrics["loss"]),
                        "val_loss": val["loss"], "val_acc": val["acc"]},
                comm_bytes=wire,
                sim_time=(float(cohort["round_time"])
                          if cohort_plan is not None
                          and cohort.get("round_time") is not None
                          else round_time) + extra,
                log=log)

        held = [pack]   # handed over: the Runner empties it
        del pack
        state, controls = self.runner.run_phase(
            f"sfl-{self.variant}", held,
            ((r, None) for r in range(start_round, max_rounds)),
            body, history_key="rounds", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)
        return {"state": state, "controls": controls,
                "history": self.history,
                "merged_params": splitting.merge_params(
                    self.model, state["device"], state["server"], p)}
