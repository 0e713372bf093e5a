"""Training launcher: Ampere or a synchronous baseline on synthetic
non-IID data, as ``repro.launch.train``'s ``--mode sim``.

``--algo ampere`` (and the ``ampere-noconsolidation`` ablation) runs the
phases in the order ``AmpereSystem.run`` drives them (device phase,
one-shot activation generation, server phase, merge); ``fedavg`` and the
SFL baselines (``splitfed``, ``splitfedv2``, ``splitgp``, ``scaffold``,
``pipar``) run ``--device-rounds`` rounds of their trainer.  Prints the
reference's final JSON summary: the last server record (the last round
for a baseline), ``comm_bytes`` (device-server bytes, analytic) and
``sim_time_s`` (the testbed's simulated wall clock).  ``--workdir`` keeps
checkpoints (every ``--checkpoint-every`` rounds and epochs), the round
journal, the metrics log and Ampere's activation shards there; a rerun
with the same workdir resumes.  ``--quantize-acts`` stores and uploads
int8 activations.  ``--arch`` takes the LM archs and the paper's vision
classifiers (``mobilenet-l``, the default, ``vgg11``, ``vit-s``,
``swin-t``; ``--seq-len`` is an LM option).  Runs on CUDA unless
``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --algo ampere --device-rounds 2 --server-epochs 2 --seq-len 32
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --algo splitfed --device-rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mobilenet-l \\
      --smoke --device cpu --device-rounds 2 --server-epochs 2 \\
      --quantize-acts
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --device-rounds 1 --server-epochs 1 \\
      --workdir /tmp/ampere --checkpoint-every 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (FedConfig, OptimConfig, RunConfig,
                                      SplitConfig)
from repro_torch.core.baselines import FedAvgTrainer, SFLTrainer
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import (ActivationStore, federate,
                              make_dataset_for_model)
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def build_run_cfg(args) -> RunConfig:
    return RunConfig(
        arch=args.arch,
        algo=args.algo,
        split=SplitConfig(split_point=args.split_point,
                          aux_ratio=args.aux_ratio,
                          quantize_activations=args.quantize_acts),
        fed=FedConfig(num_clients=args.clients,
                      clients_per_round=args.cohort,
                      local_steps=args.local_steps,
                      device_batch_size=args.batch_size,
                      server_batch_size=args.server_batch,
                      dirichlet_alpha=args.alpha,
                      drop_prob=args.drop_prob,
                      straggler_deadline_factor=args.deadline,
                      seed=args.seed),
        optim=OptimConfig(name=args.optimizer, lr=args.lr,
                          schedule="inverse_time", decay_gamma=0.005),
        checkpoint_dir=args.workdir or "",
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # staticcheck: ok=wall-clock the reported phase walls, never sim state
    return time.perf_counter()


def run_training(cfg, run_cfg, train, evald, *, device=None,
                 device_rounds=None, server_epochs=None,
                 log_echo: bool = False, workdir=None,
                 patience: int = 15) -> dict:
    """The launcher's whole path after argument parsing: federate ``train``,
    init and split, device phase, activation generation, server phase,
    merge.  Returns the history (the reference trainer's keys: ``device``,
    ``server``, ``comm_bytes``, ``sim_time``), the states, the merged
    params, the store and the wall seconds of each phase (host clock
    around synchronized work)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    clients = federate(train, run_cfg.fed.num_clients,
                       run_cfg.fed.dirichlet_alpha, seed=run_cfg.seed)
    trainer = AmpereTrainer(model, run_cfg, clients, evald, workdir=workdir,
                            patience=patience, log_echo=log_echo,
                            device=dev)
    # a CPU generator: one seed gives the same init on any device, as in
    # run_experiment
    gen = torch.Generator().manual_seed(run_cfg.seed)
    seconds, t0 = {}, [_sync(dev)]

    def lap(name):
        t1 = _sync(dev)
        seconds[name], t0[0] = t1 - t0[0], t1

    dev_params, srv_params, aux_params = trainer._init_states(gen)
    dev_state = {"device": dev_params, "aux": aux_params}
    lap("init")
    dev_state = trainer.run_device_phase(dev_state, device_rounds)
    lap("device")
    store = ActivationStore(
        directory=os.path.join(workdir, "acts") if workdir else None,
        quantize_int8=run_cfg.split.quantize_activations, seed=run_cfg.seed)
    store = trainer.generate_activations(dev_state, store)
    lap("transfer")
    srv_state = trainer.run_server_phase(dev_state, srv_params, store,
                                         server_epochs)
    lap("server")
    merged = trainer.merged_params(dev_state, srv_state["server"])
    trainer.runner.close()
    return {"history": trainer.history, "device_state": dev_state,
            "server_state": srv_state, "merged_params": merged,
            "store": store, "seconds": seconds}


def run_baseline(cfg, run_cfg, train, evald, *, device=None, rounds=None,
                 log_echo: bool = False, workdir=None,
                 patience: int = 15) -> dict:
    """``run_cfg.algo``'s baseline (``fedavg`` or an SFL variant) for
    ``rounds`` rounds (``fed.device_epochs`` by default) from a CPU
    generator seeded from ``run_cfg.seed``: the trainer's result and the
    wall seconds of the init and of the rounds (host clock around
    synchronized work)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    clients = federate(train, run_cfg.fed.num_clients,
                       run_cfg.fed.dirichlet_alpha, seed=run_cfg.seed)
    if run_cfg.algo == "fedavg":
        trainer = FedAvgTrainer(model, run_cfg, clients, evald,
                                workdir=workdir, patience=patience,
                                log_echo=log_echo, device=dev)
    else:
        trainer = SFLTrainer(model, run_cfg, clients, evald,
                             variant=run_cfg.algo, workdir=workdir,
                             patience=patience, log_echo=log_echo, device=dev)
    gen = torch.Generator().manual_seed(run_cfg.seed)
    t0 = _sync(dev)
    init = [trainer._init_params(gen) if run_cfg.algo == "fedavg"
            else trainer._init_state(gen)]
    t1 = _sync(dev)
    out = trainer.run_rounds(
        rounds if rounds is not None else run_cfg.fed.device_epochs,
        init=init)
    out["seconds"] = {"init": t1 - t0, "rounds": _sync(dev) - t1}
    trainer.runner.close()
    return out


ALGOS = ["ampere", "ampere-noconsolidation", "splitfed", "splitfedv2",
         "splitgp", "scaffold", "pipar", "fedavg"]


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mobilenet-l",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--algo", default="ampere", choices=ALGOS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--split-point", type=int, default=1)
    ap.add_argument("--aux-ratio", type=float, default=0.5)
    ap.add_argument("--quantize-acts", action="store_true",
                    help="int8 activation payloads (one scale a row)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--server-batch", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.33)
    ap.add_argument("--drop-prob", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--optimizer", default="momentum")
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--device-rounds", type=int, default=30)
    ap.add_argument("--server-epochs", type=int, default=10)
    ap.add_argument("--train-samples", type=int, default=2048)
    ap.add_argument("--eval-samples", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--patience", type=int, default=15)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    model = build_model(cfg)
    train = make_dataset_for_model(model, args.train_samples,
                                   seq_len=args.seq_len, seed=args.seed)
    evald = make_dataset_for_model(model, args.eval_samples,
                                   seq_len=args.seq_len, seed=args.seed + 1)
    kw = dict(device=args.device, log_echo=not args.quiet,
              workdir=args.workdir, patience=args.patience)
    if args.algo.startswith("ampere"):
        # ampere-noconsolidation runs Ampere itself: the reference's flag
        # picks the same whole pool either way (ROADMAP C4)
        out = run_training(cfg, build_run_cfg(args), train, evald,
                           device_rounds=args.device_rounds,
                           server_epochs=args.server_epochs, **kw)
        records = out["history"]["server"]
    else:
        out = run_baseline(cfg, build_run_cfg(args), train, evald,
                           rounds=args.device_rounds, **kw)
        records = out["history"]["rounds"]
    hist = out["history"]
    summary = {"arch": args.arch, "algo": args.algo,
               "final": records[-1] if records else {},
               "comm_bytes": hist.get("comm_bytes", 0),
               "sim_time_s": hist.get("sim_time", 0.0)}
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
