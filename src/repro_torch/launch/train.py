"""Training launcher: Ampere static-cut training on synthetic non-IID data.

Runs the phases in the order ``AmpereSystem.run`` drives them (device
phase, one-shot activation generation, server phase, merge) and prints the
final JSON summary of ``repro.launch.train`` (without ``comm_bytes`` and
``sim_time_s`` until the comm model is ported).  Runs on CUDA unless
``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --algo ampere --device-rounds 2 --server-epochs 2 --seq-len 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --device-rounds 1 --server-epochs 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (FedConfig, OptimConfig, RunConfig,
                                      SplitConfig)
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
                          aux_ratio=args.aux_ratio),
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
        seed=args.seed,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_training(cfg, run_cfg, train, evald, *, device=None,
                 device_rounds=None, server_epochs=None,
                 log_echo: bool = False) -> dict:
    """The launcher's whole path after argument parsing: federate ``train``,
    init and split, device phase, activation generation, server phase,
    merge.  Returns the history, the states, the merged params and the
    wall seconds of each phase (host clock around synchronized work)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    clients = federate(train, run_cfg.fed.num_clients,
                       run_cfg.fed.dirichlet_alpha, seed=run_cfg.seed)
    trainer = AmpereTrainer(model, run_cfg, clients, evald, device=dev,
                            log_echo=log_echo)
    gen = torch.Generator(device=dev).manual_seed(run_cfg.seed)
    seconds, t0 = {}, [_sync(dev)]

    def lap(name):
        t1 = _sync(dev)
        seconds[name], t0[0] = t1 - t0[0], t1

    dev_params, srv_params, aux_params = trainer._init_states(gen)
    dev_state = {"device": dev_params, "aux": aux_params}
    lap("init")
    dev_state = trainer.run_device_phase(dev_state, device_rounds)
    lap("device")
    store = trainer.generate_activations(dev_state,
                                         ActivationStore(seed=run_cfg.seed))
    lap("transfer")
    srv_state = trainer.run_server_phase(dev_state, srv_params, store,
                                         server_epochs)
    lap("server")
    merged = trainer.merged_params(dev_state, srv_state["server"])
    return {"history": trainer.history, "device_state": dev_state,
            "server_state": srv_state, "merged_params": merged,
            "store": store, "seconds": seconds}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=registry.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--algo", default="ampere", choices=["ampere"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--split-point", type=int, default=1)
    ap.add_argument("--aux-ratio", type=float, default=0.5)
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
    out = run_training(cfg, build_run_cfg(args), train, evald,
                       device=args.device, device_rounds=args.device_rounds,
                       server_epochs=args.server_epochs,
                       log_echo=not args.quiet)
    hist = out["history"]
    summary = {"arch": args.arch, "algo": args.algo,
               "final": hist["server"][-1] if hist["server"] else {}}
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
