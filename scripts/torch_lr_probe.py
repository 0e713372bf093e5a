#!/usr/bin/env python3
"""Learning-rate probe of the PyTorch/CUDA port's main path on one NVIDIA
GPU: does the merged model train at full width, and at which rate?

Runs a main path of ``chip_smoke.py`` (full-width qwen3-1.7b, mamba2-370m,
gemma2-2b, granite-moe-3b-a800m or musicgen-large at the main path's
depth, random init from seed 0, the same corpus, sequence length,
samples, clients, batches and rounds, one server epoch) at lr 0.2 (the
launcher's default), 0.05 and 0.02, or at the rates ``--lrs`` names.
For each it prints one JSON line: the device history, the server
phase's per-step losses, the merged model's loss and accuracy on the
eval samples and on (at most) 8 of its own training samples, and the
card's peak memory over the run.
First it prints the merged model at init and ln V.
From the repository root:

  python3 scripts/torch_lr_probe.py
  python3 scripts/torch_lr_probe.py --arch mamba2-370m
  python3 scripts/torch_lr_probe.py --arch gemma2-2b
  python3 scripts/torch_lr_probe.py --arch musicgen-large
  python3 scripts/torch_lr_probe.py --arch granite-moe-3b-a800m --lrs 0.05 0.02
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.core import evaluate, splitting, steps  # noqa: E402
from repro_torch.core.uit import AmpereTrainer  # noqa: E402
from repro_torch.data import ActivationStore, Dataset, federate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

LRS = (0.2, 0.05, 0.02)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    choices=sorted(cs.MAIN_PATHS))
    ap.add_argument("--lrs", type=float, nargs="+", default=LRS)
    args = ap.parse_args(argv)
    spec = cs.MAIN_PATHS[args.arch]
    seq = spec["seq"]
    if not torch.cuda.is_available():
        print("torch_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)        # a CUDA context for the peak stats
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    cfg = cs.main_config(args.arch)
    model = build_model(cfg)
    merged_model = build_model(splitting.merged_config(model))
    train = cs.full_corpus(spec["samples"], seq, cfg.vocab_size, 0)
    evald = cs.full_corpus(spec["eval_samples"], seq, cfg.vocab_size, 1)
    seen = Dataset({k: v[:8] for k, v in train.arrays.items()},
                   train.labels[:8])
    print(json.dumps({"card": cs.card_line(), "arch": args.arch, "seq": seq,
                      "layers": cfg.num_layers,
                      "ln_V": math.log(cfg.vocab_size)}), flush=True)

    def merged_eval(trainer, dev_state, server_params):
        merged = trainer.merged_params(dev_state, server_params)
        return {"eval": evaluate.evaluate(merged_model, merged, evald, dev),
                "train": evaluate.evaluate(merged_model, merged, seen, dev)}

    for lr in args.lrs:
        largv = ["--arch", args.arch, "--clients", "4", "--cohort", "2",
                 "--local-steps", "2", "--batch-size", str(spec["batch"]),
                 "--server-batch", str(spec["server_batch"]),
                 "--seq-len", str(seq), "--lr", str(lr), "--seed", "0"]
        torch.cuda.reset_peak_memory_stats(dev)
        run_cfg = launch_train.build_run_cfg(
            launch_train.make_parser().parse_args(largv))
        fed = run_cfg.fed
        tr = AmpereTrainer(model, run_cfg,
                           federate(train, fed.num_clients,
                                    fed.dirichlet_alpha, seed=run_cfg.seed),
                           evald, device=dev)
        # the launcher's init: a CPU generator seeded as the run
        dp, sp, ap = tr._init_states(
            torch.Generator().manual_seed(run_cfg.seed))
        dev_state = {"device": dp, "aux": ap}
        del dp, ap
        if lr == args.lrs[0]:
            print(json.dumps({"init": merged_eval(tr, dev_state, sp)}),
                  flush=True)
        dev_state = tr.run_device_phase(dev_state, cs.DEVICE_ROUNDS)
        store = tr.generate_activations(dev_state,
                                        ActivationStore(seed=run_cfg.seed))
        # the body of run_server_phase for one epoch, keeping each step's loss
        # (the state handed over as run_server_phase hands it: no frame here
        # holds the initial state while the epoch makes new ones)
        held = [steps.init_server_state(model, run_cfg, sp)]
        del sp
        pool = tr._tensors(store.pool())
        idx = torch.as_tensor(store.epoch_indices(fed.server_batch_size),
                              dtype=torch.long, device=dev)
        state, step_losses = tr._server_epoch(held.pop(), pool, idx)
        print(json.dumps({"lr": lr, "device": tr.history["device"],
                          "server_step_losses": step_losses.tolist(),
                          "merged": merged_eval(tr, dev_state,
                                                state["server"]),
                          "peak_mem_gib":
                              torch.cuda.max_memory_allocated(dev) / 2 ** 30}),
              flush=True)
        del tr, dev_state, store, state, pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
