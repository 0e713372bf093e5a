#!/usr/bin/env python3
"""Learning-rate probe of the PyTorch/CUDA port's main path on one NVIDIA
GPU: does the merged model train at full width, and at which rate?

Runs a main path of ``chip_smoke.py`` (full-width qwen3-1.7b or
mamba2-370m, random init from seed 0, the same corpus, sequence length,
clients, batches and rounds, one server epoch) at lr 0.2 (the launcher's
default), 0.05 and 0.02.  For each it prints one JSON line: the device history, the server phase's per-step losses, and the
merged model's loss and accuracy on the eval samples and on 8 of its own
training samples.  First it prints the merged model at init and ln V.
From the repository root:

  python3 scripts/torch_lr_probe.py
  python3 scripts/torch_lr_probe.py --arch mamba2-370m
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
from repro_torch.configs import registry  # noqa: E402
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
    args = ap.parse_args(argv)
    seq = cs.MAIN_PATHS[args.arch]["seq"]
    if not torch.cuda.is_available():
        print("torch_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    cfg = registry.get_config(args.arch)
    model = build_model(cfg)
    merged_model = build_model(splitting.merged_config(model))
    train = cs.full_corpus(cs.TRAIN_SAMPLES, seq, cfg.vocab_size, 0)
    evald = cs.full_corpus(cs.EVAL_SAMPLES, seq, cfg.vocab_size, 1)
    seen = Dataset({k: v[:8] for k, v in train.arrays.items()},
                   train.labels[:8])
    print(json.dumps({"card": cs.card_line(), "arch": args.arch, "seq": seq,
                      "ln_V": math.log(cfg.vocab_size)}), flush=True)

    def merged_eval(trainer, dev_state, server_params):
        merged = trainer.merged_params(dev_state, server_params)
        return {"eval": evaluate.evaluate(merged_model, merged, evald, dev),
                "train": evaluate.evaluate(merged_model, merged, seen, dev)}

    for lr in LRS:
        largv = ["--arch", args.arch, "--clients", "4", "--cohort", "2",
                 "--local-steps", "2", "--batch-size", "4",
                 "--server-batch", "8", "--seq-len", str(seq),
                 "--lr", str(lr), "--seed", "0"]
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
        if lr == LRS[0]:
            print(json.dumps({"init": merged_eval(tr, dev_state, sp)}),
                  flush=True)
        dev_state = tr.run_device_phase(dev_state, cs.DEVICE_ROUNDS)
        store = tr.generate_activations(dev_state,
                                        ActivationStore(seed=run_cfg.seed))
        # the body of run_server_phase for one epoch, keeping each step's loss
        state = steps.init_server_state(model, run_cfg, sp)
        pool = tr._tensors(store.pool())
        idx = torch.as_tensor(store.epoch_indices(fed.server_batch_size),
                              dtype=torch.long, device=dev)
        state, step_losses = tr._server_epoch(state, pool, idx)
        print(json.dumps({"lr": lr, "device": tr.history["device"],
                          "server_step_losses": step_losses.tolist(),
                          "merged": merged_eval(tr, dev_state,
                                                state["server"])}),
              flush=True)
        del tr, dp, sp, ap, dev_state, store, state, pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
