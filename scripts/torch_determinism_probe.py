#!/usr/bin/env python3
"""Card only: do PyTorch's deterministic settings make the port's runs
repeat bit for bit on the card, and what do they cost in server step
time?

Three modes, each in a process of its own (the settings are
process-wide), run in turns (``MODES``) so that a drift of the card's
clock shows: ``unpinned``, PyTorch's defaults (the port's
``device.pin_deterministic`` replaced by a no-op); ``pinned``, the port
as it is (``torch.backends.cudnn.deterministic = True``); ``all``, that
and ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS needs it for deterministic
results).  In each:

1. the published mobilenet-l through ``launch.train.run_training``
   ``REPEATS`` times (``chip_smoke.py``'s vision federation, samples and
   ``VISION_LR``, 2 rounds, ``EPOCHS`` server epochs): are the histories
   identical?
2. ``chip_smoke.py``'s experiment spec (qwen3-1.7b smoke, checkpoints
   every round and epoch) through ``run_experiment`` twice, and once
   killed after device round 0 and resumed: are the three histories
   identical?
3. one server train step, the median of ``STEPS`` after two untimed ones
   (CUDA events): mobilenet-l at batch 32 and qwen3-1.7b at 8 x 512.

An operation without a deterministic implementation raises in the
deterministic mode; the line then names it.  Prints one JSON line per mode
and the card's name and power limit.

    python3 scripts/torch_determinism_probe.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as C  # noqa: E402
from repro_torch import device as port_device  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import splitting, steps  # noqa: E402
from repro_torch.experiments import (AmpereSystem, SystemContext,  # noqa: E402
                                     resolve_setup, run_experiment)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MODES = ("unpinned", "pinned", "all", "all", "pinned", "unpinned")
REPEATS = 3
EPOCHS = 4
STEPS = 5


def step_ms(step, state, batch) -> float:
    for _ in range(2):
        state, _ = step(state, batch)
    times = []
    for _ in range(STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, _ = step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def vision_step_ms(dev) -> float:
    arch = "mobilenet-l"
    run_cfg = launch_train.build_run_cfg(launch_train.make_parser().parse_args(
        ["--arch", arch, *C.VISION_ARGS, "--lr", str(C.VISION_LR[arch])]))
    model = build_model(registry.get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    _, srv = splitting.split_params(model, model.init(gen, dev),
                                    run_cfg.split.split_point)
    bs = run_cfg.fed.server_batch_size
    shape = model.activation_spec(bs, split_point=run_cfg.split.split_point,
                                  dtype="float32").shape
    batch = {"acts": torch.randn(shape, generator=gen, device=dev),
             "labels": torch.randint(0, 10, (bs,), generator=gen, device=dev,
                                     dtype=torch.int32)}
    return step_ms(steps.make_server_train_step(model, run_cfg),
                   steps.init_server_state(model, run_cfg, srv), batch)


def lm_step_ms(dev) -> float:
    model, run_cfg, srv, batch = C.server_step_inputs(dev, "qwen3-1.7b")
    state = steps.init_server_state(model, run_cfg, srv)
    del srv
    return step_ms(steps.make_server_train_step(model, run_cfg), state,
                   batch)


def experiment_runs(dev) -> list:
    """Two uninterrupted card runs and one killed after round 0 and
    resumed."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("a", "b"):
            res = run_experiment(C.experiment_spec(os.path.join(tmp, name)),
                                 device=dev)
            out.append(res["results"]["ampere"]["history"])
        spec, model, clients, evald = resolve_setup(
            C.experiment_spec(os.path.join(tmp, "killed")))
        ctx = SystemContext(model=model, run_cfg=spec.run, clients=clients,
                            eval_data=evald,
                            workdir=os.path.join(spec.results_dir, "ampere"),
                            patience=spec.patience, device=dev)
        dev_state, _ = AmpereSystem().init_state(ctx)
        ctx.trainer.run_device_phase(dev_state, 1)      # killed here
        ctx.trainer.runner.close()
        res = run_experiment(spec, device=dev)
        out.append(res["results"]["ampere"]["history"])
    return out


def attempt(result: dict, key: str, fn):
    """``result[key] = fn()``, or the error an operation raised."""
    try:
        result[key] = fn()
    except RuntimeError as e:
        result[key] = {"error": str(e)[:400]}


def run_mode(mode: str) -> dict:
    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)      # the allocator's statistics exist
    if mode == "unpinned":
        port_device.pin_deterministic = lambda: None
    else:
        port_device.pin_deterministic()
    if mode == "all":
        torch.use_deterministic_algorithms(True)
    res = {"mode": mode, "cudnn_deterministic":
           torch.backends.cudnn.deterministic,
           "deterministic_algorithms":
           torch.are_deterministic_algorithms_enabled()}

    def vision():
        hists = [C.vision_run(dev, "mobilenet-l", C.VISION_LR["mobilenet-l"],
                              epochs=EPOCHS)[1]["history"]
                 for _ in range(REPEATS)]
        return {"identical": all(h == hists[0] for h in hists[1:]),
                "val_loss": [[r["val_loss"] for r in h["server"]]
                             for h in hists]}

    def experiment():
        a, b, resumed = experiment_runs(dev)
        return {"repeat_identical": a == b, "resumed_identical": resumed == a,
                "server_val_loss": [[r["val_loss"] for r in h["server"]]
                                    for h in (a, b, resumed)]}

    attempt(res, "mobilenet_l_repeats", vision)
    torch.cuda.empty_cache()
    attempt(res, "experiment", experiment)
    torch.cuda.empty_cache()
    attempt(res, "mobilenet_l_step_ms", lambda: vision_step_ms(dev))
    torch.cuda.empty_cache()
    attempt(res, "qwen3_step_ms", lambda: lm_step_ms(dev))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_determinism_probe: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--mode":
        print(json.dumps(run_mode(sys.argv[2]), default=float), flush=True)
        return 0
    for mode in MODES:
        env = dict(os.environ)
        if mode == "all":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        subprocess.run([sys.executable, os.path.abspath(__file__), "--mode",
                        mode], env=env, check=True)
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
