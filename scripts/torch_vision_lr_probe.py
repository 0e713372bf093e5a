#!/usr/bin/env python3
"""Learning-rate probe of the PyTorch/CUDA port's vision phase on one
NVIDIA GPU: at which rate does each of the paper's classifiers train in
``chip_smoke.py``'s vision run?

Runs ``chip_smoke.vision_run`` (the published config, 512 training and
128 eval samples, quickstart's federation, 2 device rounds, random init
from seed 0; ``--epochs`` server epochs, ``chip_smoke.VISION_EPOCHS`` by
default) for each arch at each rate of ``--lr`` (from the launcher's
default 0.2 down to 0.0005), and prints one JSON line each: the device and
server histories (loss, merged val loss and accuracy per epoch) and the
wall seconds of each phase.  First it prints the card and ln(classes).
The precision is the port's own (``repro_torch.device.pin_fp32``).  From
the repository root:

  python3 scripts/torch_vision_lr_probe.py
  python3 scripts/torch_vision_lr_probe.py --arch vit-s swin-t \
      --lr 0.005 0.001 --epochs 8
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

LRS = (0.2, 0.1, 0.05, 0.02, 0.01, 0.005, 0.002, 0.001, 0.0005)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(cs.VISION_ARCHS),
                    choices=cs.VISION_ARCHS)
    ap.add_argument("--lr", nargs="+", type=float, default=list(LRS))
    ap.add_argument("--epochs", type=int, default=cs.VISION_EPOCHS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_vision_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    print(json.dumps({"card": cs.card_line(), "ln_classes": math.log(10)}),
          flush=True)
    for arch in args.arch:
        for lr in args.lr:
            _, out, _ = cs.vision_run(dev, arch, lr, args.epochs)
            hist = out["history"]
            print(json.dumps({"arch": arch, "lr": lr,
                              "seconds": out["seconds"],
                              "device": hist["device"],
                              "server": hist["server"]}, default=float),
                  flush=True)
            del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
