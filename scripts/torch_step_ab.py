#!/usr/bin/env python3
"""One server train step of a main path, from several source trees, in
turns on one card: ``python3 scripts/torch_step_ab.py --arch mamba2-370m
TREE [TREE ...]`` (e.g. the parent commit unpacked with ``git archive``,
then this tree, this tree again, the parent again).

Each TREE is the root of a checkout that has ``chip_smoke.py`` and
``src/repro_torch``; each runs in its own process, so each imports (and
builds) its own kernels.  The step is ``chip_smoke.server_step_inputs``'s
(8 sequences at the path's length, seeded weights and batch) through
``steps.make_server_train_step(impl="kernel")``: one untimed step, then
the tree's ``chip_smoke.PROFILE_STEPS`` steps timed with CUDA events, as
its profile phase times them.  Prints one JSON line per tree:
the median step time and its range, the peak memory of the timed steps,
the loss of the first step and the card (nvidia-smi name, power limit).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.core import steps
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
model, run_cfg, srv, batch = cs.server_step_inputs(dev, {arch!r})
step = steps.make_server_train_step(model, run_cfg, impl="kernel")
state = steps.init_server_state(model, run_cfg, srv)
del srv
state, m = step(state, batch)
loss = float(m["loss"])
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats(dev)
ms = []
for _ in range(cs.PROFILE_STEPS):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state, _ = step(state, batch)
    end.record()
    end.synchronize()
    ms.append(start.elapsed_time(end))
print(json.dumps({{"tree": {root!r}, "arch": {arch!r},
                  "step_ms": float(np.median(ms)),
                  "step_ms_range": [min(ms), max(ms)],
                  "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                  "first_loss": loss, "card": cs.card_line()}}), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    rc = 0
    for tree in args.trees:
        root = os.path.abspath(tree)
        r = subprocess.run([sys.executable, "-c", CHILD.format(
            root=root, arch=args.arch)], cwd=root, capture_output=True,
            text=True)
        lines = r.stdout.strip().splitlines()
        if r.returncode or not lines:
            print(json.dumps({"tree": root, "rc": r.returncode,
                              "stderr": r.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
