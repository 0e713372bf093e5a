#!/usr/bin/env python3
"""Where the xent tensor-core kernels spend their time, on one NVIDIA GPU.

At the server heads of both main paths (qwen3-1.7b: T 8 x 511, D 2048,
V 151936, untied; mamba2-370m: T 8 x 2047, D 1024, V 50280, tied), with a
bf16 h, times (CUDA events, median of ``chip_smoke.REPEATS`` after
``chip_smoke.WARMUP`` calls, range beside it):
- the split pre-passes alone (fp32 w -> W_hi, W_lo; fp32 h -> H_hi, H_lo);
- ``xent_fwd`` and ``xent_bwd`` with an fp32 w (2 and 7 bf16 passes) and
  with the same w rounded to bf16 (1 and 5 passes: no W_lo);
- the same with h in fp32 (h split into hi/lo: 3 and 9 passes with an
  fp32 w, 2 and 7 with a bf16 w).
A kernel bound by its tensor-core work halves its forward time without
W_lo; one bound by the operand bytes it moves through L2 and shared
memory keeps about two thirds of it (h, W_hi, W_lo -> h, W_hi).  Prints
the card line, then one JSON line per shape.  From the repository root:

  python3 scripts/torch_xent_probe.py
"""

from __future__ import annotations

import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.xent import kernel as XK  # noqa: E402

SHAPES = {"qwen3-1.7b": (8 * 511, 2048, 151936, False),
          "mamba2-370m": (8 * 2047, 1024, 50280, True)}
ITERS = 2


def _time_pair(out, prefix, h, w, lab, lse, g):
    for name, ww in (("fp32_w", w), ("bf16_w", w.to(torch.bfloat16))):
        for kind, fn in (("fwd", lambda: XK.xent_fwd(h, ww, lab)),
                         ("bwd", lambda: XK.xent_bwd(h, ww, lab, lse, g))):
            ms, rng = cs.time_median(fn, ITERS)
            out[f"{kind}_{prefix}{name}"] = {"ms": ms, "ms_range": rng}


def probe(dev, T, D, V, tied):
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((V, D) if tied else (D, V), generator=gen,
                    device=dev) / math.sqrt(D)
    w = w.t() if tied else w
    lab = torch.randint(0, V, (T,), generator=gen, device=dev,
                        dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device=dev)
    _, lse = XK.xent_fwd(h, w, lab)
    lib, stream = build.load(), build.stream_ptr(h)
    out = {}
    ms, rng = cs.time_median(lambda: XK._launch_split(lib, stream, w), ITERS)
    out["split_fp32_w"] = {"ms": ms, "ms_range": rng}
    _time_pair(out, "", h, w, lab, lse, g)
    # the fp32 h last, so that no fp32 copy of h is allocated while the
    # bf16-h rows above run
    h32 = h.float()
    ms, rng = cs.time_median(lambda: XK._launch_split_h(lib, stream, h32),
                             ITERS)
    out["split_fp32_h"] = {"ms": ms, "ms_range": rng}
    _time_pair(out, "fp32_h_", h32, w, lab, lse, g)
    for kind in ("fwd", "bwd"):
        out[f"{kind}_bf16_over_fp32_w"] = (out[f"{kind}_bf16_w"]["ms"]
                                          / out[f"{kind}_fp32_w"]["ms"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_xent_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    for arch, (T, D, V, tied) in SHAPES.items():
        print(json.dumps({"arch": arch, "T": T, "D": D, "V": V, "tied": tied,
                          "iters": ITERS, "repeats": cs.REPEATS,
                          **probe(dev, T, D, V, tied)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
