#!/usr/bin/env python3
"""The attention kernels at the qwen3-1.7b server shape, from several source
trees, in turns on one card: ``python3 scripts/torch_fa_ab.py TREE [TREE
...]`` (e.g. the parent commit unpacked with ``git archive``, then this
tree, this tree again, the parent again).

Each TREE is the root of a checkout that has ``chip_smoke.py`` and
``src/repro_torch``; each runs in its own process, so each imports (and
builds) its own kernels.  At B 8, S 512, Hkv 8, G 2, hd 128, causal, with
inputs from seed 0: ``flash_fwd``, ``flash_bwd_fused``, ``flash_bwd_dq``
and ``flash_bwd_dkv`` in bf16 and in fp32, each timed with CUDA events
(``chip_smoke.time_median``: the median of its ``REPEATS`` measurements
of ``ITERS_ATTENTION`` calls after ``WARMUP``), and, where the tree has it, the fp32 split pre-pass
alone (``rt_flash_split`` over q, k and v).  Prints one JSON line per
tree with the times (ms, [min, max]) and the card (nvidia-smi name,
power limit).  ``--sass DIR`` also writes ``cuobjdump -sass`` of the
attention kernels (functions whose names hold ``fa_``) of each tree's
library to DIR/<n>.sass.gz, n the tree's place on the command line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import sys

CHILD = r"""
import json, math, sys
import torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as FK
dev = torch.device("cuda", 0)
B, S, Hkv, G, hd = 8, 512, 8, 2, 128
kw = dict(group=G, causal=True, window=0, softcap=0.0,
          scale=1 / math.sqrt(hd), kv_len=S)
out = {{"tree": {root!r}}}
for dt in (torch.bfloat16, torch.float32):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
               for s in ((B * Hkv * G, S, hd), (B * Hkv, S, hd),
                         (B * Hkv, S, hd)))
    o, lse = FK.flash_fwd(q, k, v, **kw)
    do = torch.randn(o.shape, generator=gen, device=dev)
    delta = torch.sum(do * o, dim=-1)
    do_q = do.to(dt)
    delta_q = torch.sum(do_q.float() * o, dim=-1)
    fns = {{"flash_fwd": lambda: FK.flash_fwd(q, k, v, **kw),
           "flash_bwd_fused": lambda: FK.flash_bwd_fused(
               q, k, v, do, lse, delta, **kw),
           "flash_bwd_dq": lambda: FK.flash_bwd_dq(
               q, k, v, do_q, lse, delta_q, **kw),
           "flash_bwd_dkv": lambda: FK.flash_bwd_dkv(
               q, k, v, do_q, lse, delta_q, **kw)}}
    lib = build.load()
    if dt == torch.float32 and hasattr(lib, "rt_flash_split"):
        planes = torch.empty(3 * (q.numel() + 2 * k.numel()),
                             dtype=torch.bfloat16, device=dev)
        stream = build.stream_ptr(q)

        def split():
            at = planes.data_ptr()
            for t in (q, k, v):
                build.check(lib, lib.rt_flash_split(
                    t.data_ptr(), at, t.numel(), 3, stream), "split")
                at += 3 * t.numel() * 2
        fns["split_prepass"] = split
    tag = str(dt).removeprefix("torch.")
    for name, fn in fns.items():
        out[f"{{name}}_{{tag}}"] = cs.time_median(fn, cs.ITERS_ATTENTION)
    del q, k, v, o, lse, do, delta, do_q, delta_q, fns
    torch.cuda.empty_cache()
out["library"] = str(build.library_path())
out["card"] = cs.card_line()
print(json.dumps(out), flush=True)
"""


def attention_sass(lib: str) -> str:
    """``cuobjdump -sass`` of the library, cut to the attention kernels'
    functions."""
    cuobjdump = os.path.join(os.path.dirname(
        os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"(?m)^(?=\s*Function : )", text)
    return "".join(p for p in parts
                   if p.lstrip().startswith("Function : ")
                   and "fa_" in p.splitlines()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="directory for each tree's SASS")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    rc = 0
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        r = subprocess.run([sys.executable, "-c", CHILD.format(root=root)],
                           cwd=root, capture_output=True, text=True)
        lines = r.stdout.strip().splitlines()
        if r.returncode or not lines:
            print(json.dumps({"tree": root, "rc": r.returncode,
                              "stderr": r.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            sass = attention_sass(json.loads(lines[-1])["library"])
            with gzip.open(os.path.join(args.sass, f"{i}.sass.gz"),
                           "wt") as f:
                f.write(sass)
    return rc


if __name__ == "__main__":
    sys.exit(main())
