#!/usr/bin/env python3
"""Where the SSD kernels' time goes, on one card: ``python3
scripts/torch_ssd_probe.py [cut ...]`` from the repository root.

Times ``ssd_intra`` and ``ssd_intra_bwd`` at the mamba2-370m server shape
(B 8, nc 8, Q 256, H 32, P 64, N 128; ``chip_smoke.ssd_case``'s inputs)
per kernel (``torch.profiler``, 10 calls after 3) and as a whole (CUDA
events, 20 calls), first as the checkout has it (``none``), then for each
variant named (all of ``CUTS`` without names): a copy of ``src/`` under
``build/ssd_probe/<cut>/`` whose ``csrc/ssd_chunk.cu`` lacks one part of
the work (or, for ``split_rn``, does it another way), built into its own
library.  A cut kernel computes wrong outputs; only its time is read, and
the difference from ``none`` is what that part costs where the others
stay (a cut also drops the work the compiler finds dead without it).
The variants build in parallel, then run one after another, each in its
own process.  Prints one JSON line per variant (ms per call by kernel,
each whole call's ms) and the card line (nvidia-smi name, power limit).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = Path("repro_torch/csrc/ssd_chunk.cu")
# variant name -> (text of ssd_chunk.cu, what replaces it), or (another
# source under csrc/, text, replacement); each text must occur exactly
# once.  Most variants cut a part; split_rn instead splits the forward's
# operands with round-to-nearest conversions in place of bit masks.
CUTS = {
    "split_rn": ("tensor_core.cuh", """  constexpr uint32_t kTop = 0xffff0000u;
  const uint32_t ua = f32_bits(a), ub = f32_bits(b);
  hi = (ua >> 16) | (ub & kTop);
  const float ra = a - bits_f32(ua & kTop), rb = b - bits_f32(ub & kTop);
  const uint32_t va = f32_bits(ra), vb = f32_bits(rb);
  mid = (va >> 16) | (vb & kTop);
  const float sa = ra - bits_f32(va & kTop), sb = rb - bits_f32(vb & kTop);
  lo = (f32_bits(sa) >> 16) | (f32_bits(sb) & kTop);
""", """  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(ra - mf.x, rb - mf.y));
"""),
    # ssd_y_kernel: part 1's C.B^T product; forming A; the A x products
    # (with A's split); x_j's loads, split and store
    "y_cb_product": ("warp_mma<false, false, kFwd>(acc, sOp + c * kTile,",
                     "if (false) warp_mma<false, false, kFwd>(acc, "
                     "sOp + c * kTile,"),
    "y_elementwise": (
        "if (full || (j0 + jj + e % 2 <= q0 + qq && q0 + qq < Q))",
        "if (false)"),
    "y_product": ("mma_passes<kFwd, 2>(f, af, bf);",
                  "for (auto& r : f) for (float& e : r) e = 0.f;"),
    "y_x_store": (
        "    tile_store<kHalf, kFwd>(sOp + (2 * hf + b) * kTile, v);\n", ""),
    # ssd_state_kernel: the state product; w x's loads, split and store
    "state_product": ("warp_mma_2x(acc, sX + (2 * (s & 1) + hk) * kTile,",
                      "if (false) warp_mma_2x(acc, sX + (2 * (s & 1) + hk) "
                      "* kTile,"),
    "state_x_store": (
        "      tile_store<kThreads, kFwd>(sX + (2 * (s & 1) + k) * kTile, "
        "v[k]);\n", ""),
    # ssd_bwd_dx_kernel
    "dx_elementwise": ("if (full || (j0 + jj <= q && q < Q)) {",
                       "if (false) {"),
    "dx_product_dA": (
        "warp_mma<false, false>(da, sX, sDY, m0, qh, ksteps(P));", ""),
    "dx_product_dx": ("if (q0 + qh < Q) {", "if (false) {"),
    "dx_dy_store": ("      tile_store(sDY, v);\n", ""),
    "dx_next_head_loads": ("      else if (h + 1 < h1) load_head(h + 1);\n",
                           ""),
    # ssd_bwd_dbc_kernel
    "dbc_state_product": (
        "warp_mma<false, true, kBwd, false>(acc, sP, sQ, m0, n0, ksteps(P));",
        ""),
}

CHILD = r"""
import json, re, sys
import torch
sys.path.insert(0, {src!r})
from repro_torch.kernels.ssd_chunk import kernel as SK
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(2)
B, nc, Q, H, P, N = 8, 8, 256, 32, 64, 128
x = torch.randn((B, nc, Q, H, P), generator=gen, device=dev)
dt = torch.rand((B, nc, Q, H), generator=gen, device=dev) * 0.1 + 1e-3
a = -(1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev))
a_cum = torch.cumsum(dt * a, dim=2)
bm, cm = (torch.randn((B, nc, Q, N), generator=gen, device=dev)
          for _ in range(2))
dy = torch.randn((B, nc, Q, H, P), generator=gen, device=dev)
ds = torch.randn((B, nc, H, P, N), generator=gen, device=dev)
args = (x, dt, a_cum, bm, cm)
calls = {{"ssd_intra": lambda: SK.ssd_intra_kernel(*args),
          "ssd_intra_bwd": lambda: SK.ssd_intra_bwd_kernel(*args, dy, ds)}}
for fn in calls.values():
    for _ in range(3):
        fn()
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for fn in calls.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
by = {{}}
for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        m = re.search(r"ssd_\w+", e.name)
        name = m.group(0) if m else e.name[:60]
        by[name] = by.get(name, 0.0) + (e.time_range.end
                                        - e.time_range.start) / 1e3 / 10
out = {{"ms_per_call": by}}
for name, fn in calls.items():
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        fn()
    end.record()
    end.synchronize()
    out[name + "_ms"] = start.elapsed_time(end) / 20
print(json.dumps(out), flush=True)
"""


def variant(cut: str) -> Path:
    """The source tree of one variant (the checkout's own for none)."""
    if cut == "none":
        return ROOT / "src"
    src = ROOT / "build" / "ssd_probe" / cut / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src", src)
    spec = CUTS[cut]
    path = src / (SOURCE if len(spec) == 2 else SOURCE.parent / spec[0])
    old, new = spec[-2:]
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"variant {cut}: its text occurs {text.count(old)} "
                         f"times in {path.relative_to(src)}")
    path.write_text(text.replace(old, new))
    return src


def env_for(cut: str, src: Path) -> dict:
    env = dict(os.environ)
    if cut != "none":
        env["REPRO_TORCH_BUILD_DIR"] = str(src.parent / "lib")
    return env


def main() -> int:
    cuts = sys.argv[1:] or list(CUTS)
    unknown = [c for c in cuts if c not in CUTS]
    if unknown:
        raise SystemExit(f"unknown cuts {unknown}; known: {list(CUTS)}")
    srcs = {cut: variant(cut) for cut in ["none", *cuts]}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from repro_torch.kernels import build; build.build()")
    procs = {cut: subprocess.Popen([sys.executable, "-c", build, str(src)],
                                   env=env_for(cut, src),
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for cut, src in srcs.items()}
    failed = {}
    for cut, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed[cut] = log[-2000:]
    rc = 0
    for cut, src in srcs.items():
        if cut in failed:
            print(json.dumps({"cut": cut, "build_failed": failed[cut]}),
                  flush=True)
            rc = 1
            continue
        r = subprocess.run([sys.executable, "-c", CHILD.format(src=str(src))],
                           env=env_for(cut, src), capture_output=True,
                           text=True)
        lines = r.stdout.strip().splitlines()
        if r.returncode or not lines:
            print(json.dumps({"cut": cut, "rc": r.returncode,
                              "stderr": r.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(json.dumps({"cut": cut, **json.loads(lines[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
