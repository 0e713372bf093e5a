#!/usr/bin/env python3
"""Where the SSD backward's time goes, on one card: ``python3
scripts/torch_ssd_bwd_probe.py`` from the repository root.

Times ``ssd_intra_bwd`` at the mamba2-370m server shape (B 8, nc 8,
Q 256, H 32, P 64, N 128; ``chip_smoke.ssd_case``'s inputs) per kernel
(``torch.profiler``, 10 calls after 3) and as a whole (CUDA events, 20
calls), first as the checkout has it (``none``), then for each cut: a
copy of ``src/`` under ``build/ssd_bwd_probe/<cut>/`` whose
``csrc/ssd_chunk.cu`` lacks one part of the work (see ``CUTS``), built
into its own library.  A cut kernel computes wrong gradients; only its
time is read, and the difference from ``none`` is what that part costs
where the others stay.  The variants build in parallel, then run one
after another, each in its own process.  Prints one JSON line per
variant (ms per call by kernel, the whole call's ms) and the card line
(nvidia-smi name, power limit).  Needs a CUDA device and nvcc.
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
# cut name -> (text of ssd_chunk.cu, what replaces it); each text must
# occur exactly once
CUTS = {
    # ssd_bwd_dx_kernel
    "dx_elementwise": ("if (full || (j0 + jj <= q && q < Q)) {",
                       "if (false) {"),
    "dx_product_dA": (
        "warp_mma3<false, false>(da, sX, sDY, m0, qh, ksteps(P));", ""),
    "dx_product_dx": ("if (q0 + qh < Q) {", "if (false) {"),
    "dx_dy_store": ("      tile_store(sDY, v);\n", ""),
    "dx_next_head_loads": ("      else if (h + 1 < h1) load_head(h + 1);\n",
                           ""),
    # ssd_bwd_dbc_kernel
    "dbc_state_product": (
        "warp_mma3<false, true, false>(acc, sP, sQ, m0, n0, ksteps(P));", ""),
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
args = (x, dt, a_cum, bm, cm, dy, ds)
for _ in range(3):
    SK.ssd_intra_bwd_kernel(*args)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for _ in range(10):
        SK.ssd_intra_bwd_kernel(*args)
    torch.cuda.synchronize()
by = {{}}
for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        m = re.search(r"ssd_\w+", e.name)
        name = m.group(0) if m else e.name[:60]
        by[name] = by.get(name, 0.0) + (e.time_range.end
                                        - e.time_range.start) / 1e3 / 10
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
start.record()
for _ in range(20):
    SK.ssd_intra_bwd_kernel(*args)
end.record()
end.synchronize()
print(json.dumps({{"ms_per_call": by, "ssd_intra_bwd_ms":
                  start.elapsed_time(end) / 20}}), flush=True)
"""


def variant(cut: str) -> Path:
    """The source tree of one variant (the checkout's own for none)."""
    if cut == "none":
        return ROOT / "src"
    src = ROOT / "build" / "ssd_bwd_probe" / cut / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src", src)
    text = (src / SOURCE).read_text()
    old, new = CUTS[cut]
    if text.count(old) != 1:
        raise SystemExit(f"cut {cut}: its text occurs {text.count(old)} "
                         f"times in {SOURCE}")
    (src / SOURCE).write_text(text.replace(old, new))
    return src


def env_for(cut: str, src: Path) -> dict:
    env = dict(os.environ)
    if cut != "none":
        env["REPRO_TORCH_BUILD_DIR"] = str(src.parent / "lib")
    return env


def main() -> int:
    srcs = {cut: variant(cut) for cut in ["none", *CUTS]}
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
