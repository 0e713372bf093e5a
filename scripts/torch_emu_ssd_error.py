#!/usr/bin/env python3
"""The SSD forward kernel's error in the CPU emulator, per case.

Compiles ``src/repro_torch/csrc/ssd_chunk.cu`` with g++ against the
emulator headers of ``--emu`` (default
``src/repro_torch/staticcheck/emu``; point it at an older checkout's copy
to compare two emulators) exactly as
``repro_torch.staticcheck.host_build`` does, runs ``ssd_y_kernel`` and
``ssd_state_kernel`` on the forward cases of
``tests/test_torch_kernels_emulated_ssd_xent.py`` (same seed), and prints,
for y and for the chunk state, the max abs error relative to the output's
scale (floor 1) against the fp32 plain version and against the same plain
version in float64.  CPU only; needs g++ (C++20).

  python3 scripts/torch_emu_ssd_error.py [--emu DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.staticcheck import host_build  # noqa: E402
import test_torch_kernels_emulated_ssd_xent as T  # noqa: E402


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.abs().max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--emu", default=str(host_build.EMU))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        src = host_build.host_source(
            "ssd_chunk.cu", (build.CSRC / "ssd_chunk.cu").read_text())
        cpp, so = pathlib.Path(tmp) / "ssd.cpp", pathlib.Path(tmp) / "ssd.so"
        cpp.write_text(src)
        subprocess.run(["g++", *host_build.CXX_FLAGS, "-shared",
                        f"-I{args.emu}", f"-I{build.CSRC}", str(cpp), "-o",
                        str(so), "-ldl"], check=True)
        lib = ctypes.CDLL(str(so))
        lib.rt_ssd_intra.argtypes = build.SIGNATURES["rt_ssd_intra"]
        lib.rt_ssd_intra.restype = ctypes.c_int
        for case in T.SSD + [(1, 1, 256, 32, 64, 128)]:
            B, nc, Q, H, P, N = case
            rng = np.random.default_rng(3)      # the emulated test's inputs
            x = torch.tensor(rng.normal(0, 1, (B, nc, Q, H, P)),
                             dtype=torch.float32)
            dt = torch.tensor(np.abs(rng.normal(0, 0.1, (B, nc, Q, H))),
                              dtype=torch.float32)
            a_cum = torch.cumsum(dt * -torch.tensor(
                rng.uniform(0.5, 2.0, H), dtype=torch.float32), dim=2)
            bm, cm = (torch.tensor(rng.normal(0, 1, (B, nc, Q, N)),
                                   dtype=torch.float32) for _ in range(2))
            args5 = (x, dt, a_cum, bm, cm)
            got = SK._launch(lib, 0, *args5)
            fp32 = SK.ssd_intra_plain(*args5)
            fp64 = SK.ssd_intra_plain(*(t.double() for t in args5))
            print(json.dumps({
                "case": case, "emu": args.emu,
                "y_vs_fp32": _rel(got[0], fp32[0]),
                "state_vs_fp32": _rel(got[1], fp32[1]),
                "y_vs_fp64": _rel(got[0], fp64[0]),
                "state_vs_fp64": _rel(got[1], fp64[1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
