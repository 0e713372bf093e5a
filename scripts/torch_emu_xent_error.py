#!/usr/bin/env python3
"""The cross-entropy kernels' error in the CPU emulator, per case.

Compiles ``src/repro_torch/csrc`` with g++ against the emulator headers
(``tests/cuda_emu/harness.py``), runs ``xent_fwd`` and ``xent_bwd``'s
kernels on the cases of ``tests/test_torch_kernels_emulated_xent.py``
(same seed and inputs) with an fp32 and a bf16 h, an fp32 and a bf16 w,
tied and untied, and prints for each the max abs error of loss, lse, dh
and dw relative to the output's scale (floor 1, as the tests' checks:
1e-5 forward, 1e-4 grads) against the plain version; the last line holds
the largest of each over the cases by h dtype.  CPU only; needs g++ (C++20).

  python3 scripts/torch_emu_xent_error.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from cuda_emu import harness  # noqa: E402
from repro_torch.kernels.xent import kernel as XK  # noqa: E402
import test_torch_kernels_emulated_xent as T  # noqa: E402

OUTPUTS = ("loss", "lse", "dh", "dw")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.abs().max()))


def main() -> int:
    worst = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = harness.build_library(pathlib.Path(tmp))
        for hdt in (torch.float32, torch.bfloat16):
            for case in T.XENT + (T.ODD_D if hdt == torch.float32 else []):
                for tied in (False, True):
                    for wdt in (torch.float32, torch.bfloat16):
                        h, w, lab, g = T._xent_inputs(case, tied, hdt, wdt)
                        cap = case[3]
                        XK.STAGE_BYTES = 4 * XK._vpad(case[2]) * XK.TC_CHUNK
                        fwd = XK._launch_fwd(lib, 0, h, w, lab, softcap=cap)
                        _, lse = XK.xent_fwd_plain(h, w, lab, softcap=cap)
                        got = fwd + XK._launch_bwd(lib, 0, h, w, lab, lse, g,
                                                   softcap=cap)
                        want = XK.xent_fwd_plain(h, w, lab, softcap=cap) + \
                            XK.xent_bwd_plain(h, w, lab, lse, g, softcap=cap)
                        row = {"case": case, "tied": tied,
                               "h": str(hdt).removeprefix("torch."),
                               "w": str(wdt).removeprefix("torch.")}
                        for name, a, b in zip(OUTPUTS, got, want):
                            row[name] = _rel(a, b)
                            key = f"h_{row['h']}_{name}"
                            worst[key] = max(worst.get(key, 0.0), row[name])
                        print(json.dumps(row), flush=True)
    print(json.dumps({"max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
