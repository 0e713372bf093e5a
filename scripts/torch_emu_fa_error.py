#!/usr/bin/env python3
"""The fp32 attention kernels' error in the CPU emulator, per case and per
plane count of q and k and of v.

Compiles ``src/repro_torch/csrc`` with g++ against the emulator headers
(``repro_torch.staticcheck.host_build``), for each pair of plane counts
given as ``QK:V`` (a copy of the source with ``kQkPlanes`` and ``kVPlanes`` set
to them: q and k in QK planes for the scores, the forward's P V over V
planes; the backwards' other products keep two), and runs
``flash_fwd`` and ``flash_bwd_fused``'s kernels and the split backward's
two sweeps on the fp32 cases of ``tests/test_torch_kernels_emulated.py``
(``FA``), ``tests/test_torch_kernels_emulated_fa32.py`` (``FA32``, and
``LARGE_SCORES`` with q x 30) and
``tests/test_torch_kernels_emulated_fa32_split.py`` (``SWEEP_TILES``;
same seeds and inputs as the tests).  For each it prints the max abs
error of o, lse, dq, dk and dv, and of the sweeps' dq, dk and dv
(``*_split``), relative to the output's scale (floor 1, as the tests'
checks: 1e-5 forward, 1e-4 grads) against the plain version; the last
line holds the largest of each over the cases, by plane counts.  CPU only; needs g++ (C++20).

  python3 scripts/torch_emu_fa_error.py [QK:V ...]   # default: 3:3 3:2 2:2
"""

from __future__ import annotations

import json
import pathlib
import re
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.staticcheck import host_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
import test_torch_kernels_emulated as T  # noqa: E402
import test_torch_kernels_emulated_fa32 as T32  # noqa: E402
import test_torch_kernels_emulated_fa32_split as T32S  # noqa: E402

OUTPUTS = ("o", "lse", "dq", "dk", "dv", "dq_split", "dk_split",
           "dv_split")
PLANES = re.compile(r"constexpr int kQkPlanes = \d+, kVPlanes = \d+;")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        1.0, float(want.abs().max()))


def _errors(lib, case, seed, q_scale):
    """T._check_fwd_fused's and T._check_split's inputs and outputs, as
    errors."""
    rng = np.random.default_rng(seed)
    q, k, v, kw = T._inputs(case, rng, q_scale)
    got = FK._launch_fwd(lib, 0, q, k, v, **kw)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o_p.shape), dtype=torch.float32)
    delta = torch.sum(do * o_p, dim=-1)
    got += FK._launch_bwd(lib, 0, q, k, v, do, lse_p, delta, **kw)
    want = (o_p, lse_p) + FK.flash_bwd_fused_plain(q, k, v, do, lse_p,
                                                   delta, **kw)
    args, kw = T._split_inputs(case, q_scale)
    got += (FK._launch_bwd_dq(lib, 0, *args, **kw),
            *FK._launch_bwd_dkv(lib, 0, *args, **kw))
    want += (FK.flash_bwd_dq_plain(*args, **kw),
             *FK.flash_bwd_dkv_plain(*args, **kw))
    return {name: _rel(a, b) for name, a, b in zip(OUTPUTS, got, want)}


def main(argv) -> int:
    counts = [tuple(map(int, a.split(":"))) for a in argv or
              ("3:3", "3:2", "2:2")]
    cases = [(c, 0, 1.0) for c in T.FA + T32.FA32 + T32S.SWEEP_TILES
             if c[-1] == torch.float32]
    cases += [(c, 6, 30.0) for c in T32.LARGE_SCORES
              if c[-1] == torch.float32]
    worst = {}
    for nqk, nv in counts:
        def patch(name, text, nqk=nqk, nv=nv):
            if name != "flash_attention.cu":
                return text
            out, hits = PLANES.subn(
                f"constexpr int kQkPlanes = {nqk}, kVPlanes = {nv};", text)
            assert hits == 1, "kQkPlanes, kVPlanes not found"
            return out

        with tempfile.TemporaryDirectory() as tmp:
            lib = host_build.build_library(pathlib.Path(tmp), patch)
            for case, seed, q_scale in cases:
                row = {"qk_planes": nqk, "v_planes": nv,
                       "case": str(case)[:-15] + ")",
                       "q_scale": q_scale,
                       **_errors(lib, case, seed, q_scale)}
                print(json.dumps(row), flush=True)
                for name in OUTPUTS:
                    key = f"planes_{nqk}:{nv}_{name}"
                    worst[key] = max(worst.get(key, 0.0), row[name])
    print(json.dumps({"max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
