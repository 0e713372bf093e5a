"""The CUDA kernel sources compiled for the host and run on the CPU,
against their plain versions.

``src/repro_torch/csrc/*.cu`` use only portable CUDA C++ (no wgmma, TMA or
inline PTX), so a C++20 host compiler with the stub headers in
``tests/cuda_emu`` compiles them with two textual rewrites: the
``<<<...>>>`` launch becomes a call of the stub ``emu_launch``, and the
dynamic ``extern __shared__`` array points at the stub's per-block
buffer.  Each block runs as 256 threads.  This checks the kernels'
indexing, masking, tile skipping, online statistics, chunking and atomics
here; the real compiler and the timings are checked on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).  Skips without g++.
Tolerances (fp32 accumulation in another order): 1e-5 forward, 1e-4
grads, relative to the output's scale.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.xent import kernel as XK

EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = re.compile(r"([A-Za-z_][A-Za-z_0-9]*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20)")
    out = tmp_path_factory.mktemp("cuda_emu")
    sources = []
    for name in build.SOURCES:
        src = LAUNCH.sub(r"emu_launch(\1, \2, ", (build.CSRC / name).read_text())
        src = src.replace("extern __shared__ float smem[];",
                          "float* smem = (float*)emu_dyn;")
        path = out / (name + ".cpp")
        path.write_text(src)
        sources.append(str(path))
    so = out / "libemulated.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    "-w", f"-I{EMU}", f"-I{build.CSRC}", *sources, "-o",
                    str(so)], check=True, timeout=900)
    return build.bind(ctypes.CDLL(str(so)))


def _close(a, b, tol):
    scale = max(1.0, float(b.abs().max()))
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3e}"


FA = [  # BKV, G, Sq, Skv, hd, causal, window, softcap, dtype
    (4, 2, 32, 32, 16, True, 0, 0.0, torch.float32),
    (2, 4, 32, 32, 16, True, 16, 0.0, torch.float32),
    (2, 2, 40, 48, 16, True, 8, 50.0, torch.float32),
    (4, 2, 32, 32, 16, False, 0, 0.0, torch.float32),
    (2, 1, 40, 24, 16, True, 0, 40.0, torch.float32),
    (1, 1, 48, 24, 16, True, 8, 0.0, torch.float32),   # rows with no valid key
    (1, 2, 96, 96, 64, True, 0, 0.0, torch.bfloat16),
    (1, 1, 70, 70, 128, True, 0, 0.0, torch.bfloat16),
    (1, 1, 40, 40, 256, True, 24, 50.0, torch.float32),
]


@pytest.mark.parametrize("case", FA, ids=str)
def test_flash_kernels_emulated(lib, case):
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    o, lse = FK._launch_fwd(lib, 0, q, k, v, **kw)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32)
    delta = torch.sum(do * o_p, dim=-1)
    got = FK._launch_bwd(lib, 0, q, k, v, do, lse_p, delta, **kw)
    want = FK.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


XENT = [(24, 32, 100, 0.0), (16, 64, 53, 30.0), (33, 48, 257, 0.0),
        (8, 32, 17, 10.0), (130, 40, 300, 0.0)]


@pytest.mark.parametrize("tied,hdt", [(False, torch.float32),
                                      (True, torch.bfloat16)], ids=str)
@pytest.mark.parametrize("case", XENT, ids=str)
def test_xent_kernels_emulated(lib, case, tied, hdt, monkeypatch):
    T, D, V, cap = case
    rng = np.random.default_rng(1)
    h = torch.tensor(rng.normal(0, 1, (T, D)), dtype=hdt)
    w = torch.tensor(rng.normal(0, 1, (V, D) if tied else (D, V)) / np.sqrt(D),
                     dtype=torch.float32)
    w = w.t() if tied else w
    lab = torch.tensor(rng.integers(0, V, (T,)), dtype=torch.int32)
    loss, lse = XK._launch_fwd(lib, 0, h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    _close(loss, loss_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    g = torch.tensor(rng.random(T), dtype=torch.float32)
    monkeypatch.setattr(XK, "STAGE_BYTES", 4 * V * XK.TILE)  # several chunks
    dh, dw = XK._launch_bwd(lib, 0, h, w, lab, lse_p, g, softcap=cap)
    assert dw.stride() == w.stride()
    dh_p, dw_p = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    _close(dh, dh_p, 1e-4)
    _close(dw, dw_p, 1e-4)
