"""The CUDA kernel sources compiled for the host and run on the CPU,
against their plain versions.

``src/repro_torch/csrc/*.cu`` are portable CUDA C++ apart from the PTX
helpers of ``csrc/tensor_core.cuh`` (mma.sync, ldmatrix, cp.async), which
``tests/cuda_emu/ptx_emu.h`` replaces with host versions that follow the
PTX ISA's fragment layouts.  So a C++20 host compiler with the stub
headers in ``tests/cuda_emu`` compiles them with two textual rewrites: the
``<<<...>>>`` launch becomes a call of the stub ``emu_launch``, and the
dynamic ``extern __shared__`` array points at the stub's per-block
buffer.  Each block runs as its launch's threads.  This checks the
kernels' indexing, masking, tile skipping, online statistics, chunking,
atomics, the tensor-core fragment layouts of the bf16 attention and
cross-entropy kernels and the ragged edges of the SSD tiles, forward and
backward, here; the
real compiler and the timings are checked on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).  Skips without g++.
Tolerances (fp32 accumulation in another order; on the tensor-core
routes each fp32 operand also carries the ~2^-17 relative residual of its
bf16 hi/lo split): 1e-5 forward, 1e-4 grads, relative to the output's
scale.
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
from repro_torch.kernels.ssd_chunk import kernel as SK
from repro_torch.kernels.xent import kernel as XK

EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
LAUNCH = re.compile(r"([A-Za-z_][A-Za-z_0-9]*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(")
# extern __shared__ [__align__(n)] T name[];  ->  T* name = (T*)emu_dyn;
SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20)")
    out = tmp_path_factory.mktemp("cuda_emu")
    sources = []
    for name in build.SOURCES:
        src = LAUNCH.sub(r"emu_launch(\1, \2, ", (build.CSRC / name).read_text())
        src = SHARED.sub(r"\1* \2 = (\1*)emu_dyn;", src)
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
    # bf16: the tensor-core kernels, one row per branch of their path
    (4, 2, 32, 32, 16, False, 0, 0.0, torch.bfloat16),   # non-causal
    (2, 4, 40, 40, 32, True, 16, 30.0, torch.bfloat16),  # G 4, window, cap
    (2, 2, 40, 72, 16, True, 8, 50.0, torch.bfloat16),   # Skv > Sq, kv_len
    (1, 1, 80, 24, 32, True, 8, 0.0, torch.bfloat16),    # no valid key
    (1, 1, 40, 40, 256, True, 24, 50.0, torch.bfloat16),  # hd 256
    (1, 2, 160, 160, 32, True, 0, 0.0, torch.bfloat16),  # unmasked tiles
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


@pytest.mark.parametrize("case", FA, ids=str)
def test_flash_split_kernels_emulated(lib, case):
    """The two sweeps of the split backward (no atomics) against their
    plain versions; dO in q's dtype, as the sweeps read it."""
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    o, lse = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32).to(dt)
    delta = torch.sum(do.float() * o, dim=-1)
    _close(FK._launch_bwd_dq(lib, 0, q, k, v, do, lse, delta, **kw),
           FK.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw), 1e-4)
    got = FK._launch_bwd_dkv(lib, 0, q, k, v, do, lse, delta, **kw)
    want = FK.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


def test_flash_split_kernels_refuse_other_do_dtype(lib):
    """A bf16 q with an fp32 dO raises in both sweeps' launches: the
    kernels read dO in q's dtype and nothing rounds it on the way."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=torch.bfloat16)
               for s in ((4, 32, 16), (2, 32, 16), (2, 32, 16)))
    kw = dict(group=2, causal=True, window=0, softcap=0.0, scale=0.25,
              kv_len=32)
    o, lse = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32)
    delta = torch.sum(do * o, dim=-1)
    for launch in (FK._launch_bwd_dq, FK._launch_bwd_dkv):
        with pytest.raises(TypeError, match="dO"):
            launch(lib, 0, q, k, v, do, lse, delta, **kw)


SSD = [  # B, nc, Q, H, P, N: SSD_CASES, the smoke widths, ragged tiles
    (2, 3, 16, 4, 8, 16), (1, 2, 8, 2, 16, 8), (2, 1, 32, 8, 8, 32),
    (1, 2, 16, 8, 16, 8), (1, 1, 100, 9, 40, 24), (1, 2, 256, 9, 64, 128),
]


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_kernel_emulated(lib, case):
    B, nc, Q, H, P, N = case
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(0, 1, (B, nc, Q, H, P)), dtype=torch.float32)
    dt = torch.tensor(np.abs(rng.normal(0, 0.1, (B, nc, Q, H))),
                      dtype=torch.float32)
    a_cum = torch.cumsum(dt * -torch.tensor(rng.uniform(0.5, 2.0, H),
                                            dtype=torch.float32), dim=2)
    bm, cm = (torch.tensor(rng.normal(0, 1, (B, nc, Q, N)),
                           dtype=torch.float32) for _ in range(2))
    got = SK._launch(lib, 0, x, dt, a_cum, bm, cm)
    want = SK.ssd_intra_plain(x, dt, a_cum, bm, cm)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def _ssd_bwd_inputs(case, seed=7, decay=1.0):
    B, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    x, dy = (torch.tensor(rng.normal(0, 1, (B, nc, Q, H, P)),
                          dtype=torch.float32) for _ in range(2))
    dt = torch.tensor(np.abs(rng.normal(0, 0.1, (B, nc, Q, H))) * decay,
                      dtype=torch.float32)
    a_cum = torch.cumsum(dt * -torch.tensor(rng.uniform(0.5, 2.0, H),
                                            dtype=torch.float32), dim=2)
    bm, cm = (torch.tensor(rng.normal(0, 1, (B, nc, Q, N)),
                           dtype=torch.float32) for _ in range(2))
    ds = torch.tensor(rng.normal(0, 1, (B, nc, H, P, N)), dtype=torch.float32)
    return x, dt, a_cum, bm, cm, dy, ds


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_bwd_kernel_emulated(lib, case):
    """The hand-written backward against its plain version, each gradient
    within 1e-4 of its scale; no atomics, so two calls are bit-identical."""
    args = _ssd_bwd_inputs(case)
    got = SK._launch_bwd(lib, 0, *args)
    want = SK.ssd_intra_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-4)
    again = SK._launch_bwd(lib, 0, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_bwd_kernel_emulated_large_decays(lib):
    """a_cum spanning ~1e3 within a chunk: the kernel masks before the
    exponential, so every gradient stays finite and matches the plain one."""
    args = _ssd_bwd_inputs((1, 1, 100, 3, 16, 8), decay=400.0)
    got = SK._launch_bwd(lib, 0, *args)
    for a, b in zip(got, SK.ssd_intra_bwd_plain(*args)):
        assert bool(torch.isfinite(a).all())
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


def _xent_inputs(case, tied, hdt, wdt, seed=1):
    T, D, V, _ = case
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.normal(0, 1, (T, D)), dtype=hdt)
    w = torch.tensor(rng.normal(0, 1, (V, D) if tied else (D, V)) / np.sqrt(D),
                     dtype=torch.float32).to(wdt)
    lab = torch.tensor(rng.integers(0, V, (T,)), dtype=torch.int32)
    g = torch.tensor(rng.random(T), dtype=torch.float32)
    return h, (w.t() if tied else w), lab, g


@pytest.mark.parametrize("tied,wdt", [(False, torch.float32),
                                      (False, torch.bfloat16),
                                      (True, torch.bfloat16)], ids=str)
@pytest.mark.parametrize("case", XENT, ids=str)
def test_xent_tc_route_emulated(lib, case, tied, wdt, monkeypatch):
    """The tensor-core route (bf16 h) with each head the test above does
    not give it: an untied fp32 w (two passes against W_hi, W_lo) and a bf16
    w (no lo half), tied and untied; ragged T and V, softcaps, and the
    backward in chunks of TC_CHUNK rows."""
    cap = case[3]
    h, w, lab, g = _xent_inputs(case, tied, torch.bfloat16, wdt)
    loss, lse = XK._launch_fwd(lib, 0, h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    _close(loss, loss_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    monkeypatch.setattr(XK, "STAGE_BYTES", 4 * XK._vpad(case[2]) * XK.TC_CHUNK)
    dh, dw = XK._launch_bwd(lib, 0, h, w, lab, lse_p, g, softcap=cap)
    assert dw.stride() == w.stride()
    dh_p, dw_p = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    _close(dh, dh_p, 1e-4)
    _close(dw, dw_p, 1e-4)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=str)
def test_xent_split_prepass_emulated(lib, wdt):
    """The pre-pass alone: W_hi = bf16(w), W_lo = bf16(w - W_hi) (none for a
    bf16 w), laid out (Vp, D) with zero rows past V, the same from the
    untied (D, V) array and the tied transposed view of a (V, D) one."""
    D, V = 40, 150
    rng = np.random.default_rng(6)
    wt = torch.tensor(rng.normal(0, 1, (V, D)), dtype=torch.float32).to(wdt)
    untied = XK._launch_split(lib, 0, wt.t().contiguous())
    tied = XK._launch_split(lib, 0, wt.t())
    hi_want = wt.to(torch.bfloat16)
    lo_want = (wt.float() - hi_want.float()).to(torch.bfloat16)
    for w_hi, w_lo in (untied, tied):
        assert w_hi.shape == (XK._vpad(V), D) == (256, D)
        assert torch.equal(w_hi[:V], hi_want)
        assert not w_hi[V:].any()
        if wdt == torch.bfloat16:
            assert w_lo is None
            continue
        assert torch.equal(w_lo[:V], lo_want)
        assert not w_lo[V:].any()
        # the pair carries w to ~2^-17 relative (hi's and lo's roundings)
        err = (w_hi[:V].float() + w_lo[:V].float() - wt).abs()
        assert float((err - wt.abs() * 2.0 ** -16).max()) <= 0


def test_xent_tc_route_refuses_d_not_multiple_of_8(lib):
    """A bf16 h whose rows are not whole 16-B copies raises ValueError in
    both launches; no other route takes it."""
    h, w, lab, g = _xent_inputs((8, 12, 30, 0.0), False, torch.bfloat16,
                                torch.float32)
    lse = torch.zeros(8)
    with pytest.raises(ValueError, match="multiple of 8"):
        XK._launch_fwd(lib, 0, h, w, lab, softcap=0.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        XK._launch_bwd(lib, 0, h, w, lab, lse, g, softcap=0.0)


def test_xent_tc_backward_repeats_bit_identical(lib, monkeypatch):
    """No atomics: two backward calls (several chunks, dW accumulated
    across them) give bit-identical dh and dw."""
    case = (70, 40, 300, 0.0)
    h, w, lab, g = _xent_inputs(case, True, torch.bfloat16, torch.float32)
    _, lse = XK.xent_fwd_plain(h, w, lab)
    monkeypatch.setattr(XK, "STAGE_BYTES", 4 * XK._vpad(300) * XK.TC_CHUNK)
    first, second = (XK._launch_bwd(lib, 0, h, w, lab, lse, g, softcap=0.0)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
