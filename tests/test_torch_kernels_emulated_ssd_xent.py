"""The SSD and cross-entropy CUDA kernel sources compiled for the host
and run on the CPU, against their plain versions (the flash attention
kernels: ``test_torch_kernels_emulated.py``, whose docstring describes the
harness, ``tests/cuda_emu``).

This checks the kernels' chunking, the tensor-core fragment layouts of
the cross-entropy kernels and of the SSD forward and backward (their
fp32 operands split into three or two bf16 planes, an accumulator reused
as an A operand in registers) and the ragged edges of the SSD tiles,
forward and backward.  Skips without g++.  Tolerances: 1e-5 forward,
1e-4 grads, relative to the output's scale (and to its own scale, with
no floor at 1, for the SSD kernels' operands far from 1).
"""

import numpy as np
import pytest
import torch

from cuda_emu import harness
from repro_torch.kernels.ssd_chunk import kernel as SK
from repro_torch.kernels.xent import kernel as XK

_close = harness.close


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if harness.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return harness.build_library(tmp_path_factory.mktemp("cuda_emu"))


SSD = [  # B, nc, Q, H, P, N: SSD_CASES, the smoke widths, ragged tiles
    (2, 3, 16, 4, 8, 16), (1, 2, 8, 2, 16, 8), (2, 1, 32, 8, 8, 32),
    (1, 2, 16, 8, 16, 8), (1, 1, 100, 9, 40, 24), (1, 2, 256, 9, 64, 128),
]


# + mamba2-370m's full head count (H 32: four head groups of 8) at Q 256,
# P 64, N 128, one chunk
@pytest.mark.parametrize("case", SSD + [(1, 1, 256, 32, 64, 128)], ids=str)
def test_ssd_kernel_emulated(lib, case):
    """The tensor-core forward against its plain version within 1e-5 of
    each output's scale; no atomics, so two calls are bit-identical."""
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
    again = SK._launch(lib, 0, x, dt, a_cum, bm, cm)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_kernel_emulated_large_decays(lib):
    """a_cum spanning ~1e3 within a chunk: the forward masks before the
    exponential, so y and S stay finite and match the plain ones."""
    args = _ssd_bwd_inputs((1, 2, 100, 9, 40, 24), decay=400.0)[:5]
    assert float(args[2].min()) < -500.0
    for a, b in zip(SK._launch(lib, 0, *args), SK.ssd_intra_plain(*args)):
        assert bool(torch.isfinite(a).all())
        _close(a, b, 1e-5)


def test_ssd_kernel_emulated_scaled_operands(lib):
    """Operands far from 1 (x 1e3, B 1e-2): every fp32 operand is split
    into three bf16 planes, which keep ~2^-24 of its own magnitude at any
    scale, so y and S stay within 1e-5 of their own largest magnitude (no
    floor at 1); two calls are bit-identical."""
    x, dt, a_cum, bm, cm = _ssd_bwd_inputs((1, 2, 100, 9, 40, 24))[:5]
    args = (x * 1e3, dt, a_cum, bm * 1e-2, cm)
    got = SK._launch(lib, 0, *args)
    for a, b in zip(got, SK.ssd_intra_plain(*args)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, \
            f"max abs err {err:.3e} > 1e-5 * {scale:.3e}"
    again = SK._launch(lib, 0, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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


# + mamba2-370m's full head count (H 32: four head groups of 8 through the
# dCB sum kernel) at Q 256, P 64, N 128, one chunk
@pytest.mark.parametrize("case", SSD + [(1, 1, 256, 32, 64, 128)], ids=str)
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


def test_ssd_bwd_kernel_emulated_scaled_operands(lib):
    """Operands far from 1 (x 1e3, dy 1e-3, B 1e-2, dS 1e2): every
    fp32 operand is split into bf16 hi + lo, which keeps ~2^-17 of its
    own magnitude at any scale, so each gradient stays within 1e-4 of its
    own largest magnitude (no floor at 1); two calls are bit-identical."""
    x, dt, a_cum, bm, cm, dy, ds = _ssd_bwd_inputs((1, 2, 100, 9, 40, 24))
    args = (x * 1e3, dt, a_cum, bm * 1e-2, cm, dy * 1e-3, ds * 1e2)
    got = SK._launch_bwd(lib, 0, *args)
    for a, b in zip(got, SK.ssd_intra_bwd_plain(*args)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-4 * scale, \
            f"max abs err {err:.3e} > 1e-4 * {scale:.3e}"
    again = SK._launch_bwd(lib, 0, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
