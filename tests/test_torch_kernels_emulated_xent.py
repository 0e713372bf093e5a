"""The cross-entropy CUDA kernel source compiled for the host and run on
the CPU, against its plain versions (the harness: ``tests/cuda_emu``,
described in ``test_torch_kernels_emulated.py``).

Every product runs on the tensor cores over bf16 planes: the split
pre-passes (w into W_hi, W_lo; an fp32 h into H_hi, H_lo, padded to a
multiple of 8 columns), the logits / dlogits kernel and the hi/lo GEMMs of
dH and dW, with a bf16 or an fp32 h, an fp32 or a bf16 w, tied and
untied; ragged T, V and D, softcaps, and the backward in several chunks.
No atomics, so two backward calls are bit-identical.  Skips without g++.
Tolerances (unchanged from the CUDA-core kernels these replaced): 1e-5
forward, 1e-4 grads, relative to the output's scale (at least 1).
"""

import numpy as np
import pytest
import torch

from cuda_emu import harness
from repro_torch.kernels.xent import kernel as XK

_close = harness.close


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if harness.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return harness.build_library(tmp_path_factory.mktemp("cuda_emu"))


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
    monkeypatch.setattr(XK, "STAGE_BYTES",       # several chunks
                        4 * XK._vpad(V) * XK.TC_CHUNK)
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
    _check_fwd_bwd(lib, case, *_xent_inputs(case, tied, torch.bfloat16, wdt),
                   monkeypatch)


def _check_fwd_bwd(lib, case, h, w, lab, g, monkeypatch):
    """Forward within 1e-5 and backward (in chunks of TC_CHUNK rows) within
    1e-4 of the plain versions; dw keeps w's strides."""
    cap = case[3]
    loss, lse = XK._launch_fwd(lib, 0, h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    _close(loss, loss_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    monkeypatch.setattr(XK, "STAGE_BYTES", 4 * XK._vpad(case[2]) * XK.TC_CHUNK)
    dh, dw = XK._launch_bwd(lib, 0, h, w, lab, lse_p, g, softcap=cap)
    assert dh.shape == h.shape and dw.stride() == w.stride()
    dh_p, dw_p = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    _close(dh, dh_p, 1e-4)
    _close(dw, dw_p, 1e-4)


@pytest.mark.parametrize("D,Dp", [(40, 40), (13, 16)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=str)
def test_xent_split_prepass_emulated(lib, wdt, D, Dp):
    """The pre-pass alone: W_hi = bf16(w), W_lo = bf16(w - W_hi) (none for a
    bf16 w), laid out (Vp, Dp) with zero rows past V and zero columns past
    D (Dp = D rounded up to 8), the same from the untied (D, V) array and
    the tied transposed view of a (V, D) one."""
    V = 150
    rng = np.random.default_rng(6)
    wt = torch.tensor(rng.normal(0, 1, (V, D)), dtype=torch.float32).to(wdt)
    untied = XK._launch_split(lib, 0, wt.t().contiguous())
    tied = XK._launch_split(lib, 0, wt.t())
    hi_want = wt.to(torch.bfloat16)
    lo_want = (wt.float() - hi_want.float()).to(torch.bfloat16)
    for w_hi, w_lo in (untied, tied):
        assert w_hi.shape == (XK._vpad(V), Dp) == (256, Dp)
        assert torch.equal(w_hi[:V, :D], hi_want)
        assert not w_hi[V:].any() and not w_hi[:, D:].any()
        if wdt == torch.bfloat16:
            assert w_lo is None
            continue
        assert torch.equal(w_lo[:V, :D], lo_want)
        assert not w_lo[V:].any() and not w_lo[:, D:].any()
        # the pair carries w to ~2^-17 relative (hi's and lo's roundings)
        err = (w_hi[:V, :D].float() + w_lo[:V, :D].float() - wt).abs()
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


# D not a multiple of 8: h's and W's planes padded with zeros to Dp
ODD_D = [(9, 13, 70, 0.0), (40, 21, 130, 20.0)]


@pytest.mark.parametrize("tied,wdt", [(False, torch.float32),
                                      (True, torch.float32),
                                      (False, torch.bfloat16),
                                      (True, torch.bfloat16)], ids=str)
@pytest.mark.parametrize("case", XENT + ODD_D, ids=str)
def test_xent_fp32_h_emulated(lib, case, tied, wdt, monkeypatch):
    """An fp32 h on the tensor cores: its pre-pass splits it into bf16 hi
    and lo, and the logits and dlogits take 3 passes against an fp32 w
    (hi.hi, hi.lo, lo.hi), 2 against a bf16 w; dH 3 or 2, dW 3.  Held to
    the same checks as the bf16 h."""
    _check_fwd_bwd(lib, case, *_xent_inputs(case, tied, torch.float32, wdt),
                   monkeypatch)


def test_xent_split_h_prepass_emulated(lib):
    """The h pre-pass alone: H_hi = bf16(h), H_lo = bf16(h - H_hi), laid out
    (T, Dp) with Dp = D rounded up to 8 and zero columns past D."""
    T, D = 37, 13
    rng = np.random.default_rng(8)
    h = torch.tensor(rng.normal(0, 1, (T, D)), dtype=torch.float32)
    h_hi, h_lo = XK._launch_split_h(lib, 0, h)
    assert h_hi.shape == h_lo.shape == (T, 16)
    hi_want = h.to(torch.bfloat16)
    assert torch.equal(h_hi[:, :D], hi_want)
    assert torch.equal(h_lo[:, :D],
                       (h - hi_want.float()).to(torch.bfloat16))
    assert not h_hi[:, D:].any() and not h_lo[:, D:].any()
    # the pair carries h to ~2^-17 relative (hi's and lo's roundings)
    err = (h_hi[:, :D].float() + h_lo[:, :D].float() - h).abs()
    assert float((err - h.abs() * 2.0 ** -16).max()) <= 0


@pytest.mark.parametrize("case,tied", [((70, 40, 300, 0.0), True),
                                       ((70, 21, 300, 30.0), False)],
                         ids=str)
def test_xent_fp32_h_backward_repeats_bit_identical(lib, case, tied,
                                                    monkeypatch):
    """No atomics: two fp32-h backward calls (several chunks, dW
    accumulated across them) give bit-identical dh and dw."""
    h, w, lab, g = _xent_inputs(case, tied, torch.float32, torch.float32)
    _, lse = XK.xent_fwd_plain(h, w, lab, softcap=case[3])
    monkeypatch.setattr(XK, "STAGE_BYTES", 4 * XK._vpad(300) * XK.TC_CHUNK)
    first, second = (XK._launch_bwd(lib, 0, h, w, lab, lse, g,
                                    softcap=case[3]) for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)
