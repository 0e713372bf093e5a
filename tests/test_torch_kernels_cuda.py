"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture).  Needs no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs in fp32 are compared at 1e-5 (forward) and 1e-4 (grads) relative
to the output's scale: the kernels sum in another order than the plain
versions and dQ takes its kv-tile partials through atomics.  TF32 is off
for the plain versions' matmuls.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.xent import kernel as XK

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3e}"


FA = [  # BKV, G, Sq, Skv, hd, causal, window, softcap, dtype
    (4, 2, 32, 32, 16, True, 0, 0.0, torch.float32),
    (2, 1, 48, 48, 32, True, 0, 0.0, torch.float32),
    (2, 4, 32, 32, 16, True, 16, 0.0, torch.float32),
    (2, 2, 40, 48, 16, True, 8, 50.0, torch.float32),
    (4, 2, 32, 32, 16, False, 0, 0.0, torch.float32),
    (2, 2, 24, 40, 16, True, 12, 25.0, torch.float32),
    (2, 1, 40, 24, 16, True, 0, 40.0, torch.float32),
    (1, 1, 48, 24, 16, True, 8, 0.0, torch.float32),   # rows with no valid key
    (2, 2, 96, 96, 64, True, 0, 0.0, torch.bfloat16),
    (2, 2, 200, 200, 128, True, 0, 0.0, torch.bfloat16),
    (2, 2, 150, 150, 256, True, 64, 50.0, torch.float32),
]


@pytest.mark.parametrize("case", FA, ids=str)
def test_flash_kernels_match_plain(cuda, case):
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt, device=cuda)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    n0 = FK.flash_fwd.launches
    o, lse = FK.flash_fwd(q, k, v, **kw)
    assert FK.flash_fwd.launches == n0 + 1
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32,
                      device=cuda)
    delta = torch.sum(do * o_p, dim=-1)
    got = FK.flash_bwd_fused(q, k, v, do, lse_p, delta, **kw)
    want = FK.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


XENT = [(24, 32, 100, 0.0), (16, 64, 53, 30.0), (33, 48, 257, 0.0),
        (8, 32, 17, 10.0), (64, 16, 1000, 0.0), (300, 256, 5000, 0.0)]


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("hdt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", XENT, ids=str)
def test_xent_kernels_match_plain(cuda, case, hdt, tied):
    T, D, V, cap = case
    rng = np.random.default_rng(1)
    h = torch.tensor(rng.normal(0, 1, (T, D)), dtype=hdt, device=cuda)
    shape = (V, D) if tied else (D, V)
    w = torch.tensor(rng.normal(0, 1, shape) / np.sqrt(D), dtype=torch.float32,
                     device=cuda)
    w = w.t() if tied else w
    lab = torch.tensor(rng.integers(0, V, (T,)), dtype=torch.int32,
                       device=cuda)
    loss, lse = XK.xent_fwd(h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    _close(loss, loss_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    g = torch.tensor(rng.random(T), dtype=torch.float32, device=cuda)
    dh, dw = XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap)
    assert dw.stride() == w.stride()
    dh_p, dw_p = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    _close(dh, dh_p, 1e-4)
    _close(dw, dw_p, 1e-4)


def test_autograd_on_cuda_matches_cpu(cuda):
    """ops.flash_attention through the kernels on the card equals the plain
    path on the CPU, forward and grad."""
    rng = np.random.default_rng(2)
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((2, 40, 2, 2, 32), (2, 40, 2, 32), (2, 40, 2, 32))]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True) for a in arrs)
        o = fa_ops.flash_attention(q, k, v, True, 8, 30.0, 0.2)
        g = torch.autograd.grad(torch.sum(torch.sin(o)), (q, k, v))
        outs.append([o] + list(g))
    for a, b in zip(*outs):
        _close(a, b, 1e-4)
