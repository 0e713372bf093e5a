"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
fixture).  Needs no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs in fp32 are compared at 1e-5 (forward) and 1e-4 (grads) relative
to the output's scale: the kernels sum in another order than the plain
versions.  No kernel has atomics (the fused attention backward adds the
kv tiles' dQ in place in kv-tile order, each in its turn), so the
attention forward, both attention backwards and the
SSD forward and backward must repeat bit for bit.  The attention forward
and both backwards (fused, and the split one's two sweeps) run on the
tensor cores for fp32 q, k, v too, over three bf16 planes of each.  Both SSD
kernels run every product on the tensor cores (bf16 ``mma.sync``, each
fp32 operand split into bf16 planes: three planes and six passes
forward, two and three backward), so they are also checked with operands
far from 1, each output against its own scale.  The cross-entropy
kernels run every product on the tensor cores too (w and an fp32 h split
into bf16 hi/lo).  TF32 is off for the plain versions' matmuls.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import kernel as SK
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
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
    # bf16: the tensor-core kernels, one row per branch of their path
    (4, 2, 32, 32, 16, False, 0, 0.0, torch.bfloat16),    # non-causal
    (2, 2, 300, 300, 128, False, 0, 0.0, torch.bfloat16),
    (2, 4, 130, 130, 32, True, 16, 30.0, torch.bfloat16),  # G 4, window, cap
    (2, 2, 100, 180, 64, True, 40, 50.0, torch.bfloat16),  # Skv > Sq, kv_len
    (1, 2, 150, 60, 32, True, 8, 0.0, torch.bfloat16),     # no valid key
    (2, 2, 150, 150, 256, True, 64, 50.0, torch.bfloat16),  # hd 256
    # fp32 on the tensor cores (q, k, v in bf16 planes): hd 128 with and
    # without the causal mask, hd 64 with Skv > Sq, window and softcap, hd
    # 256 with window and softcap
    (2, 2, 200, 200, 128, True, 0, 0.0, torch.float32),
    (2, 2, 300, 300, 128, False, 0, 0.0, torch.float32),
    (2, 2, 100, 160, 64, True, 32, 30.0, torch.float32),  # kv_len, hd 64
    (1, 2, 400, 400, 256, True, 256, 50.0, torch.float32),
]


@pytest.mark.parametrize("case", FA, ids=str)
def test_flash_kernels_match_plain(cuda, case):
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt, device=cuda)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    key = str(dt).removeprefix("torch.")
    n0 = (FK.flash_fwd.launches, FK.flash_fwd.launches_by_dtype.get(key, 0))
    o, lse = FK.flash_fwd(q, k, v, **kw)
    assert (FK.flash_fwd.launches,
            FK.flash_fwd.launches_by_dtype[key]) == (n0[0] + 1, n0[1] + 1)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    o2, lse2 = FK.flash_fwd(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32,
                      device=cuda)
    delta = torch.sum(do * o_p, dim=-1)
    got = FK.flash_bwd_fused(q, k, v, do, lse_p, delta, **kw)
    want = FK.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    again = FK.flash_bwd_fused(q, k, v, do, lse_p, delta, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# a row may add a factor on q: x 30 puts the scaled scores at about +-30,
# where the exponential carries the scores' error into P and dS
SPLIT_LARGE_SCORES = [(2, 2, 200, 200, 128, True, 0, 0.0, torch.float32, 30.0)]


@pytest.mark.parametrize("case", FA + SPLIT_LARGE_SCORES, ids=str)
def test_flash_split_kernels_match_plain_and_repeat(cuda, case):
    BKV, G, Sq, Skv, hd, causal, window, cap, dt, *q_scale = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt, device=cuda)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    q = q * (q_scale[0] if q_scale else 1.0)
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    o, lse = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32,
                      device=cuda).to(dt)  # the sweeps read dO in q's dtype
    delta = torch.sum(do.float() * o, dim=-1)
    n0 = (FK.flash_bwd_dq.launches, FK.flash_bwd_dkv.launches)
    runs = [(FK.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *FK.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
            for _ in range(2)]
    assert (FK.flash_bwd_dq.launches, FK.flash_bwd_dkv.launches) == \
        (n0[0] + 2, n0[1] + 2)
    want = (FK.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            *FK.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    for a, b, c in zip(runs[0], runs[1], want):
        assert torch.equal(a, b)
        _close(a, c, 1e-4)


SSD = [  # B, nc, Q, H, P, N
    (2, 3, 16, 4, 8, 16), (1, 2, 8, 2, 16, 8), (2, 1, 32, 8, 8, 32),
    (1, 2, 16, 8, 16, 8), (1, 1, 100, 9, 40, 24), (2, 8, 256, 16, 64, 64),
    (1, 8, 256, 32, 64, 128),
]


def _ssd_inputs(case, dev):
    B, nc, Q, H, P, N = case
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(0, 1, (B, nc, Q, H, P)), dtype=torch.float32,
                     device=dev)
    dt = torch.tensor(np.abs(rng.normal(0, 0.1, (B, nc, Q, H))),
                      dtype=torch.float32, device=dev)
    a = -torch.tensor(rng.uniform(0.5, 2.0, H), dtype=torch.float32,
                      device=dev)
    bm, cm = (torch.tensor(rng.normal(0, 1, (B, nc, Q, N)),
                           dtype=torch.float32, device=dev) for _ in range(2))
    return x, dt, torch.cumsum(dt * a, dim=2), bm, cm


@pytest.mark.parametrize("case", SSD, ids=str)
def test_ssd_kernel_matches_plain(cuda, case):
    """The forward kernel within 1e-5 of each output's scale of its plain
    version; no atomics, so two calls are bit-identical."""
    args = _ssd_inputs(case, cuda)
    n0 = SK.ssd_intra_kernel.launches
    got = SK.ssd_intra_kernel(*args)
    assert SK.ssd_intra_kernel.launches == n0 + 1
    for a, b in zip(got, SK.ssd_intra_plain(*args)):
        _close(a, b, 1e-5)
    again = SK.ssd_intra_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", [(1, 2, 100, 9, 40, 24),
                                  (2, 8, 256, 32, 64, 128)], ids=str)
def test_ssd_kernel_matches_plain_scaled_operands(cuda, case):
    """Operands far from 1 (x 1e3, B 1e-2): the three-plane bf16 split
    keeps each operand to ~2^-24 of its own magnitude, so y and S stay
    within 1e-5 of their own largest magnitude (no floor at 1); two calls
    are bit-identical."""
    x, dt, a_cum, bm, cm = _ssd_inputs(case, cuda)
    args = (x * 1e3, dt, a_cum, bm * 1e-2, cm)
    got = SK.ssd_intra_kernel(*args)
    for a, b in zip(got, SK.ssd_intra_plain(*args)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, \
            f"max abs err {err:.3e} > 1e-5 * {scale:.3e}"
    again = SK.ssd_intra_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _ssd_bwd_args(case, dev):
    args = _ssd_inputs(case, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    dy = torch.randn(args[0].shape, generator=gen, device=dev)
    B, nc, Q, H, P = args[0].shape
    ds = torch.randn((B, nc, H, P, args[3].shape[-1]), generator=gen,
                     device=dev)
    return (*args, dy, ds)


# + the mamba2-370m server shape (8 x 2048 tokens: 8 chunks of 256)
@pytest.mark.parametrize("case", SSD + [(8, 8, 256, 32, 64, 128)], ids=str)
def test_ssd_bwd_kernel_matches_plain(cuda, case):
    """The backward kernel within 1e-4 of each gradient's scale of its plain
    version; no atomics, so two calls are bit-identical."""
    args = _ssd_bwd_args(case, cuda)
    n0 = SK.ssd_intra_bwd_kernel.launches
    got = SK.ssd_intra_bwd_kernel(*args)
    assert SK.ssd_intra_bwd_kernel.launches == n0 + 1
    for a, b in zip(got, SK.ssd_intra_bwd_plain(*args)):
        _close(a, b, 1e-4)
    again = SK.ssd_intra_bwd_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", [(1, 2, 100, 9, 40, 24),
                                  (2, 8, 256, 32, 64, 128)], ids=str)
def test_ssd_bwd_kernel_matches_plain_scaled_operands(cuda, case):
    """Operands far from 1 (x 1e3, dy 1e-3, B 1e-2, dS 1e2): the hi/lo
    split keeps each operand to ~2^-17 of its own magnitude, so every
    gradient stays within 1e-4 of its own largest magnitude (no floor at
    1); two calls are bit-identical."""
    x, dt, a_cum, bm, cm, dy, ds = _ssd_bwd_args(case, cuda)
    args = (x * 1e3, dt, a_cum, bm * 1e-2, cm, dy * 1e-3, ds * 1e2)
    got = SK.ssd_intra_bwd_kernel(*args)
    for a, b in zip(got, SK.ssd_intra_bwd_plain(*args)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-4 * scale, \
            f"max abs err {err:.3e} > 1e-4 * {scale:.3e}"
    again = SK.ssd_intra_bwd_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_autograd_on_cuda_matches_cpu(cuda):
    """ops.ssd_intra through the kernels on the card (forward and the
    hand-written backward) equals the plain path on the CPU (the forward's
    and the backward's plain versions), forward and grad."""
    outs = []
    n0 = SK.ssd_intra_bwd_kernel.launches
    for dev in (cuda, torch.device("cpu")):
        args = [t.to(dev).requires_grad_(True)
                for t in _ssd_inputs((2, 2, 32, 4, 16, 16), cuda)]
        y, s = ssd_ops.ssd_intra(*args)
        g = torch.autograd.grad(torch.sum(torch.sin(y)) + torch.sum(s ** 2),
                                args)
        outs.append([y, s] + list(g))
    assert SK.ssd_intra_bwd_kernel.launches == n0 + 1
    for a, b in zip(*outs):
        _close(a, b, 1e-4)


XENT = [(24, 32, 100, 0.0), (16, 64, 53, 30.0), (33, 48, 257, 0.0),
        (8, 32, 17, 10.0), (64, 16, 1000, 0.0), (300, 256, 5000, 0.0)]


# fp32 h only (a bf16 h needs D a multiple of 8): h's and W's planes
# padded with zeros to D rounded up to 8
XENT_ODD_D = [(9, 13, 70, 0.0), (300, 250, 5000, 30.0)]


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("hdt,wdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)],
                         ids=str)
@pytest.mark.parametrize("case", XENT, ids=str)
def test_xent_kernels_match_plain(cuda, case, hdt, wdt, tied):
    """Every product on the tensor cores: w split into bf16 hi/lo (none for
    a bf16 w), an fp32 h split into bf16 hi/lo too, a bf16 h read as it is;
    counted under h's dtype; the backward repeats bit for bit."""
    _check_xent(cuda, case, hdt, wdt, tied)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", XENT_ODD_D, ids=str)
def test_xent_fp32_h_odd_d_matches_plain(cuda, case, wdt, tied):
    """An fp32 h whose D is not a multiple of 8 takes the same route."""
    _check_xent(cuda, case, torch.float32, wdt, tied)


def _check_xent(cuda, case, hdt, wdt, tied):
    T, D, V, cap = case
    rng = np.random.default_rng(1)
    h = torch.tensor(rng.normal(0, 1, (T, D)), dtype=hdt, device=cuda)
    shape = (V, D) if tied else (D, V)
    w = torch.tensor(rng.normal(0, 1, shape) / np.sqrt(D), dtype=torch.float32,
                     device=cuda).to(wdt)
    w = w.t() if tied else w
    lab = torch.tensor(rng.integers(0, V, (T,)), dtype=torch.int32,
                       device=cuda)
    key = str(hdt).removeprefix("torch.")
    n0 = [fn.launches_by_dtype.get(key, 0)
          for fn in (XK.xent_fwd, XK.xent_bwd)]
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
    again = XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap)
    assert torch.equal(again[0], dh) and torch.equal(again[1], dw)
    assert [fn.launches_by_dtype[key] for fn in (XK.xent_fwd, XK.xent_bwd)] \
        == [n0[0] + 1, n0[1] + 2]


def test_xent_tc_route_refuses_d_not_multiple_of_8(cuda):
    h = torch.zeros((8, 12), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((12, 30), device=cuda)
    lab = torch.zeros((8,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        XK.xent_fwd(h, w, lab)
    with pytest.raises(ValueError, match="multiple of 8"):
        XK.xent_bwd(h, w, lab, torch.zeros(8, device=cuda),
                    torch.ones(8, device=cuda))


@pytest.mark.parametrize("strategy", ["fused", "split"])
def test_autograd_on_cuda_matches_cpu(cuda, strategy):
    """ops.flash_attention through the kernels on the card equals the plain
    path on the CPU, forward and grad, with either backward."""
    rng = np.random.default_rng(2)
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((2, 40, 2, 2, 32), (2, 40, 2, 32), (2, 40, 2, 32))]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True) for a in arrs)
        o = fa_ops.flash_attention(q, k, v, True, 8, 30.0, 0.2,
                                   bwd_strategy=strategy)
        g = torch.autograd.grad(torch.sum(torch.sin(o)), (q, k, v))
        outs.append([o] + list(g))
    for a, b in zip(*outs):
        _close(a, b, 1e-4)
