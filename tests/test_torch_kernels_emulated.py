"""The CUDA kernel sources compiled for the host and run on the CPU,
against their plain versions: flash attention here (the fp32 route's own
tiles, large scores and its split pre-pass in
``test_torch_kernels_emulated_fa32.py``, the fp32 split backward's two
sweeps in ``test_torch_kernels_emulated_fa32_split.py``), the SSD and
cross-entropy kernels in ``test_torch_kernels_emulated_ssd_xent.py`` and
``test_torch_kernels_emulated_xent.py``.

``src/repro_torch/csrc/*.cu`` are portable CUDA C++ apart from the PTX
helpers of ``csrc/tensor_core.cuh`` (mma.sync, ldmatrix, cp.async), which
``tests/cuda_emu/ptx_emu.h`` replaces with host versions that follow the
PTX ISA's fragment layouts; ``tests/cuda_emu/harness.py`` compiles them
with g++ against the stub headers in ``tests/cuda_emu``.  Each block
runs as its launch's threads (fibers: each warp runs alone from one block
barrier to the next), the blocks one after another.  This checks
the kernels' indexing, masking, tile skipping, online statistics, the
fused backward's dQ turns and the tensor-core fragment layouts of the
attention kernels here (every one on the tensor cores for both dtypes,
fp32 q, k, v through their bf16 planes); the real compiler and the
timings are checked on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).  Skips without g++.
Tolerances (fp32 accumulation in another order; on the tensor-core
routes each fp32 operand also carries the residual of its bf16 planes,
~2^-17 relative for hi/lo): 1e-5 forward, 1e-4 grads, relative to the
output's scale.
"""

import numpy as np
import pytest
import torch

from cuda_emu import harness
from repro_torch.kernels.flash_attention import kernel as FK

_close = harness.close


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if harness.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return harness.build_library(tmp_path_factory.mktemp("cuda_emu"))


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


def _inputs(case, rng, q_scale=1.0):
    """q, k, v and the kernels' keywords of an FA row, from rng."""
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    return (q * q_scale).to(dt), k, v, kw


def _check_fwd_fused(lib, case, seed, q_scale=1.0):
    """The forward (twice, bit-identical) and the fused backward (twice,
    bit-identical) against their plain versions."""
    rng = np.random.default_rng(seed)
    q, k, v, kw = _inputs(case, rng, q_scale)
    o, lse = FK._launch_fwd(lib, 0, q, k, v, **kw)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    _close(o, o_p, 1e-5)
    _close(lse, lse_p, 1e-5)
    o2, lse2 = FK._launch_fwd(lib, 0, q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32)
    delta = torch.sum(do * o_p, dim=-1)
    got = FK._launch_bwd(lib, 0, q, k, v, do, lse_p, delta, **kw)
    want = FK.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    # dQ summed in place in kv-tile order, no atomics: bit-identical
    again = FK._launch_bwd(lib, 0, q, k, v, do, lse_p, delta, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", FA, ids=str)
def test_flash_kernels_emulated(lib, case):
    _check_fwd_fused(lib, case, 0)


def _split_inputs(case, q_scale=1.0):
    """q, k, v, dO (in q's dtype, as the sweeps read it), lse, delta and
    the keywords of an FA row for the split sweeps."""
    dt = case[-1]
    rng = np.random.default_rng(2)
    q, k, v, kw = _inputs(case, rng, q_scale)
    o, lse = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32).to(dt)
    delta = torch.sum(do.float() * o, dim=-1)
    return (q, k, v, do, lse, delta), kw


def _check_split(lib, case, q_scale=1.0):
    """The two sweeps of the split backward (no atomics) against their
    plain versions."""
    args, kw = _split_inputs(case, q_scale)
    _close(FK._launch_bwd_dq(lib, 0, *args, **kw),
           FK.flash_bwd_dq_plain(*args, **kw), 1e-4)
    got = FK._launch_bwd_dkv(lib, 0, *args, **kw)
    want = FK.flash_bwd_dkv_plain(*args, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)


# the fp32 rows run in test_torch_kernels_emulated_fa32_split.py
@pytest.mark.parametrize("case", [c for c in FA if c[-1] == torch.bfloat16],
                         ids=str)
def test_flash_split_kernels_emulated(lib, case):
    _check_split(lib, case)


def _tile_masked(qa, qb, ka, kb, causal, window, kv_len):
    """csrc/flash_attention.cu::fa_tile_masked."""
    return (ka >= kv_len or (causal and ka > qb)
            or (window and qa - kb >= window))


@pytest.mark.parametrize("case", [
    (1, 2, 160, 160, 16, True, 0, 0.0, torch.float32),  # causal triangle
    (1, 1, 160, 40, 16, True, 8, 0.0, torch.float32),   # no valid key
    (1, 2, 192, 192, 16, True, 40, 0.0, torch.float32),  # window band
    FA[11], FA[12],                                      # bf16, same
    (1, 2, 160, 160, 32, True, 48, 0.0, torch.bfloat16),  # band, bf16
    # fp32 on the tensor cores: hd 128, and hd 256's own tiles (BQ 16,
    # BK 32) under the causal triangle and a window band
    (1, 2, 160, 160, 128, True, 0, 0.0, torch.float32),
    (1, 1, 112, 112, 256, True, 0, 0.0, torch.float32),
    (1, 2, 96, 96, 256, True, 40, 0.0, torch.float32),
], ids=str)
def test_flash_fused_bwd_passes_every_turn(lib, case):
    """The fused backward's dQ turns: each kv tile the mask leaves a q tile
    takes its turn there once, in kv-tile order (the emulated wait aborts
    on a turn out of order), so every counter ends at the number of such
    tiles, and dQ (rows with no valid key included) is the same as the
    wrapper's."""
    BKV, G, Sq, Skv, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.normal(0, 1, s), dtype=dt)
               for s in ((BKV * G, Sq, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=causal, window=window, softcap=cap,
              scale=1 / np.sqrt(hd), kv_len=Skv - 3 if Skv > Sq else Skv)
    o, lse = FK.flash_fwd_plain(q, k, v, **kw)
    do = torch.tensor(rng.normal(0, 1, o.shape), dtype=torch.float32)
    delta = torch.sum(do * o, dim=-1)
    want = FK._launch_bwd(lib, 0, q, k, v, do, lse, delta, **kw)
    ops = FK._bwd_operands(q, k, v, do, lse, delta)
    dq = torch.zeros(q.shape)
    dk, dv = torch.empty(k.shape), torch.empty(k.shape)
    BH = BKV * G
    bq, bk = FK.fused_bwd_tiles(lib, q)
    nq, nk = -(-Sq // bq), -(-Skv // bk)
    turns = torch.zeros(BH * nq, dtype=torch.int32)
    planes = FK._planes(lib, q, k)   # fp32 q, k, v: their bf16 planes
    assert lib.rt_flash_bwd(*FK._bwd_ptrs(planes, ops + (dq, dk, dv)),
                            turns.data_ptr(), BH * nq,
                            *FK._bwd_scalars(q, k, **kw), None) == 0
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    want_turns = [sum(not _tile_masked(i * bq, min(i * bq + bq, Sq) - 1,
                                       j * bk, min(j * bk + bk, Skv) - 1,
                                       causal, window, kw["kv_len"])
                      for j in range(nk)) for i in range(nq)]
    assert turns.view(BH, nq).tolist() == [want_turns] * BH
    assert min(want_turns) < nk       # some (q tile, kv tile) pairs masked


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
