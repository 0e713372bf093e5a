"""The fp32 split backward in the CPU emulator: ``flash_bwd_dq`` and
``flash_bwd_dkv`` with fp32 q, k, v and dO (the sweeps read dO in q's
dtype) on the tensor cores (``csrc/flash_attention.cu``:
``fa_bwd_dq_tc_kernel<HD, 3>`` and ``fa_bwd_tc_kernel<HD, float, false,
3>``), over the bf16 planes of q, k and v that each sweep's pre-pass
writes, dO split into hi and lo in the kernel.  See
``test_torch_kernels_emulated.py`` for the emulator; each output is held
to 1e-4 of its scale against the plain version.  Here: the fp32 rows of
that file's ``FA`` and of ``test_torch_kernels_emulated_fa32.py``'s
``FA32``, its fp32 ``LARGE_SCORES`` rows (q x 30), rows sized to the
sweeps' own tiles, and two calls of each sweep, bit-identical.  Skips
without g++.
"""

import pytest
import torch

import test_torch_kernels_emulated as fa
import test_torch_kernels_emulated_fa32 as fa32
from cuda_emu import harness
from repro_torch.kernels.flash_attention import kernel as FK

F32 = torch.float32


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if harness.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return harness.build_library(tmp_path_factory.mktemp("cuda_emu"))


@pytest.mark.parametrize("case", [c for c in fa.FA if c[-1] == F32], ids=str)
def test_flash_split_kernels_emulated(lib, case):
    fa._check_split(lib, case)


@pytest.mark.parametrize("case", fa32.FA32, ids=str)
def test_flash_split_kernels_emulated_fp32(lib, case):
    fa._check_split(lib, case)


@pytest.mark.parametrize("case", [c for c in fa32.LARGE_SCORES
                                  if c[-1] == F32], ids=str)
def test_flash_split_kernels_emulated_large_scores(lib, case):
    """Scores scaled to about +-30: the exponential carries the scores'
    error into P and dS."""
    fa._check_split(lib, case, q_scale=30.0)


# the sweeps' fp32 tiles: dQ BQ 128, BK 16 (hd 256: BQ 32, BK 16); dK/dV
# BK 64, BQ 32 (hd 256: BK 32, BQ 16)
SWEEP_TILES = [
    (1, 2, 80, 80, 256, True, 40, 30.0, F32),   # hd 256, window, softcap
    (1, 2, 224, 224, 128, True, 72, 0.0, F32),  # window band
    (2, 1, 72, 136, 64, True, 0, 0.0, F32),     # Skv > Sq, kv_len
    (1, 1, 150, 40, 32, True, 16, 0.0, F32),    # rows with no valid key
]


@pytest.mark.parametrize("case", SWEEP_TILES, ids=str)
def test_flash_split_sweep_tiles_emulated(lib, case):
    fa._check_split(lib, case)


@pytest.mark.parametrize("case", [SWEEP_TILES[0], SWEEP_TILES[2]], ids=str)
def test_flash_split_kernels_repeat_emulated(lib, case):
    """Two calls of each sweep give the same bits: no atomics, a fixed
    order of every sum."""
    args, kw = fa._split_inputs(case)
    for launch in (FK._launch_bwd_dq, FK._launch_bwd_dkv):
        a, b = (launch(lib, 0, *args, **kw) for _ in range(2))
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
