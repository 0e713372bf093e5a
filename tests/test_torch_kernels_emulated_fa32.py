"""The fp32 attention route in the CPU emulator: q, k and v split into
bf16 planes by the pre-pass, the forward and the fused backward on the
tensor cores (``csrc/flash_attention.cu``; see
``test_torch_kernels_emulated.py`` for the emulator and the tolerances:
1e-5 forward, 1e-4 grads, relative to the output's scale).  Here: the
fp32 tiles' own branches (unmasked tiles, Skv > Sq with kv_len, a window
band), scores scaled to about +-30, and the split pre-pass's planes; the
other fp32 rows run with the bf16 ones in ``test_torch_kernels_emulated.py``,
and the split backward's sweeps over these rows in
``test_torch_kernels_emulated_fa32_split.py``.  Skips without g++.
"""

import numpy as np
import pytest
import torch

import test_torch_kernels_emulated as fa
from cuda_emu import harness


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if harness.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return harness.build_library(tmp_path_factory.mktemp("cuda_emu"))


# fp32: the tensor-core kernels over bf16 planes, their own tiles' branches
FA32 = [
    (1, 2, 160, 160, 64, True, 0, 0.0, torch.float32),   # unmasked tiles
    (1, 1, 160, 160, 128, True, 0, 0.0, torch.float32),  # the same, hd 128
    (2, 2, 70, 100, 32, True, 0, 0.0, torch.float32),    # Skv > Sq, kv_len
    (1, 2, 192, 192, 32, True, 40, 0.0, torch.float32),  # window band
]
# q x 30: scaled scores reach about +-30 (the exponential amplifies their
# error; the case that sets the planes of q and k)
LARGE_SCORES = [
    (1, 2, 96, 96, 64, True, 0, 0.0, torch.float32),
    (1, 1, 64, 64, 128, False, 0, 0.0, torch.float32),
    (1, 1, 40, 40, 256, True, 24, 50.0, torch.float32),
    (1, 2, 96, 96, 64, True, 0, 0.0, torch.bfloat16),
]


@pytest.mark.parametrize("case", FA32, ids=str)
def test_flash_kernels_emulated_fp32(lib, case):
    fa._check_fwd_fused(lib, case, 0)


@pytest.mark.parametrize("case", LARGE_SCORES, ids=str)
def test_flash_kernels_emulated_large_scores(lib, case):
    fa._check_fwd_fused(lib, case, 6, q_scale=30.0)


@pytest.mark.parametrize("n", [16, 1040, 8192 + 48])
def test_flash_split_planes(lib, n):
    """The fp32 operands' pre-pass: three planes sum back to x exactly,
    the first two (the round-to-nearest bf16 hi, then lo) to within 2^-17
    of |x|, plane 0 is bf16(x), a two-plane split writes the same two
    planes, and nothing past each plane's n elements is written."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(0, 1, n) * 10.0 ** rng.uniform(-6, 6, n),
                     dtype=torch.float32)
    for np_ in (3, 2):
        planes = torch.full((np_, n + 8), 7.0, dtype=torch.bfloat16)
        flat = planes.view(-1)
        # plane p at p n: the tail of the buffer stays as it was
        assert lib.rt_flash_split(x.data_ptr(), flat.data_ptr(), n, np_,
                                  None) == 0
        got = flat[:np_ * n].view(np_, n).double()
        assert (flat[np_ * n:] == 7.0).all()
        assert torch.equal(got[0].to(torch.bfloat16), x.to(torch.bfloat16))
        two = got[0] + got[1]
        assert ((two - x.double()).abs() <= 2.0 ** -17 * x.double().abs()).all()
        if np_ == 3:
            assert torch.equal(got.sum(0), x.double())
            first_two = got[:2]
        else:
            assert torch.equal(got, first_two)
