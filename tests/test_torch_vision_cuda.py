"""The vision layers on the card against the same layers on the CPU, in
fp32, with the precision the port's entry points pin.

Marked ``cuda``: skips without a CUDA device.  Needs no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_vision_cuda.py

Each test first turns TF32 on for cuDNN (PyTorch's default) and cuBLAS
(a caller's opt-in), then resolves the device as every entry point does
(``repro_torch.device.resolve_device``), so the layers run with what the
port sets and nothing else.  Forwards and gradients are held within 1e-5
of each output's largest magnitude (a gradient leaf's floored at 1e-1 of
the largest gradient of the case: one that vanishes analytically, as a
key bias's under the softmax, holds only rounding noise): fp32 sums in
another order stay near 1e-6 there, and a TF32 product (a 10-bit
mantissa) misses it by two orders.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield resolve_device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _grads_and_out(model, params, x, lo, hi, device):
    """Layers [lo, hi) on ``device``: their output and the gradients of
    a fixed random projection of it by each of their params and ``x``."""
    leaves = []

    def to(t):
        t = t.detach().to(device).requires_grad_(True)
        leaves.append(t)
        return t

    layers = [tree_map(to, p) if lo <= i < hi else p
              for i, p in enumerate(params["layers"])]
    y = model.apply({**params, "layers": layers}, to(x), lo=lo, hi=hi,
                    return_logits=False)["hidden"]
    ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (y * ct.to(device)).sum().backward()
    return y.detach().cpu(), [t.grad.cpu() for t in leaves]


def _close(got, want, what, floor=1e-30):
    scale = max(float(want.abs().max()), floor)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} * {scale:.3e}"


@pytest.mark.parametrize("arch,lo,hi", [("vgg11", 0, 3),
                                        ("mobilenet-l", 0, 4),
                                        ("vit-s", 0, 2)])
def test_layers_on_card_match_cpu_fp32(cuda, arch, lo, hi):
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    model = build_model(registry.get_config(arch))
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, tuple(model.input_spec(2).shape)).astype(np.float32))
    want, want_g = _grads_and_out(model, params, x, lo, hi, "cpu")
    got, got_g = _grads_and_out(model, params, x, lo, hi, cuda)
    _close(got, want, f"{arch} layers [{lo}, {hi}) forward")
    top = max(float(g.abs().max()) for g in want_g)
    for i, (a, b) in enumerate(zip(got_g, want_g)):
        _close(a, b, f"{arch} grad leaf {i}", floor=0.1 * top)
