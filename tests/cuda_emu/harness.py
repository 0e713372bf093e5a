"""The emulated kernel tests' view of the host build
(``repro_torch.staticcheck.host_build``, which compiles
``src/repro_torch/csrc/*.cu`` with g++ against the CUDA stand-in headers in
``src/repro_torch/staticcheck/emu/``), and their tolerance check."""

from repro_torch.staticcheck.host_build import (  # noqa: F401
    build_library, compiler)


def close(a, b, tol):
    """max |a - b| within ``tol`` of b's scale (at least 1)."""
    scale = max(1.0, float(b.abs().max()))
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3e}"
