"""Analysis-mode switch, as ``repro.analysis``.

The JAX package unrolls its inner ``lax.scan`` loops under
:func:`unroll_scans` because XLA's ``cost_analysis()`` counts a while-loop
body once whatever its trip count.  The port has no ``lax.scan``: its
layer loop, the attention KV-chunk loop and the SSD chunk recurrence are
Python loops, and ``FlopCounterMode`` (and the dry-run's counting modes)
see every iteration.  So the switch is kept for callers that set it, and
changes nothing the port counts: :func:`scan_unroll` answers what the
JAX package would pass as ``unroll=``.

``grad_comm_dtype`` (weight-gradient matmuls emitting their result in a
lower dtype) lives in :mod:`repro_torch.models.layers` and is re-exported
here.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.models.layers import grad_comm_dtype, grad_comm_dtype_active

__all__ = ["unroll_scans_enabled", "unroll_scans", "scan_unroll",
           "grad_comm_dtype", "grad_comm_dtype_active"]

_state = threading.local()


def unroll_scans_enabled() -> bool:
    return getattr(_state, "unroll", False)


@contextlib.contextmanager
def unroll_scans(enable: bool = True):
    prev = unroll_scans_enabled()
    _state.unroll = enable
    try:
        yield
    finally:
        _state.unroll = prev


def scan_unroll(length: int) -> int:
    """The JAX package's ``unroll=`` for an inner scan of ``length``."""
    return length if unroll_scans_enabled() else 1
