"""``torch.profiler`` and NVTX coupling, as ``repro.observability.profiling``.

The tracer's own spans are host-side; to line them up with device work,
``--profile`` on ``python -m repro_torch.launch.run_experiment`` wraps the
run in :func:`profile_run`, which turns :func:`enable_annotations` on, and
then

* every :meth:`~repro_torch.observability.tracer.Tracer.span` of a
  ``profile=True`` tracer also enters :func:`trace_annotation`, and
* the kernel entry points (the :func:`annotate` call sites in
  ``repro_torch.kernels.*.ops``: ``flash_fwd``, ``flash_bwd_{strategy}``,
  ``fused_xent_pallas``) open a range of that name around their
  launches, forward and backward.

A range is a ``torch.profiler.record_function`` (the profiler's host
track; a kernel launched inside it is attributed to it) and, with CUDA,
an NVTX range of the same name (``range_start`` / ``range_end``, so the
range may close on another thread or out of order).  With profiling off,
:func:`annotate` returns a shared no-op after one boolean check.  With it
on, a range that cannot be entered raises: a profiled run never records
nothing in silence.  torch is imported on first use, so importing this
module costs nothing.
"""

from __future__ import annotations

import contextlib
import os

_ACTIVE = False


def enable_annotations(on: bool = True):
    """Globally enable :func:`annotate` (:func:`profile_run` flips it)."""
    global _ACTIVE
    _ACTIVE = bool(on)


def annotations_active() -> bool:
    return _ACTIVE


_NULL = contextlib.nullcontext()


class _Range:
    """A ``record_function`` range and, with CUDA, an NVTX range, both
    named ``name``."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = None

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            self._nvtx = torch.cuda.nvtx.range_start(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        if self._nvtx is not None:
            torch.cuda.nvtx.range_end(self._nvtx)
            self._nvtx = None
        rf, self._rf = self._rf, None
        rf.__exit__(exc_type, exc, tb)
        return False


def trace_annotation(name: str) -> _Range:
    """A profiler range named ``name`` (see :class:`_Range`)."""
    return _Range(name)


def annotate(name: str):
    """Kernel-call hook: a profiler range when profiling is on, else the
    shared no-op."""
    if not _ACTIVE:
        return _NULL
    return _Range(name)


@contextlib.contextmanager
def profile_run(logdir: str):
    """``torch.profiler.profile`` (CPU, and CUDA when there is a card)
    around a run, annotations enabled.  Yields the profiler; on exit its
    Chrome trace is written to ``logdir/profile_trace.json`` (Perfetto
    opens it) and its path set as the profiler's ``trace_path``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    enable_annotations(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        enable_annotations(False)
    prof.trace_path = os.path.join(logdir, "profile_trace.json")
    prof.export_chrome_trace(prof.trace_path)
