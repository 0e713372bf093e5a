"""Span tracing, phase and round metrics, and trace export, as
``repro.observability``.

One :class:`Observability` bundle (a :class:`~repro_torch.observability
.tracer.Tracer` and a :class:`~repro_torch.observability.metrics
.MetricsRegistry`) is threaded per system through the
:class:`~repro_torch.experiments.runner.Runner`, the trainers, the
transport and the fleet scheduler.  Disabled (the default,
:data:`NULL_OBS`) it costs one boolean check per call site; enabled it
records where every byte and second goes without feeding back into the
accounting or a generator, so a fault-free history is the same with
observability on or off.  :mod:`~repro_torch.observability.profiling`
puts the spans and the kernel entry points under ``torch.profiler`` and
NVTX ranges.

Stdlib-only at import time (the transport layer hooks in).
"""

from repro_torch.observability.metrics import (NULL_METRICS,
                                               MetricsRegistry,
                                               format_phase_table,
                                               metric_key, parse_metric_key)
from repro_torch.observability.tracer import (NULL_SPAN, NULL_TRACER,
                                              SpanRecord, Tracer)


class Observability:
    """Tracer + metrics registry for one system run."""

    def __init__(self, enabled: bool = True, *, tracer: Tracer = None,
                 metrics: MetricsRegistry = None, max_events: int = 250_000,
                 profile: bool = False):
        self.enabled = bool(enabled)
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=enabled, max_events=max_events, profile=profile)
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            enabled=enabled)

    @classmethod
    def from_spec(cls, obs_spec) -> "Observability":
        """Build from an :class:`~repro_torch.experiments.spec
        .ObservabilitySpec` (or ``None`` -> the shared disabled bundle)."""
        if obs_spec is None or not obs_spec.enabled:
            return NULL_OBS
        return cls(enabled=True, max_events=obs_spec.max_events,
                   profile=obs_spec.profile)

    def summary(self) -> dict:
        return {"tracer": self.tracer.summary(),
                "metrics": self.metrics.to_dict()}


NULL_OBS = Observability(enabled=False, tracer=NULL_TRACER,
                         metrics=NULL_METRICS)


__all__ = [
    "MetricsRegistry", "NULL_METRICS", "NULL_OBS", "NULL_SPAN",
    "NULL_TRACER", "Observability", "SpanRecord", "Tracer",
    "format_phase_table", "metric_key", "parse_metric_key",
]
