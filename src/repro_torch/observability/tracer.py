"""Span tracing with two clocks, as ``repro.observability.tracer``.

A :class:`Tracer` records where time and bytes go without feeding back
into the run: spans never touch a generator, the accounting or control
flow, so a fault-free run traced gives the history of the same run
untraced.  Span attributes carry Python scalars the step has already
computed, never a tensor (a span that read one would sync the card, and
one that kept it would keep its memory alive).

Every span carries two clocks:

* **wall** — host ``time.perf_counter`` seconds since the tracer's
  construction, the timeline Perfetto renders
  (:func:`repro_torch.observability.export.write_chrome_trace`).  A span
  boundary never synchronizes the card, so on the GPU a wall span times
  the host's work and whatever device work the host waited for inside
  it: the spans whose bodies end in a host read of a device value (a
  ``float()`` or ``.item()`` of a loss, a ``.cpu()`` of activations) are
  device-inclusive — ``{phase}.round`` and ``{phase}.epoch`` (each ends in
  its loss and its evaluation), ``aux_eval``, ``merged_eval`` and
  ``consolidate`` (each shard comes to the host) — while ``xfer`` spans
  are host arithmetic only.  Device time comes from
  :func:`repro_torch.observability.profiling.profile_run`.
* **sim** — the run's simulated clock (the ``Runner.history["sim_time"]``
  quantity), sampled at span entry and exit through an injected
  ``sim_clock``.  Scheduler and fleet-trace spans live entirely in the sim
  domain (``clock="sim"``).

Tracks are plain strings (``"server"``, ``"device"``, ``"scheduler"``,
``"transport"``); the first ``/`` segment becomes the Perfetto process,
the whole string the thread.  A disabled tracer (``Tracer(enabled=False)``
or the shared :data:`NULL_TRACER`) costs one attribute check per call and
records nothing.  A ``profile=True`` tracer also opens a profiler range
(:func:`~repro_torch.observability.profiling.trace_annotation`) around
each span, and raises if one cannot be entered: a profiled run never
records nothing in silence.  Stdlib-only at import time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class SpanRecord:
    """One closed span (or instant event, when ``dur`` entries are 0)."""

    name: str
    track: str                      # "group" or "group/subtrack"
    kind: str                       # "span" | "instant"
    t_wall: float                   # seconds since tracer start
    dur_wall: float
    t_sim: Optional[float] = None   # simulated seconds (run clock)
    dur_sim: Optional[float] = None
    clock: str = "wall"             # timeline domain: "wall" | "sim"
    depth: int = 0                  # nesting depth at entry (LIFO check)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, **attrs):
        """Attach attributes after entry (e.g. a loss known at exit)."""
        self.attrs.update(attrs)


class _NullSpan:
    """Shared do-nothing span for disabled tracers; supports ``set``."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class _SpanCM:
    """Context manager closing one live span LIFO."""

    __slots__ = ("_tracer", "_rec", "_wall0")

    def __init__(self, tracer: "Tracer", rec: SpanRecord, wall0: float):
        self._tracer = tracer
        self._rec = rec
        self._wall0 = wall0

    def __enter__(self) -> SpanRecord:
        return self._rec

    def __exit__(self, exc_type, exc, tb):
        self._tracer._close_span(self._rec, self._wall0)
        return False


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CM = _NullCM()


class Tracer:
    """Records spans and instant events; never affects the traced run.

    ``sim_clock`` (when bound) supplies the simulated-time reading taken
    at span entry/exit; :meth:`bind_sim_clock` lets the owning
    :class:`~repro_torch.experiments.runner.Runner` inject it after
    construction.  ``max_events`` bounds memory: past the cap new events
    are counted in :attr:`dropped` instead of stored (never an error —
    observability must not take the run down).
    """

    def __init__(self, enabled: bool = True, *,
                 sim_clock: Optional[Callable[[], float]] = None,
                 wall_clock: Optional[Callable[[], float]] = None,
                 max_events: int = 250_000, profile: bool = False):
        self.enabled = bool(enabled)
        self.sim_clock = sim_clock
        self._wall = wall_clock or time.perf_counter
        self.max_events = int(max_events)
        self.profile = bool(profile)
        self.t0 = self._wall()
        self.events: List[SpanRecord] = []   # closed, in close order
        self.dropped = 0
        self._stack: List[SpanRecord] = []   # open spans, LIFO

    # ------------------------------------------------------------------
    def bind_sim_clock(self, fn: Callable[[], float]):
        """Install the simulated-time reader if none is bound yet."""
        if self.sim_clock is None:
            self.sim_clock = fn

    def _now(self) -> float:
        return self._wall() - self.t0

    def _sim_now(self) -> Optional[float]:
        return None if self.sim_clock is None else float(self.sim_clock())

    # ------------------------------------------------------------------
    def span(self, name: str, *, track: str = "main", **attrs):
        """Context manager timing one dual-clock span.

        Yields the live :class:`SpanRecord` so callers can attach exit
        attributes (``sp.set(loss=...)``); a disabled tracer yields a
        shared null span instead.
        """
        if not self.enabled:
            return _NULL_CM
        wall0 = self._now()
        rec = SpanRecord(name=name, track=track, kind="span",
                         t_wall=wall0, dur_wall=0.0,
                         t_sim=self._sim_now(), clock="wall",
                         depth=len(self._stack), attrs=dict(attrs))
        self._stack.append(rec)
        if self.profile:
            _enter_profiler_annotation(rec, name)
        return _SpanCM(self, rec, wall0)

    def _close_span(self, rec: SpanRecord, wall0: float):
        # spans close LIFO by construction (context managers unwind the
        # stack); tolerate a mismatch rather than corrupt the stack
        if self._stack and self._stack[-1] is rec:
            self._stack.pop()
        elif rec in self._stack:
            self._stack.remove(rec)
        if self.profile:
            _exit_profiler_annotation(rec)
        rec.dur_wall = self._now() - wall0
        sim1 = self._sim_now()
        if rec.t_sim is not None and sim1 is not None:
            rec.dur_sim = sim1 - rec.t_sim
        self._store(rec)

    def instant(self, name: str, *, track: str = "main", **attrs):
        """Record a zero-duration event at the current clocks."""
        if not self.enabled:
            return
        self._store(SpanRecord(name=name, track=track, kind="instant",
                               t_wall=self._now(), dur_wall=0.0,
                               t_sim=self._sim_now(), dur_sim=0.0,
                               clock="wall", depth=len(self._stack),
                               attrs=dict(attrs)))

    def record_span(self, name: str, *, track: str = "main",
                    t_sim: float, dur_sim: float, kind: str = "span",
                    **attrs):
        """Record an after-the-fact span in the *sim* clock domain.

        Used for replayed artifacts whose timing is already known —
        scheduler heap events and fleet-trace rounds — where the wall
        clock of the recording moment is meaningless.
        """
        if not self.enabled:
            return
        self._store(SpanRecord(name=name, track=track, kind=kind,
                               t_wall=self._now(), dur_wall=0.0,
                               t_sim=float(t_sim), dur_sim=float(dur_sim),
                               clock="sim", depth=0, attrs=dict(attrs)))

    def _store(self, rec: SpanRecord):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(rec)

    # ------------------------------------------------------------------
    def ingest_fleet_trace(self, trace, *, track: str = "scheduler",
                           events: bool = True):
        """Replay a :class:`~repro_torch.fleet.FleetTrace` into scheduler-track
        sim-domain spans: one span per round, one instant per raw heap
        event (churn/dropout/straggler/heartbeat/quorum/...).

        Heartbeats dominate multi-100k-event traces; they are folded
        into a per-round count attribute instead of one instant each so
        the track stays readable (and under ``max_events``).
        """
        if not self.enabled:
            return
        for p in trace.rounds:
            attrs = {"round": p.round_idx, "cohort_size": p.cohort_size,
                     "clients": len(p.clients), "dropped": len(p.dropped)}
            if p.staleness:
                attrs["staleness_max"] = max(p.staleness)
            self.record_span("round", track=track, t_sim=p.t_start,
                             dur_sim=p.round_time, **attrs)
        if not events:
            return
        heartbeats: Dict[int, int] = {}
        for t, kind, dev, rnd in trace.events:
            if kind == "heartbeat":
                heartbeats[rnd] = heartbeats.get(rnd, 0) + 1
                continue
            self.record_span(kind, track=f"{track}/events", t_sim=t,
                             dur_sim=0.0, kind="instant", device=dev,
                             round=rnd)
        round_end = {p.round_idx: p.t_end for p in trace.rounds}
        fallback = trace.rounds[-1].t_end if trace.rounds else 0.0
        for rnd, n in sorted(heartbeats.items()):
            self.record_span("heartbeats", track=f"{track}/events",
                             t_sim=float(round_end.get(rnd, fallback)),
                             dur_sim=0.0, kind="instant", round=rnd,
                             count=n)

    # ------------------------------------------------------------------
    def tracks(self) -> List[str]:
        return sorted({e.track for e in self.events})

    def summary(self) -> dict:
        return {"events": len(self.events), "dropped": self.dropped,
                "open_spans": len(self._stack), "tracks": self.tracks()}


# shared disabled tracer: thread it unconditionally, costs ~nothing
NULL_TRACER = Tracer(enabled=False)


# ---------------------------------------------------------------------------
# profiler coupling (profile=True tracers only; profiling imports torch, so
# it is imported on first use)
# ---------------------------------------------------------------------------

_ANNOTATIONS: Dict[int, Any] = {}


def _enter_profiler_annotation(rec: SpanRecord, name: str):
    from repro_torch.observability.profiling import trace_annotation

    cm = trace_annotation(name)
    cm.__enter__()
    _ANNOTATIONS[id(rec)] = cm


def _exit_profiler_annotation(rec: SpanRecord):
    cm = _ANNOTATIONS.pop(id(rec), None)
    if cm is not None:
        cm.__exit__(None, None, None)
