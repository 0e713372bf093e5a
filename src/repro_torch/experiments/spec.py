"""Declarative experiment specification, as ``repro.experiments.spec``.

An :class:`ExperimentSpec` is plain data: system names (registry keys of
:mod:`repro_torch.experiments.systems`), an architecture id (resolved
through :mod:`repro_torch.configs.registry`), the :class:`RunConfig`
bundle, a synthetic-data spec, optional feature sections, and round/epoch
budgets.  It serializes losslessly to JSON (``to_json`` / ``from_json``),
and ``to_dict`` gives the reference's dict for the same spec, so one
committed file drives either package.

A spec may name a fleet (``fleet``, a
:class:`~repro_torch.fleet.FleetConfig`, and/or ``trace_path``, a JSONL
trace): every system then replays one shared churn trace, as in the
reference, and a ``cut`` (:class:`~repro_torch.fleet.cuts.CutPolicy`)
may give each device class of that fleet its own cut layer.  A
``transport`` (in process, or ``socket``: the two-process roles of
:mod:`repro_torch.transport.roles`), ``faults``
(:class:`~repro_torch.transport.FaultSpec`), ``observability`` and
``streaming`` (the activation ring) run as the reference's do.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.configs.base import RunConfig
from repro_torch.fleet.cuts import CutPolicy
from repro_torch.fleet.profiles import FleetConfig
from repro_torch.transport.faults import FaultSpec
from repro_torch.transport.retry import RetryPolicy

#: systems that train on a buffered-asynchronous schedule (plans carry
#: staleness) rather than replaying synchronous cohort rounds
ASYNC_SYSTEMS = frozenset({"fedbuff", "splitfed_pa"})


# ---------------------------------------------------------------------------
# generic frozen-dataclass <-> JSON-dict codec
# ---------------------------------------------------------------------------


def _tuplify(value):
    """JSON arrays -> (nested) tuples, matching the frozen configs."""
    if isinstance(value, list):
        return tuple(_tuplify(v) for v in value)
    return value


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def dataclass_from_dict(cls, data: dict):
    """Build ``cls`` from a (possibly partial) plain dict.

    Missing fields keep their defaults; nested dataclass fields recurse;
    list values become tuples.  Unknown keys raise, so a typo in a
    committed spec fails loudly instead of silently using the default.
    """
    if not isinstance(data, dict):
        raise TypeError(f"{cls.__name__} spec section must be a dict, "
                        f"got {type(data).__name__}")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} field(s): {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        tp = _unwrap_optional(hints[f.name])
        if dataclasses.is_dataclass(tp) and isinstance(value, dict):
            value = dataclass_from_dict(tp, value)
        else:
            value = _tuplify(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def dataclass_to_dict(obj) -> dict:
    """``dataclasses.asdict`` (tuples serialize as JSON arrays)."""
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# the optional sections
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataSpec:
    """Synthetic dataset sizes and seeds; the partition shape
    (num_clients, dirichlet_alpha) lives in ``run.fed``."""

    train_samples: int = 1536
    eval_samples: int = 384
    seq_len: int = 0            # LM archs only; 0 = dataset default
    train_seed: int = 0
    eval_seed: int = 1
    partition_seed: int = 0


@dataclass(frozen=True)
class TransportSpec:
    """How bytes move between device and server blocks.  ``inprocess``
    prices transfers through the simulated link; ``socket`` is the
    two-process mode of ``python -m repro_torch.launch.run_experiment
    --role device|server``.  The retry knobs map onto one
    :class:`~repro_torch.transport.RetryPolicy` shared by every transfer,
    and ``quorum_frac`` is the fraction of a cohort whose uploads must
    verify before a round closes."""

    kind: str = "inprocess"
    quorum_frac: float = 1.0
    max_attempts: int = 4
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    attempt_timeout_s: float = 1.0
    host: str = "127.0.0.1"     # socket mode only
    port: int = 7733            # socket mode only

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_attempts=self.max_attempts,
                           base_backoff_s=self.base_backoff_s,
                           max_backoff_s=self.max_backoff_s,
                           attempt_timeout_s=self.attempt_timeout_s)

    def validate(self) -> list:
        problems = []
        if self.kind not in ("inprocess", "socket"):
            problems.append(f"transport.kind={self.kind!r} not in "
                            "('inprocess', 'socket')")
        if not 0.0 < self.quorum_frac <= 1.0:
            problems.append(
                f"transport.quorum_frac={self.quorum_frac} outside (0, 1]")
        problems.extend(self.retry_policy().validate())
        return problems


@dataclass(frozen=True)
class StreamingSpec:
    """Actor/learner streaming: Ampere's upload goes through the activation
    ring (:class:`~repro_torch.streaming.StreamingActivationStore`):
    CRC'd segments (memmap-backed under a persisted workdir, else in
    RAM), watermark backpressure at ``capacity_segments`` /
    ``low_watermark``, and server epochs whose accounted ``sim_time``
    overlaps the rest of the device round (``overlap_s`` in the phase
    table).  The history is the serialized run's but for ``sim_time``,
    which can only shrink.  ``drain_chunk`` / ``interleave_seed`` seed
    the single-process producer/consumer interleaving."""

    enabled: bool = True
    backend: str = "memmap"          # falls back to "memory" w/o a workdir
    capacity_segments: int = 64      # committed-but-unconsumed bound
    low_watermark: Optional[int] = None   # gate reopen level (None = cap/2)
    drain_chunk: int = 4             # learner segments per stall (seeded x2)
    interleave_seed: int = 0

    def validate(self) -> list:
        problems = []
        if self.backend not in ("memmap", "memory"):
            problems.append(f"streaming.backend={self.backend!r} not in "
                            "('memmap', 'memory')")
        if self.capacity_segments < 2:
            problems.append(f"streaming.capacity_segments="
                            f"{self.capacity_segments} < 2")
        if self.low_watermark is not None and not \
                0 <= self.low_watermark < self.capacity_segments:
            problems.append(
                f"streaming.low_watermark={self.low_watermark} outside "
                f"[0, capacity_segments)")
        if self.drain_chunk < 1:
            problems.append(f"streaming.drain_chunk={self.drain_chunk} < 1")
        return problems


@dataclass(frozen=True)
class ObservabilitySpec:
    """Span tracing and phase/round metrics; ``profile`` couples the
    spans to ``torch.profiler`` and NVTX ranges."""

    enabled: bool = True
    trace_json: bool = True      # export Chrome trace-event JSON
    span_log: bool = True        # export CRC'd span JSONL
    scheduler_events: bool = True  # ingest fleet-trace heap events
    max_events: int = 250_000    # per-system event cap (then dropped+counted)
    profile: bool = False        # couple spans to profiler annotations

    def validate(self) -> list:
        problems = []
        if self.max_events < 1:
            problems.append(
                f"observability.max_events={self.max_events} < 1")
        return problems


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExperimentSpec:
    """One declarative experiment: systems x (model, data, budgets)."""

    name: str = "experiment"
    systems: Tuple[str, ...] = ("ampere",)
    arch: str = "mobilenet-l"
    smoke: bool = True               # registry smoke config vs full config
    run: RunConfig = field(default_factory=RunConfig)
    data: DataSpec = field(default_factory=DataSpec)
    trace_path: Optional[str] = None
    fleet: Optional[FleetConfig] = None
    cut: Optional[CutPolicy] = None
    # budgets
    max_rounds: Optional[int] = None          # None = run.fed.device_epochs
    max_server_epochs: Optional[int] = None   # None = run.fed.server_epochs
    patience: int = 15
    # outputs
    results_dir: Optional[str] = None         # None = results/<name>
    persist: bool = False       # give each system a workdir (ckpt + journal)
    transport: Optional[TransportSpec] = None
    faults: Optional[FaultSpec] = None
    observability: Optional[ObservabilitySpec] = None
    streaming: Optional[StreamingSpec] = None

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclass_to_dict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, data: dict) -> "ExperimentSpec":
        return dataclass_from_dict(cls, data)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------------
    def validate(self) -> list:
        """Human-readable problems (empty = valid): every check of the
        reference."""
        from repro_torch.configs import registry
        from repro_torch.experiments.systems import list_systems

        problems = []
        if not self.name:
            problems.append("spec.name must be non-empty")
        if not self.systems:
            problems.append("spec.systems must name at least one system")
        known = set(list_systems())
        for s in self.systems:
            if s not in known:
                problems.append(
                    f"unknown system {s!r}; registered: {sorted(known)}")
        num_layers = None
        if self.arch not in registry.list_archs():
            problems.append(f"unknown arch {self.arch!r}; known: "
                            f"{registry.list_archs()}")
        else:
            cfg = registry.get_smoke_config(self.arch) if self.smoke \
                else registry.get_config(self.arch)
            num_layers = cfg.num_layers
            sp = self.run.split.split_point
            if not 1 <= sp <= num_layers - 1:
                problems.append(
                    f"run.split.split_point={sp} outside [1, "
                    f"{num_layers - 1}] for arch {self.arch!r} "
                    f"({num_layers} layers: the device block needs at "
                    "least one layer and the server block keeps one)")
        if self.cut is not None:
            problems.extend(self.cut.validate(num_layers))
            if self.cut.mode == "per_profile" and self.fleet is None:
                problems.append(
                    "cut.mode='per_profile' needs a fleet section — the "
                    "device classes whose cost frontier picks each cut")
        if self.data.train_samples <= 0 or self.data.eval_samples <= 0:
            problems.append("data.train_samples / eval_samples must be > 0")
        if self.max_rounds is not None and self.max_rounds < 1:
            problems.append("max_rounds must be >= 1 (or null)")
        if self.max_server_epochs is not None and self.max_server_epochs < 1:
            problems.append("max_server_epochs must be >= 1 (or null)")
        if self.run.fed.num_clients < self.run.fed.clients_per_round:
            problems.append("run.fed.num_clients < clients_per_round")
        async_systems = sorted(set(self.systems) & ASYNC_SYSTEMS)
        if async_systems and self.fleet is None and \
                self.trace_path is None:
            problems.append(
                f"system(s) {async_systems} need a fleet section (their "
                "buffered schedule is derived from the device population) "
                "or a trace_path pointing at an async trace")
        if self.fleet is not None and (
                self.fleet.async_buffer_size < 0
                or self.fleet.max_staleness < 0
                or self.fleet.max_concurrent < 0):
            problems.append("fleet async knobs (async_buffer_size, "
                            "max_staleness, max_concurrent) must be >= 0")
        for section in (self.transport, self.faults, self.observability,
                        self.streaming):
            if section is not None:
                problems.extend(section.validate())
        if self.fleet is not None and \
                not 0.0 < self.fleet.quorum_frac <= 1.0:
            problems.append(
                f"fleet.quorum_frac={self.fleet.quorum_frac} outside (0, 1]")
        if self.fleet is not None and \
                self.fleet.n_devices != self.run.fed.num_clients:
            problems.append(
                f"fleet.n_devices ({self.fleet.n_devices}) must equal "
                f"run.fed.num_clients ({self.run.fed.num_clients}) — trace "
                "device ids index the federated clients")
        if self.trace_path is not None and self.fleet is None and \
                not os.path.exists(self.trace_path):
            problems.append(
                f"trace_path {self.trace_path!r} does not exist and no "
                "fleet config was given to regenerate it")
        if self.trace_path is not None and os.path.exists(self.trace_path):
            from repro_torch.fleet.scheduler import FleetTrace
            try:
                trace_async = FleetTrace.peek_is_async(self.trace_path)
            except Exception:
                trace_async = None   # unreadable; load() will raise loudly
            sync_systems = [s for s in self.systems
                            if s not in ASYNC_SYSTEMS]
            if trace_async and sync_systems:
                problems.append(
                    f"trace_path {self.trace_path!r} is a buffered-async "
                    f"trace but {sync_systems} replay rounds "
                    "synchronously — staleness-weighted buffer groups are "
                    "not synchronous cohorts; give the sync systems a sync "
                    "trace (or a fleet section to regenerate one)")
            if trace_async is False and async_systems and \
                    self.fleet is None:
                problems.append(
                    f"system(s) {async_systems} with a synchronous "
                    "trace_path need a fleet section too — their buffered "
                    "schedule is derived from the device population")
        return problems
