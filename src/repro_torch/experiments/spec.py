"""Declarative experiment specification, as ``repro.experiments.spec``.

An :class:`ExperimentSpec` is plain data: system names (registry keys of
:mod:`repro_torch.experiments.systems`), an architecture id (resolved
through :mod:`repro_torch.configs.registry`), the :class:`RunConfig`
bundle, a synthetic-data spec, optional feature sections, and round/epoch
budgets.  It serializes losslessly to JSON (``to_json`` / ``from_json``),
and ``to_dict`` gives the reference's dict for the same spec, so one
committed file drives either package.

The optional sections — transport, fault injection, streaming,
observability, the fleet and the adaptive cut — are kept here as data
(the reference's fields, defaults and checks).  The port cannot run them
yet, nor the buffered systems ``fedbuff`` and ``splitfed_pa``:
:meth:`ExperimentSpec.validate` names the ROADMAP.md queue item of each
one a spec asks for, and :func:`repro_torch.experiments.run_experiment`
refuses such a spec.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.configs.base import RunConfig

#: systems that train on a buffered-asynchronous schedule (plans carry
#: staleness) rather than replaying synchronous cohort rounds
ASYNC_SYSTEMS = frozenset({"fedbuff", "splitfed_pa"})

#: the reference's systems that wait for the fleet scheduler's async mode
#: (queue A5)
PENDING_SYSTEMS = frozenset({"fedbuff", "splitfed_pa"})

#: device classes of the fleet profiles (``repro.fleet.profiles``)
DEVICE_CLASSES = ("jetson-fast", "jetson-mid", "jetson-slow", "phone-5g",
                  "phone-3g")


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
# the optional sections (data only in the port)
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
    """How bytes move between device and server blocks (queue A6)."""

    kind: str = "inprocess"
    quorum_frac: float = 1.0
    max_attempts: int = 4
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    attempt_timeout_s: float = 1.0
    host: str = "127.0.0.1"     # socket mode only
    port: int = 7733            # socket mode only

    def validate(self) -> list:
        problems = []
        if self.kind not in ("inprocess", "socket"):
            problems.append(f"transport.kind={self.kind!r} not in "
                            "('inprocess', 'socket')")
        if not 0.0 < self.quorum_frac <= 1.0:
            problems.append(
                f"transport.quorum_frac={self.quorum_frac} outside (0, 1]")
        # the retry policy's own checks
        if self.max_attempts < 1:
            problems.append(
                f"transport.max_attempts={self.max_attempts} < 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            problems.append("transport backoff seconds must be >= 0")
        if self.attempt_timeout_s <= 0:
            problems.append(
                f"transport.attempt_timeout_s={self.attempt_timeout_s} <= 0")
        return problems


@dataclass(frozen=True)
class FaultSpec:
    """Fault-injection knobs, all probabilities per attempt (queue A6)."""

    seed: int = 0
    drop_prob: float = 0.0
    corrupt_prob: float = 0.0
    duplicate_prob: float = 0.0
    latency_spike_prob: float = 0.0
    latency_spike_s: float = 1.0
    reset_prob: float = 0.0
    torn_write_prob: float = 0.0
    perma_fail_devices: Tuple[int, ...] = ()

    def validate(self) -> list:
        problems = []
        for f in ("drop_prob", "corrupt_prob", "duplicate_prob",
                  "latency_spike_prob", "reset_prob", "torn_write_prob"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                problems.append(f"faults.{f}={v} outside [0, 1]")
        if self.latency_spike_s < 0:
            problems.append(f"faults.latency_spike_s={self.latency_spike_s}"
                            " negative")
        return problems


@dataclass(frozen=True)
class StreamingSpec:
    """The activation ring between the upload and the server phase
    (queue A6)."""

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
    """Span tracing and phase/round metrics (queue A6)."""

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


@dataclass(frozen=True)
class FleetConfig:
    """Population, churn and cohort policy of one fleet simulation
    (``repro.fleet.profiles.FleetConfig``; queue A5)."""

    n_devices: int = 200
    class_mix: Tuple[Tuple[str, float], ...] = (
        ("jetson-fast", 0.35), ("jetson-mid", 0.25), ("jetson-slow", 0.15),
        ("phone-5g", 0.15), ("phone-3g", 0.10))
    seed: int = 0
    mean_session_rounds: float = 20.0
    mean_off_rounds: float = 6.0
    p_online0: float = 0.75
    dropout_hazard: float = 0.02
    latency_jitter: float = 0.05
    heartbeat_interval_rounds: float = 0.5
    heartbeat_timeout_rounds: float = 1.5
    heartbeat_loss_prob: float = 0.1
    deadline_factor: float = 0.0
    min_cohort: int = 4
    max_cohort: int = 32
    init_cohort: int = 16
    target_round_time_factor: float = 0.0
    async_buffer_size: int = 0
    max_staleness: int = 0
    max_concurrent: int = 0
    quorum_frac: float = 1.0
    shared_uplink: bool = False


@dataclass(frozen=True)
class CutPolicy:
    """How the cut layer is chosen (``repro.fleet.cuts.CutPolicy``;
    queue A5).  ``max_cut = 0`` means the deepest legal cut."""

    mode: str = "static"              # static | per_profile
    objective: str = "epoch_time"     # reserved for future objectives
    min_cut: int = 1
    max_cut: int = 0
    overrides: Tuple[Tuple[str, int], ...] = ()

    def validate(self, num_layers: Optional[int] = None) -> list:
        problems = []
        if self.mode not in ("static", "per_profile"):
            problems.append(f"cut.mode {self.mode!r} not in static|per_profile")
        if self.objective != "epoch_time":
            problems.append(f"cut.objective {self.objective!r} unsupported")
        if self.min_cut < 1:
            problems.append(f"cut.min_cut {self.min_cut} < 1")
        if self.max_cut < 0:
            problems.append(f"cut.max_cut {self.max_cut} < 0")
        if self.max_cut and self.max_cut < self.min_cut:
            problems.append(
                f"cut.max_cut {self.max_cut} < cut.min_cut {self.min_cut}")
        hi = num_layers - 1 if num_layers else None
        if hi is not None:
            if self.min_cut > hi:
                problems.append(
                    f"cut.min_cut {self.min_cut} outside [1, {hi}]")
            if self.max_cut > hi:
                problems.append(
                    f"cut.max_cut {self.max_cut} outside [1, {hi}]")
        for name, p in self.overrides:
            if name not in DEVICE_CLASSES:
                problems.append(f"cut.overrides: unknown device class {name!r}")
            if p < 1 or (hi is not None and p > hi):
                problems.append(
                    f"cut.overrides[{name!r}] = {p} outside "
                    f"[1, {hi if hi is not None else '?'}]")
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
        reference, plus one problem for each feature the port cannot run
        yet, naming its ROADMAP.md queue item."""
        from repro_torch.configs import registry
        from repro_torch.configs.base import VisionConfig
        from repro_torch.experiments.systems import list_systems

        problems = []
        if not self.name:
            problems.append("spec.name must be non-empty")
        if not self.systems:
            problems.append("spec.systems must name at least one system")
        known = set(list_systems())
        for s in self.systems:
            if s in PENDING_SYSTEMS:
                problems.append(
                    f"system {s!r} is not ported yet (ROADMAP.md queue A5, "
                    "the buffered baselines on the fleet scheduler's async "
                    f"mode); ported: {sorted(known)}")
            elif s not in known:
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
            if not isinstance(cfg, VisionConfig) and (
                    cfg.moe.enabled or cfg.attn_layer_period):
                problems.append(
                    f"arch {self.arch!r} ({cfg.family}) is not ported yet "
                    "(ROADMAP.md queue A7)")
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
        # features the port cannot run yet, one problem each
        pending = (
            ("fleet", self.fleet, "A5 (fleet and heterogeneous cuts)"),
            ("trace_path", self.trace_path,
             "A5 (fleet and heterogeneous cuts)"),
            ("cut", self.cut if self.cut is None or self.cut.mode != "static"
             else None, "A5 (fleet and heterogeneous cuts)"),
            ("transport", self.transport,
             "A6 (transport, streaming, observability)"),
            ("faults", self.faults,
             "A6 (transport, streaming, observability)"),
            ("observability", self.observability,
             "A6 (transport, streaming, observability)"),
            ("streaming", self.streaming,
             "A6 (transport, streaming, observability)"),
        )
        for name, value, item in pending:
            if value is not None:
                problems.append(f"spec.{name} is set but the port cannot "
                                f"run it yet (ROADMAP.md queue {item})")
        return problems
