"""System registry: every trainable algorithm behind one protocol, as
``repro.experiments.systems``.

A *system* is one end-to-end training pipeline.  Each is a thin adapter
over the trainers in :mod:`repro_torch.core`, which own the steps and the
per-phase loops (driven by the shared
:class:`~repro_torch.experiments.runner.Runner`); :meth:`System.run`
composes them into the full pipeline for one :class:`SystemContext`.
``@register_system("name")`` makes a system addressable from an
:class:`~repro_torch.experiments.spec.ExperimentSpec`.

The port registers every system of the reference: ``"ampere"``
(i.i.d. cohorts, or a fleet trace's, at one cut or a cut per device
class), the synchronous baselines — the SFL family (``splitfed``,
``splitfed_mb``, ``splitfedv2``, ``splitgp``, ``scaffold``, ``pipar``)
and ``fedavg`` — which replay a shared fleet trace through
:func:`replay_plan`, and the buffered ones (``fedbuff``,
``splitfed_pa``), whose asynchronous schedule :func:`fedbuff_schedule`
derives from the same device population.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Type

import torch

from repro_torch.data.activation_store import ActivationStore
from repro_torch.fleet.profiles import make_latency_fn, trace_round_times


@dataclasses.dataclass
class SystemContext:
    """Everything a system needs to run, resolved to live objects.

    ``gen`` is the model-init generator; ``None`` seeds a CPU one from
    ``run_cfg.seed`` (where the reference takes a PRNG key), so a run
    starts from the same init on the card and on the CPU.
    """

    model: Any
    run_cfg: Any
    clients: List[Any]
    eval_data: Any
    workdir: Optional[str] = None
    trace: Any = None              # FleetTrace: shared-schedule replay
    population: Any = None         # Sequence[DeviceProfile]: trace pricing
    fleet_cfg: Any = None          # FleetConfig: async knobs for fedbuff
    max_rounds: Optional[int] = None
    max_server_epochs: Optional[int] = None
    patience: int = 15
    log_echo: bool = False
    gen: Optional[torch.Generator] = None
    trainer: Any = None            # reuse a live trainer
    device: Any = None             # None = CUDA (raises without a card)
    cuts: Any = None               # CutAssignment (None/uniform = one cut)
    transport: Any = None          # InProcessTransport (None = analytic)
    quorum_frac: float = 1.0       # verified-upload fraction closing a round
    obs: Any = None                # Observability bundle (None = NULL_OBS)
    streaming: Any = None          # StreamingSpec (None = serialized store)

    @property
    def seq_len(self) -> int:
        if self.model.kind != "lm":
            return 0
        return int(self.clients[0].dataset.arrays["tokens"].shape[1])


class System:
    """Protocol every registered system implements.

    ``init_state(ctx, gen)`` builds the initial trainable state;
    ``run(ctx)`` executes the full pipeline and returns a result dict
    whose ``"history"`` follows the shared schema (per-round / per-epoch
    records + ``comm_bytes`` + ``sim_time``).  ``on_start`` /
    ``on_finish`` are lifecycle hooks (no-ops by default).
    """

    name: str = "?"

    def init_state(self, ctx: SystemContext, gen):
        raise NotImplementedError

    def run(self, ctx: SystemContext) -> dict:
        raise NotImplementedError

    def on_start(self, ctx: SystemContext):
        pass

    def on_finish(self, ctx: SystemContext, result: dict):
        pass


_REGISTRY: Dict[str, Type[System]] = {}


def register_system(name: str):
    """Class decorator: make a :class:`System` spec-addressable."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_system(name: str) -> Type[System]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown system {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_systems() -> list:
    return sorted(_REGISTRY)


def _seeded(tr, ctx: SystemContext) -> torch.Generator:
    """``ctx.gen``, or a CPU generator seeded from ``run.seed``."""
    if ctx.gen is not None:
        return ctx.gen
    return torch.Generator().manual_seed(tr.run.seed)


def _rounds(tr, ctx: SystemContext) -> int:
    return ctx.max_rounds if ctx.max_rounds is not None \
        else tr.run.fed.device_epochs


def replay_plan(ctx: SystemContext, *, algo: str) -> Optional[list]:
    """Cohort plan replaying ``ctx.trace`` under ``algo``'s cost model:
    the trace decided once who is online, picked and dropped; each
    baseline re-prices every round's clock for its own exchange on the
    same device profiles (a synchronous round = its slowest surviving
    participant).  Without a population the plan falls back to the
    replaying trainer's analytic pricing (``as_cohort`` drops the trace's
    Ampere-priced ``round_time`` on purpose)."""
    if ctx.trace is None:
        return None
    if ctx.population is None:
        return [p.as_cohort() for p in ctx.trace.rounds]
    lat = make_latency_fn(ctx.model, ctx.run_cfg, algo=algo,
                          seq_len=ctx.seq_len)
    times = trace_round_times(ctx.trace, ctx.population, lat)
    return [dict(p.as_cohort(), round_time=t)
            for p, t in zip(ctx.trace.rounds, times)]


def fedbuff_schedule(ctx: SystemContext, rounds: int, *,
                     algo: str = "ampere"):
    """The buffered-async schedule a buffered system trains on.

    A trace that is already async (plans carry staleness) is replayed as
    it is.  Otherwise the schedule is derived from the device population
    the synchronous systems share: the spec's fleet config (its async
    knobs defaulted when unset) drives the scheduler's async mode with
    ``algo``'s per-round pricing (Ampere for fedbuff, SplitFed for
    splitfed_pa), so a comparison holds all but the aggregation
    discipline fixed.  Deterministic in the spec, so a resumed run
    derives the same schedule."""
    from repro_torch.fleet import FleetConfig, FleetScheduler

    if ctx.trace is not None and ctx.trace.is_async:
        return ctx.trace
    if ctx.population is None:
        raise ValueError(
            "fedbuff needs an async trace or a device population to "
            "derive one from — set spec.fleet (or point trace_path at a "
            "trace simulated with async_buffer_size > 0)")
    fcfg = ctx.fleet_cfg if ctx.fleet_cfg is not None else \
        FleetConfig(n_devices=len(ctx.population))
    if fcfg.async_buffer_size <= 0:
        fcfg = dataclasses.replace(
            fcfg, async_buffer_size=max(2, fcfg.init_cohort // 2))
    lat = make_latency_fn(ctx.model, ctx.run_cfg, algo=algo,
                          seq_len=ctx.seq_len)
    trace = FleetScheduler(ctx.population, lat, fcfg).simulate(rounds)
    if ctx.obs is not None and ctx.obs.enabled:
        # the derived buffered schedule gets its own scheduler subtrack
        # (run_experiment ingested the shared sync trace)
        ctx.obs.tracer.ingest_fleet_trace(trace, track="scheduler/async",
                                          events=False)
    return trace


@register_system("ampere")
class AmpereSystem(System):
    """The paper's system: federated device phase (i.i.d. or a fleet
    trace's cohorts), one-shot activation consolidation, centralized
    server phase."""

    def _trainer(self, ctx: SystemContext):
        from repro_torch.core.uit import AmpereTrainer
        if ctx.trainer is None:
            ctx.trainer = AmpereTrainer(
                ctx.model, ctx.run_cfg, ctx.clients, ctx.eval_data,
                workdir=ctx.workdir, patience=ctx.patience,
                log_echo=ctx.log_echo, device=ctx.device, cuts=ctx.cuts,
                transport=ctx.transport, quorum_frac=ctx.quorum_frac,
                obs=ctx.obs)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        dev, srv, aux = tr._init_states(gen if gen is not None
                                        else _seeded(tr, ctx))
        return {"device": dev, "aux": aux}, srv

    def _device_phase(self, tr, ctx: SystemContext, dev_state):
        """Phase 3 (:class:`FedBuffSystem` buffers it)."""
        if ctx.trace is not None:
            return tr.run_fleet_device_phase(dev_state, ctx.trace,
                                             ctx.max_rounds)
        return tr.run_device_phase(dev_state, ctx.max_rounds)

    def _make_store(self, tr, ctx: SystemContext):
        """The consolidation store of the upload and the server phase: the
        streaming ring when the spec asks for it (a memmap ring under
        ``<workdir>/ring``; without a workdir the in-RAM ring, whose
        history is the same; the transport's fault plan tears its
        writes), else the serialized store, whose shards a workdir also
        persists under ``acts/``."""
        sp = ctx.streaming
        if sp is not None and sp.enabled:
            from repro_torch.streaming import StreamingActivationStore

            ring_dir = (os.path.join(tr.workdir, "ring") if tr.workdir
                        else None)
            return StreamingActivationStore(
                directory=ring_dir,
                quantize_int8=tr.run.split.quantize_activations,
                seed=tr.run.seed, capacity_segments=sp.capacity_segments,
                low_watermark=sp.low_watermark,
                backend=(sp.backend if sp.backend != "memmap" or ring_dir
                         else "memory"),
                drain_chunk=sp.drain_chunk,
                interleave_seed=sp.interleave_seed,
                fault_plan=(ctx.transport.fault_plan
                            if ctx.transport is not None else None),
                obs=tr.obs)
        return ActivationStore(
            directory=(os.path.join(tr.workdir, "acts")
                       if tr.workdir else None),
            quantize_int8=tr.run.split.quantize_activations,
            seed=tr.run.seed)

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        dev, srv, aux = tr._init_states(_seeded(tr, ctx))
        dev_state = self._device_phase(tr, ctx, {"device": dev, "aux": aux})
        store = self._make_store(tr, ctx)
        bw = None
        if ctx.population is not None:
            bw = {p.device_id: p.bandwidth_bps for p in ctx.population}
        # a fleet's devices each push their shard on their own link
        tr.generate_activations(
            dev_state, store,
            upload="parallel" if ctx.trace is not None else "serial",
            client_bandwidth_bps=bw)
        srv_state = tr.run_server_phase(dev_state, srv, store,
                                        ctx.max_server_epochs)
        merged = tr.merged_params(dev_state, srv_state["server"])
        return {"device_state": dev_state, "server_state": srv_state,
                "merged_params": merged, "store": store,
                "history": tr.history}


@register_system("fedbuff")
class FedBuffSystem(AmpereSystem):
    """Buffered semi-synchronous aggregation (FedBuff) on the Ampere
    pipeline: the async device phase (the server folds staleness-weighted
    deltas every ``async_buffer_size`` completions), then the inherited
    one-shot upload and server phase."""

    def _trainer(self, ctx: SystemContext):
        from repro_torch.core.baselines import FedBuffTrainer
        if ctx.trainer is None:
            ctx.trainer = FedBuffTrainer(
                ctx.model, ctx.run_cfg, ctx.clients, ctx.eval_data,
                workdir=ctx.workdir, patience=ctx.patience,
                log_echo=ctx.log_echo, device=ctx.device,
                transport=ctx.transport, quorum_frac=ctx.quorum_frac,
                obs=ctx.obs)
        return ctx.trainer

    def _device_phase(self, tr, ctx: SystemContext, dev_state):
        trace = fedbuff_schedule(ctx, _rounds(tr, ctx))
        return tr.run_buffered_device_phase(dev_state, trace,
                                            ctx.max_rounds)


class SFLSystem(System):
    """SFL-family baselines: per-iteration activation/gradient exchange,
    one shared round loop (the ``make_sfl_round_step`` variants)."""

    variant = "splitfed"

    def _trainer(self, ctx: SystemContext):
        from repro_torch.core.baselines import SFLTrainer
        if ctx.trainer is None:
            ctx.trainer = SFLTrainer(
                ctx.model, ctx.run_cfg, ctx.clients, ctx.eval_data,
                variant=self.variant, workdir=ctx.workdir,
                patience=ctx.patience, log_echo=ctx.log_echo,
                device=ctx.device, transport=ctx.transport,
                quorum_frac=ctx.quorum_frac, obs=ctx.obs)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        return tr._init_state(gen if gen is not None else _seeded(tr, ctx))

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        return tr.run_rounds(_rounds(tr, ctx), gen=_seeded(tr, ctx),
                             cohort_plan=replay_plan(ctx,
                                                     algo=self.variant))


@register_system("splitfed")
class SplitFedSystem(SFLSystem):
    variant = "splitfed"


@register_system("splitfed_mb")
class SplitFedMBSystem(SFLSystem):
    """Minibatch-SGD SplitFed: the cohort's joint gradients are
    weight-averaged before every SGD step; SplitFed's exchange volume."""

    variant = "splitfed_mb"


@register_system("splitfed_pa")
class SplitFedPASystem(SFLSystem):
    """Collaborative / parallel-aggregation SplitFed: SplitFed's
    per-iteration exchange, the server folding buffered client deltas
    asynchronously (staleness-weighted) instead of barriering the cohort
    each round.  Its buffered schedule comes from the fleet scheduler
    with SplitFed's per-round pricing, so splitfed vs splitfed_pa isolates
    the aggregation discipline."""

    variant = "splitfed_pa"

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        rounds = _rounds(tr, ctx)
        trace = fedbuff_schedule(ctx, rounds, algo="splitfed")
        # the plans' weights carry the 1/sqrt(1+s) scaling, and their
        # round_time is the scheduler's overlapped aggregation interval,
        # trusted rather than re-priced
        plan = [dict(p.as_cohort(), round_time=p.round_time)
                for p in trace.rounds]
        return tr.run_rounds(rounds, gen=_seeded(tr, ctx), cohort_plan=plan)


@register_system("splitfedv2")
class SplitFedV2System(SFLSystem):
    variant = "splitfedv2"


@register_system("splitgp")
class SplitGPSystem(SFLSystem):
    variant = "splitgp"


@register_system("scaffold")
class ScaffoldSystem(SFLSystem):
    variant = "scaffold"


@register_system("pipar")
class PiParSystem(SFLSystem):
    variant = "pipar"


@register_system("fedavg")
class FedAvgSystem(System):
    """Classic FL: the whole model trains on-device, FedAvg'd per round."""

    def _trainer(self, ctx: SystemContext):
        from repro_torch.core.baselines import FedAvgTrainer
        if ctx.trainer is None:
            ctx.trainer = FedAvgTrainer(
                ctx.model, ctx.run_cfg, ctx.clients, ctx.eval_data,
                workdir=ctx.workdir, patience=ctx.patience,
                log_echo=ctx.log_echo, device=ctx.device,
                transport=ctx.transport, quorum_frac=ctx.quorum_frac,
                obs=ctx.obs)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        return tr._init_params(gen if gen is not None else _seeded(tr, ctx))

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        return tr.run_rounds(_rounds(tr, ctx), gen=_seeded(tr, ctx),
                             cohort_plan=replay_plan(ctx, algo="fedavg"))
