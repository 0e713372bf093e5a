"""System registry: every trainable algorithm behind one protocol, as
``repro.experiments.systems``.

A *system* is one end-to-end training pipeline.  Each is a thin adapter
over the trainers in :mod:`repro_torch.core`, which own the steps and the
per-phase loops (driven by the shared
:class:`~repro_torch.experiments.runner.Runner`); :meth:`System.run`
composes them into the full pipeline for one :class:`SystemContext`.
``@register_system("name")`` makes a system addressable from an
:class:`~repro_torch.experiments.spec.ExperimentSpec`.

The port registers ``"ampere"`` (static cut, i.i.d. cohorts) and the
synchronous baselines: the SFL family (``splitfed``, ``splitfed_mb``,
``splitfedv2``, ``splitgp``, ``scaffold``, ``pipar``) and ``fedavg``.
Without a fleet trace the reference's ``replay_plan`` is ``None``, so
each baseline runs its i.i.d. cohorts here too.  The buffered systems
(``fedbuff``, ``splitfed_pa``) take their schedule from the fleet
scheduler's async mode, and fleet-trace replay is the fleet slice: both
are ROADMAP.md queue A5.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Type

import torch

from repro_torch.data.activation_store import ActivationStore


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
    max_rounds: Optional[int] = None
    max_server_epochs: Optional[int] = None
    patience: int = 15
    log_echo: bool = False
    gen: Optional[torch.Generator] = None
    trainer: Any = None            # reuse a live trainer
    device: Any = None             # None = CUDA (raises without a card)

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


@register_system("ampere")
class AmpereSystem(System):
    """The paper's system: federated device phase, one-shot activation
    consolidation, centralized server phase."""

    def _trainer(self, ctx: SystemContext):
        from repro_torch.core.uit import AmpereTrainer
        if ctx.trainer is None:
            ctx.trainer = AmpereTrainer(
                ctx.model, ctx.run_cfg, ctx.clients, ctx.eval_data,
                workdir=ctx.workdir, patience=ctx.patience,
                log_echo=ctx.log_echo, device=ctx.device)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        dev, srv, aux = tr._init_states(gen if gen is not None
                                        else _seeded(tr, ctx))
        return {"device": dev, "aux": aux}, srv

    def _make_store(self, tr, ctx: SystemContext):
        """The consolidation store of the upload and the server phase;
        with a workdir its shards are also persisted under ``acts/``."""
        return ActivationStore(
            directory=(os.path.join(tr.workdir, "acts")
                       if tr.workdir else None),
            quantize_int8=tr.run.split.quantize_activations,
            seed=tr.run.seed)

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        dev, srv, aux = tr._init_states(_seeded(tr, ctx))
        dev_state = tr.run_device_phase({"device": dev, "aux": aux},
                                        ctx.max_rounds)
        store = self._make_store(tr, ctx)
        tr.generate_activations(dev_state, store)
        srv_state = tr.run_server_phase(dev_state, srv, store,
                                        ctx.max_server_epochs)
        merged = tr.merged_params(dev_state, srv_state["server"])
        return {"device_state": dev_state, "server_state": srv_state,
                "merged_params": merged, "store": store,
                "history": tr.history}


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
                device=ctx.device)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        return tr._init_state(gen if gen is not None else _seeded(tr, ctx))

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        rounds = ctx.max_rounds if ctx.max_rounds is not None \
            else tr.run.fed.device_epochs
        return tr.run_rounds(rounds, gen=_seeded(tr, ctx))


@register_system("splitfed")
class SplitFedSystem(SFLSystem):
    variant = "splitfed"


@register_system("splitfed_mb")
class SplitFedMBSystem(SFLSystem):
    """Minibatch-SGD SplitFed: the cohort's joint gradients are
    weight-averaged before every SGD step; SplitFed's exchange volume."""

    variant = "splitfed_mb"


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
                log_echo=ctx.log_echo, device=ctx.device)
        return ctx.trainer

    def init_state(self, ctx: SystemContext, gen=None):
        tr = self._trainer(ctx)
        return tr._init_params(gen if gen is not None else _seeded(tr, ctx))

    def run(self, ctx: SystemContext) -> dict:
        tr = self._trainer(ctx)
        rounds = ctx.max_rounds if ctx.max_rounds is not None \
            else tr.run.fed.device_epochs
        return tr.run_rounds(rounds, gen=_seeded(tr, ctx))
