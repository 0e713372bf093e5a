"""``run_experiment(spec)`` — one declarative entry point for every
system, as ``repro.experiments.api``.

Resolves an :class:`~repro_torch.experiments.spec.ExperimentSpec` into
live objects (model from the arch registry, synthetic non-IID data, an
optional JSONL-loaded or simulated fleet trace and its device population)
and runs every listed system on them in turn, writing one results
directory with a ``summary.json`` plus ``<system>_history.json`` files.
A per-profile cut policy resolves to a cut per device class
(:func:`resolve_cut_policy`).  A ``transport`` / ``faults`` section gives
each system its own fault-injecting transport (:func:`build_transport`),
an ``observability`` section its own tracer and metrics, whose phase
table, trace digest and exported artifacts land in the summary, and a
``streaming`` section routes Ampere's upload through the activation ring.
A socket transport prices its transfers here as the in-process one does
(the reference's behaviour); its two processes are the roles of
:mod:`repro_torch.transport.roles`.  Runs on
CUDA unless ``device="cpu"``.  The command line is
``python -m repro_torch.launch.run_experiment``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

from repro_torch.experiments.spec import ExperimentSpec, TransportSpec
from repro_torch.experiments.systems import SystemContext, get_system
from repro_torch.observability import Observability


def _history_summary(history: dict) -> dict:
    """Small cross-system summary of one history dict."""
    out = {"comm_bytes": int(history.get("comm_bytes", 0)),
           "sim_time_s": float(history.get("sim_time", 0.0))}
    # precedence: server (Ampere's merged-model eval) > rounds > device
    # (the device phase evaluates only the auxiliary head)
    for key in ("server", "rounds", "device"):
        recs = history.get(key)
        if recs:
            out[f"num_{key}"] = len(recs)
            if "final_val_loss" not in out:
                out["final_val_loss"] = recs[-1].get("val_loss")
                out["final_val_acc"] = recs[-1].get("val_acc")
    return out


def resolve_setup(spec: ExperimentSpec):
    """The shared (spec, model, clients, eval_data) of a spec,
    deterministic in the spec.  ``run.arch`` is synced to the canonical
    ``spec.arch`` on the way, so the spec comes back too."""
    from repro_torch.configs import registry
    from repro_torch.data import federate, make_dataset_for_model
    from repro_torch.models import build_model

    if spec.run.arch != spec.arch:
        spec = dataclasses.replace(
            spec, run=dataclasses.replace(spec.run, arch=spec.arch))
    cfg = registry.get_smoke_config(spec.arch) if spec.smoke \
        else registry.get_config(spec.arch)
    model = build_model(cfg)
    data_kw = {"seq_len": spec.data.seq_len} if (
        model.kind == "lm" and spec.data.seq_len) else {}
    train = make_dataset_for_model(model, spec.data.train_samples,
                                   seed=spec.data.train_seed, **data_kw)
    eval_data = make_dataset_for_model(model, spec.data.eval_samples,
                                       seed=spec.data.eval_seed, **data_kw)
    clients = federate(train, spec.run.fed.num_clients,
                       spec.run.fed.dirichlet_alpha,
                       seed=spec.data.partition_seed)
    return spec, model, clients, eval_data


def resolve_cut_policy(spec: ExperimentSpec, model, *, seq_len: int = 0):
    """``spec.cut`` resolved into a per-client cut assignment: ``(spec,
    cuts, cut_summary)``.  A uniform assignment (every device class
    picked one depth) is collapsed onto ``run.split.split_point`` with
    ``cuts=None``, so the single-cut path runs as it would without the
    policy; a heterogeneous one rewrites ``split_point`` to the shallowest
    cut (where the server block is split) and goes to the trainer.
    Heterogeneous cuts are Ampere-only: the baselines' round steps train
    at one split."""
    if spec.cut is None or spec.cut.mode == "static":
        return spec, None, None
    if spec.fleet is None:
        raise ValueError(
            "cut.mode='per_profile' needs spec.fleet — the device classes "
            "whose cost frontier picks each cut")
    from repro_torch.fleet.cuts import resolve_cuts

    assignment = resolve_cuts(spec.cut, model, spec.run, spec.fleet,
                              seq_len=seq_len)
    cut_summary = assignment.summary()
    p = assignment.depths[0]
    if p != spec.run.split.split_point:
        spec = dataclasses.replace(
            spec, run=dataclasses.replace(
                spec.run, split=dataclasses.replace(
                    spec.run.split, split_point=int(p))))
    if assignment.uniform:
        return spec, None, cut_summary
    if sorted(set(spec.systems)) != ["ampere"]:
        raise ValueError(
            f"heterogeneous resolved cuts {cut_summary['by_class']} are "
            f"ampere-only; drop {sorted(set(spec.systems) - {'ampere'})} "
            "from spec.systems or constrain the policy (min_cut/max_cut/"
            "overrides) to a uniform depth")
    return spec, assignment, cut_summary


def resolve_trace(spec: ExperimentSpec, model, run_cfg, *,
                  seq_len: int = 0,
                  cuts=None) -> Tuple[Optional[object], Optional[list]]:
    """(trace, population) for a spec, or (None, None) without a fleet.

    Loads the JSONL at ``spec.trace_path`` when it exists; otherwise
    simulates a trace from ``spec.fleet`` (priced with Ampere's per-round
    latency, the schedule donor) and saves it to ``trace_path`` when one
    is given — generate once, replay everywhere.  The shared donor is
    always the *synchronous* schedule (the async knobs are zeroed before
    simulating): the buffered systems derive theirs from the same
    population (:func:`repro_torch.experiments.systems.fedbuff_schedule`),
    so one spec compares both disciplines over one churn realization.
    ``cuts`` (a class -> cut map) prices each class's rounds at its own
    cut."""
    from repro_torch.fleet import (FleetScheduler, FleetTrace,
                                   make_latency_fn, sample_population)

    if spec.trace_path is None and spec.fleet is None:
        return None, None
    population = sample_population(spec.fleet) if spec.fleet is not None \
        else None
    rounds = spec.max_rounds if spec.max_rounds is not None \
        else run_cfg.fed.device_epochs
    if spec.trace_path is not None and os.path.exists(spec.trace_path):
        trace = FleetTrace.load(spec.trace_path)
        if len(trace.rounds) < rounds:
            raise ValueError(
                f"trace {spec.trace_path!r} has {len(trace.rounds)} rounds "
                f"but the spec asks for {rounds}; regenerate it (delete the "
                "file) or lower max_rounds — silently capping every system "
                "at the shorter trace would skew the comparison")
        return trace, population
    if spec.fleet is None:
        raise FileNotFoundError(
            f"trace_path {spec.trace_path!r} missing and spec.fleet is null")
    lat = make_latency_fn(model, run_cfg, algo="ampere", seq_len=seq_len,
                          cuts=cuts)
    sim_cfg = spec.fleet if spec.fleet.async_buffer_size == 0 else \
        dataclasses.replace(spec.fleet, async_buffer_size=0)
    trace = FleetScheduler(population, lat, sim_cfg).simulate(rounds)
    if spec.trace_path is not None:
        trace.save(spec.trace_path)
    return trace, population


def build_transport(spec: ExperimentSpec, *, obs=None):
    """A fresh transport for one system of a spec (None = the analytic
    accounting).  A transport exists when the spec asks for one (a
    ``transport`` or ``faults`` section); each system gets its own, so
    idempotency keys and fault statistics never leak across systems.
    ``obs`` (an :class:`~repro_torch.observability.Observability`) gives it
    a tracer for per-message spans."""
    if spec.transport is None and spec.faults is None:
        return None
    from repro_torch.transport import FaultPlan, InProcessTransport

    tspec = spec.transport or TransportSpec()
    plan = FaultPlan(spec.faults) if spec.faults is not None else None
    return InProcessTransport(fault_plan=plan, retry=tspec.retry_policy(),
                              obs=obs)


def run_experiment(spec: ExperimentSpec, *, log_echo: bool = False,
                   dry_run: bool = False, write_results: bool = True,
                   device=None) -> dict:
    """Run every system in ``spec.systems`` on one shared setup.

    Returns ``{"spec", "results": {system: result}, "summary",
    "results_dir"}``; each system result carries the full ``history``
    and the model states.  ``dry_run=True`` only validates and resolves
    the systems.  With ``spec.persist`` each system gets a workdir under
    the results directory (checkpoints, journal, metrics log, activation
    shards), and a rerun of the same spec resumes from it.
    """
    problems = spec.validate()
    if problems:
        raise ValueError("invalid ExperimentSpec:\n  - "
                         + "\n  - ".join(problems))
    systems = {name: get_system(name) for name in spec.systems}
    if dry_run:
        return {"spec": spec, "systems": list(systems), "valid": True}

    spec, model, clients, eval_data = resolve_setup(spec)
    seq = int(eval_data.arrays["tokens"].shape[1]) if model.kind == "lm" \
        else 0
    spec, cuts, cut_summary = resolve_cut_policy(spec, model, seq_len=seq)
    trace, population = resolve_trace(
        spec, model, spec.run, seq_len=seq,
        cuts=cuts.by_class if cuts is not None else None)
    results_dir = spec.results_dir or os.path.join("results", spec.name)
    obs_spec = spec.observability
    results, summary = {}, {}
    for name, sys_cls in systems.items():
        obs = Observability.from_spec(obs_spec)
        transport = build_transport(spec, obs=obs)
        if obs.enabled and trace is not None and obs_spec.scheduler_events:
            obs.tracer.ingest_fleet_trace(trace)
        ctx = SystemContext(
            model=model, run_cfg=spec.run, clients=clients,
            eval_data=eval_data,
            workdir=os.path.join(results_dir, name) if spec.persist
            else None, trace=trace, population=population,
            fleet_cfg=spec.fleet,
            max_rounds=spec.max_rounds,
            max_server_epochs=spec.max_server_epochs,
            patience=spec.patience, log_echo=log_echo, device=device,
            cuts=cuts, transport=transport,
            quorum_frac=(spec.transport.quorum_frac
                         if spec.transport is not None else 1.0),
            obs=obs, streaming=spec.streaming)
        system = sys_cls()
        system.on_start(ctx)
        try:
            result = system.run(ctx)
        finally:
            # the Runner's metrics-log handle must not leak on an abort (a
            # mid-round QuorumError among them)
            runner = getattr(ctx.trainer, "runner", None)
            if runner is not None:
                runner.close()
        system.on_finish(ctx, result)
        results[name] = result
        summary[name] = _history_summary(result["history"])
        if cut_summary is not None:
            summary[name]["cuts"] = cut_summary
        if transport is not None:
            # the bytes actually moved, retries included, beside the
            # history's totals
            summary[name]["wire"] = dict(transport.stats)
        if obs.enabled:
            # the per-phase breakdown in the summary; the registry and the
            # tracer's digest under a history key of their own (every
            # other history key is the same with observability off)
            summary[name]["phases"] = obs.metrics.phase_table()
            summary[name]["trace"] = obs.tracer.summary()
            result["history"]["observability"] = obs.summary()
            if write_results:
                from repro_torch.observability.export import \
                    export_artifacts
                summary[name]["artifacts"] = export_artifacts(
                    obs.tracer, os.path.join(results_dir, name),
                    trace_json=obs_spec.trace_json,
                    span_log=obs_spec.span_log)

    out = {"spec": spec, "results": results, "summary": summary,
           "results_dir": results_dir}
    if write_results:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "summary.json"), "w") as f:
            json.dump({"spec": spec.to_dict(), "summary": summary},
                      f, indent=1)
        for name, result in results.items():
            with open(os.path.join(results_dir, f"{name}_history.json"),
                      "w") as f:
                json.dump(result["history"], f, indent=1)
    return out
