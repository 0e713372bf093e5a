"""``run_experiment(spec)`` — one declarative entry point for every
system, as ``repro.experiments.api``.

Resolves an :class:`~repro_torch.experiments.spec.ExperimentSpec` into
live objects (model from the arch registry, synthetic non-IID data) and
runs every listed system on them in turn, writing one results directory
with a ``summary.json`` plus ``<system>_history.json`` files.  Runs on
CUDA unless ``device="cpu"``.  Transport, observability, fleet traces and
adaptive cuts are later slices; :meth:`ExperimentSpec.validate` refuses
a spec that sets them.
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.experiments.systems import SystemContext, get_system


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
    results_dir = spec.results_dir or os.path.join("results", spec.name)
    results, summary = {}, {}
    for name, sys_cls in systems.items():
        ctx = SystemContext(
            model=model, run_cfg=spec.run, clients=clients,
            eval_data=eval_data,
            workdir=os.path.join(results_dir, name) if spec.persist
            else None,
            max_rounds=spec.max_rounds,
            max_server_epochs=spec.max_server_epochs,
            patience=spec.patience, log_echo=log_echo, device=device)
        system = sys_cls()
        system.on_start(ctx)
        try:
            result = system.run(ctx)
        finally:
            # the Runner's metrics-log handle must not leak on an abort
            runner = getattr(ctx.trainer, "runner", None)
            if runner is not None:
                runner.close()
        system.on_finish(ctx, result)
        results[name] = result
        summary[name] = _history_summary(result["history"])

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
