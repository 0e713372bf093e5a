"""Declarative experiment runner, as ``scripts/run_experiment.py``.

    PYTHONPATH=src python -m repro_torch.launch.run_experiment SPEC.json
    PYTHONPATH=src python -m repro_torch.launch.run_experiment SPEC.json \\
        --device cpu --dry-run

One spec file drives every listed system over one shared setup (one model
init, one non-IID partition and, with a fleet section, one shared fleet
trace), writing one results directory with ``summary.json`` and a history
file per system.  Runs on CUDA unless ``--device cpu``.

``--dry-run`` validates the spec and resolves every system from the
registry, building nothing.  ``--profile`` forces observability on with
``profile=True`` and runs inside
:func:`repro_torch.observability.profiling.profile_run`: every tracer
span and kernel entry point opens a ``torch.profiler`` range (and, on the
card, an NVTX range), and the profiler's Chrome trace lands in
``<results>/profile/profile_trace.json``.

``--role device|server`` runs one side of Ampere's two-process socket
mode (:mod:`repro_torch.transport.roles`) on a spec, on the card unless
``--device cpu``; ``--host`` / ``--port`` override the spec's
``transport`` address.  Start the server first: the device dials it,
retrying while it comes up::

    python -m repro_torch.launch.run_experiment SPEC --role server \
        --port 7733 --results-dir out &
    python -m repro_torch.launch.run_experiment SPEC --role device \
        --port 7733
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spec", help="ExperimentSpec JSON file")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the spec and the registry, print the "
                         "plan, run nothing")
    ap.add_argument("--results-dir", default=None,
                    help="override spec.results_dir")
    ap.add_argument("--echo", action="store_true",
                    help="echo per-round metrics lines")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="run inside torch.profiler with every span and "
                         "kernel entry point in a named range (forces "
                         "observability on); the trace lands under "
                         "<results>/profile")
    ap.add_argument("--role", choices=("device", "server"), default=None,
                    help="two-process socket mode: run only this side of "
                         "the Ampere pipeline (repro_torch.transport.roles)")
    ap.add_argument("--host", default=None,
                    help="socket mode: override spec.transport.host")
    ap.add_argument("--port", type=int, default=None,
                    help="socket mode: override spec.transport.port")
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    from repro_torch.experiments import (ExperimentSpec, ObservabilitySpec,
                                         run_experiment)

    spec = ExperimentSpec.load(args.spec)
    if args.results_dir is not None:
        spec = dataclasses.replace(spec, results_dir=args.results_dir)
    if args.profile:
        obs_spec = spec.observability or ObservabilitySpec()
        spec = dataclasses.replace(spec, observability=dataclasses.replace(
            obs_spec, enabled=True, profile=True))

    problems = spec.validate()
    if problems:
        print(f"INVALID spec {args.spec}:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1

    if args.role is not None:
        from repro_torch.transport import roles

        if args.role == "device":
            out = roles.run_device_role(spec, host=args.host, port=args.port,
                                        echo=args.echo, device=args.device)
        else:
            out = roles.run_server_role(spec, host=args.host, port=args.port,
                                        echo=args.echo,
                                        results_dir=args.results_dir,
                                        device=args.device)
        print(json.dumps(out.get("summary") or out.get("result"), indent=1))
        return 0

    results_dir = spec.results_dir or os.path.join("results", spec.name)
    if args.dry_run:
        out = run_experiment(spec, dry_run=True)
        print(json.dumps({
            "spec": args.spec, "name": spec.name,
            "arch": spec.arch + (" (smoke)" if spec.smoke else ""),
            "systems": out["systems"],
            "rounds": spec.max_rounds or spec.run.fed.device_epochs,
            "server_epochs": (spec.max_server_epochs
                              or spec.run.fed.server_epochs),
            "clients": spec.run.fed.num_clients,
            "trace": spec.trace_path or ("<simulated from fleet cfg>"
                                         if spec.fleet else None),
            "results_dir": results_dir}, indent=1))
        print("dry-run OK")
        return 0

    if args.profile:
        from repro_torch.observability.profiling import profile_run

        with profile_run(os.path.join(results_dir, "profile")) as prof:
            out = run_experiment(spec, log_echo=args.echo,
                                 device=args.device)
        trace_path = prof.trace_path
    else:
        out = run_experiment(spec, log_echo=args.echo, device=args.device)
    print(json.dumps(out["summary"], indent=1))
    if spec.observability is not None and spec.observability.enabled:
        from repro_torch.observability.metrics import format_phase_table

        for name, system in sorted(out["summary"].items()):
            rows = system.get("phases")
            if rows:
                print()
                print(format_phase_table(rows, title=name))
    if args.profile:
        print(f"profiler trace: {trace_path}")
    print(f"wrote {out['results_dir']}/summary.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
