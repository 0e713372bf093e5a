"""Render a Markdown round-by-round report from the port's traced-run
artifacts (the counterpart of ``scripts/trace_report.py``).

    PYTHONPATH=src python -m repro_torch.launch.trace_report RESULTS_DIR
    PYTHONPATH=src python -m repro_torch.launch.trace_report spans.jsonl \
        --out report.md
    PYTHONPATH=src python -m repro_torch.launch.trace_report RESULTS_DIR \
        --validate --require-retries   # CI mode: exit nonzero on problems

``RESULTS_DIR`` is an experiment results directory (per-system
subdirectories each holding ``spans.jsonl`` + ``trace.json``, as written
by :func:`repro_torch.observability.export.export_artifacts`), a single
system directory, or a span JSONL file directly.

The report covers, per system: a track/event overview, a round-by-round
table built from the runner's phase spans (wall vs simulated duration,
loss/accuracy attributes), the transport ledger (sends, retries, fault
verdicts, backoff, exclusions), and the scheduler's sim-domain rounds.

``--validate`` re-reads every artifact strictly: span-log CRCs must
verify and the Chrome trace must pass
:func:`repro_torch.observability.export.validate_chrome_trace`.
``--require-retries`` additionally fails when no transfer span recorded
a retry — the chaos-smoke CI gate uses it to prove fault injection
actually exercised the retry path.
"""

import argparse
import json
import os
import sys
from collections import Counter

from repro_torch.observability.export import (read_span_log,
                                              validate_chrome_trace)


def find_artifacts(path):
    """Yield ``(label, span_log_path, trace_json_path_or_None)``."""
    if os.path.isfile(path):
        label = os.path.basename(os.path.dirname(path)) or "run"
        sibling = os.path.join(os.path.dirname(path), "trace.json")
        return [(label, path, sibling if os.path.exists(sibling) else None)]
    direct = os.path.join(path, "spans.jsonl")
    if os.path.exists(direct):
        tj = os.path.join(path, "trace.json")
        return [(os.path.basename(os.path.normpath(path)) or "run",
                 direct, tj if os.path.exists(tj) else None)]
    found = []
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        sl = os.path.join(sub, "spans.jsonl")
        if os.path.isdir(sub) and os.path.exists(sl):
            tj = os.path.join(sub, "trace.json")
            found.append((name, sl, tj if os.path.exists(tj) else None))
    return found


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _table(rows, cols):
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        out.append("| " + " | ".join(_fmt(r.get(c, "")) for c in cols)
                   + " |")
    return "\n".join(out)


def round_rows(spans):
    """Runner phase-step spans -> one row per (phase, step index)."""
    rows = []
    for e in spans:
        if e.kind != "span" or "." not in e.name:
            continue
        phase, _, step_name = e.name.partition(".")
        if step_name not in e.attrs:
            continue        # not a runner step span
        row = {"phase": phase, step_name: e.attrs[step_name],
               "step": e.attrs[step_name],
               "wall_s": round(e.dur_wall, 4),
               "sim_s": round(e.dur_sim, 4) if e.dur_sim is not None
               else ""}
        for k in ("loss", "val_loss", "val_acc", "buffered",
                  "staleness_max", "dropped"):
            if k in e.attrs:
                row[k] = e.attrs[k]
        rows.append(row)
    return rows


def transport_summary(spans):
    xfers = [e for e in spans if e.name == "xfer"]
    excluded = [e for e in spans
                if e.name == "excluded" and e.track == "transport"]
    verdicts = Counter()
    retries = failures = 0
    backoff = 0.0
    for e in xfers:
        a = e.attrs
        attempts = int(a.get("attempts", 1))
        if attempts > 1:
            retries += attempts - 1
        if not a.get("ok", True):
            failures += 1
        backoff += float(a.get("backoff_s", 0.0))
        for v in a.get("verdicts") or []:
            verdicts[v] += 1
    return {"sends": len(xfers), "retries": retries, "failures": failures,
            "excluded_devices": len(excluded),
            "backoff_s": round(backoff, 6), "verdicts": dict(verdicts)}


def scheduler_rows(spans):
    return [{"round": e.attrs.get("round"),
             "t_start_s": round(e.t_sim or 0.0, 3),
             "round_s": round(e.dur_sim or 0.0, 3),
             "clients": e.attrs.get("clients"),
             "dropped": e.attrs.get("dropped")}
            for e in spans
            if e.name == "round" and e.track.startswith("scheduler")]


def report_one(label, spans):
    tracks = Counter(e.track for e in spans)
    lines = [f"## {label}", "",
             f"{len(spans)} events across {len(tracks)} tracks: "
             + ", ".join(f"`{t}` ({n})" for t, n in sorted(tracks.items())),
             ""]
    rows = round_rows(spans)
    if rows:
        cols = ["phase", "step", "wall_s", "sim_s"]
        for extra in ("loss", "val_loss", "val_acc", "buffered",
                      "staleness_max", "dropped"):
            if any(extra in r for r in rows):
                cols.append(extra)
        lines += ["### Rounds", "", _table(rows, cols), ""]
    ts = transport_summary(spans)
    if ts["sends"]:
        lines += ["### Transport", "",
                  f"- sends: {ts['sends']}  retries: {ts['retries']}  "
                  f"failures: {ts['failures']}  excluded devices: "
                  f"{ts['excluded_devices']}",
                  f"- backoff total: {ts['backoff_s']}s",
                  f"- fault verdicts: "
                  + (", ".join(f"{k}={v}" for k, v in
                               sorted(ts["verdicts"].items())) or "none"),
                  ""]
    sched = scheduler_rows(spans)
    if sched:
        lines += ["### Scheduler rounds (sim clock)", "",
                  _table(sched, ["round", "t_start_s", "round_s",
                                 "clients", "dropped"]), ""]
    return "\n".join(lines), ts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="results dir, system dir, or spans.jsonl")
    ap.add_argument("--out", default=None,
                    help="write the Markdown report here (default stdout)")
    ap.add_argument("--validate", action="store_true",
                    help="strict-verify span-log CRCs and the Chrome "
                         "trace schema; exit nonzero on any problem")
    ap.add_argument("--require-retries", action="store_true",
                    help="fail unless at least one transfer span "
                         "recorded a retry (chaos-smoke CI gate)")
    args = ap.parse_args(argv)

    artifacts = find_artifacts(args.path)
    if not artifacts:
        print(f"no span artifacts under {args.path!r}", file=sys.stderr)
        return 1

    problems = []
    total_retries = 0
    sections = ["# Trace report", ""]
    for label, span_path, trace_path in artifacts:
        try:
            spans = read_span_log(span_path, strict=args.validate)
        except (ValueError, OSError) as e:
            problems.append(f"{label}: {e}")
            continue
        if args.validate and trace_path is not None:
            with open(trace_path) as f:
                doc = json.load(f)
            problems.extend(f"{label}: {p}"
                            for p in validate_chrome_trace(doc))
        section, ts = report_one(label, spans)
        total_retries += ts["retries"]
        sections.append(section)

    report = "\n".join(sections)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
        print(f"wrote {args.out}")
    else:
        print(report)

    if args.require_retries and total_retries == 0:
        problems.append("--require-retries: no transfer span recorded a "
                        "retry (fault injection never hit the retry path?)")
    if problems:
        print("\nVALIDATION PROBLEMS:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    if args.validate:
        print(f"\nvalidation OK ({len(artifacts)} system(s))",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
