r"""Static kernel-safety + determinism checks of the port.

    python -m repro_torch.staticcheck            # report all findings
    python -m repro_torch.staticcheck --gate     # fail on NON-baselined ones
    python -m repro_torch.staticcheck --format md \
        --out STATICCHECK_torch_report.md
    python -m repro_torch.staticcheck --write-baseline   # accept findings

The gate contract: the committed ``STATICCHECK_torch_baseline.json``
carries accepted findings (each with a reason string); only *new* findings
fail, and stale baseline entries are reported so the file never rots.
Kernel analysis is cached per config/source hash in
``.staticcheck_torch_cache.json`` (gitignored) — ``--no-cache`` forces a
full re-run (and the host build of the CUDA sources, with g++).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    from repro_torch.staticcheck import (BASELINE_FILE, Baseline,
                                         BaselineEntry, format_json,
                                         format_markdown, format_text,
                                         run_staticcheck)

    ap = argparse.ArgumentParser(prog="python -m repro_torch.staticcheck",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 on findings not in the baseline")
    ap.add_argument("--format", choices=("text", "md", "json"),
                    default="text")
    ap.add_argument("--out", help="write the report here instead of stdout")
    ap.add_argument("--baseline",
                    default=os.path.join(REPO_ROOT, BASELINE_FILE))
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "(reasons of unchanged entries are preserved; "
                         "new entries get a TODO reason to fill in)")
    ap.add_argument("--no-cache", action="store_true",
                    help="re-run every kernel config")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the CUDA kernel analyzer")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the determinism lint")
    args = ap.parse_args(argv)

    findings, summaries = run_staticcheck(
        REPO_ROOT, kernels=not args.no_kernels, lint=not args.no_lint,
        use_cache=not args.no_cache)
    baseline = Baseline.load(args.baseline)
    gate = baseline.check(findings)

    if args.write_baseline:
        old = {e.fingerprint: e for e in baseline.entries}
        entries = []
        for f in findings:
            prev = old.get(f.fingerprint)
            entries.append(BaselineEntry(
                fingerprint=f.fingerprint, rule=f.rule, path=f.path,
                context=f.context,
                reason=prev.reason if prev is not None
                else "TODO: justify this acceptance"))
        Baseline(entries).save(args.baseline)
        print(f"wrote {len(entries)} accepted finding(s) to "
              f"{args.baseline}")
        return 0

    if args.format == "md":
        report = format_markdown(findings, gate, summaries)
    elif args.format == "json":
        report = format_json(findings, gate)
    else:
        report = format_text(findings, gate) if findings else ""
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + ("\n" if report and not report.endswith("\n")
                              else ""))
    elif report:
        print(report)

    n_err = sum(1 for f in findings if f.severity == "error")
    status = {"findings": len(findings), "errors": n_err,
              "new": len(gate.new), "baselined": len(gate.accepted),
              "stale_baseline": len(gate.stale)}
    print(f"staticcheck: {json.dumps(status, sort_keys=True)}",
          file=sys.stderr)

    if not args.gate:
        return 0
    if gate.stale:
        print(f"staticcheck: WARNING {len(gate.stale)} stale baseline "
              "entr(ies) — findings no longer present; regenerate with "
              "--write-baseline", file=sys.stderr)
    if gate.new:
        print(f"staticcheck: FAIL — {len(gate.new)} new finding(s) not in "
              f"{os.path.basename(args.baseline)}:", file=sys.stderr)
        for f in gate.new:
            print(f.format(), file=sys.stderr)
        print("either fix them, waive at the code site "
              "(# staticcheck: ok=<rule> <reason>, // in CUDA), or accept "
              "into the baseline with --write-baseline + a reason string.",
              file=sys.stderr)
        return 1
    print("staticcheck: gate OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
