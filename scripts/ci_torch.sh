#!/usr/bin/env bash
# The port's inner-loop CI, on the CPU: its fast test tier, the staticcheck
# gate, and the spec, chaos, streaming and cut smokes through repro_torch's
# launcher (--device cpu), as scripts/ci.sh runs them for the reference.
# The bench gate waits for the port's benchmark.
#
#   scripts/ci_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"   # the parity tests' reference
RUN=(python -m repro_torch.launch.run_experiment)

# the torch test files, four workers, a file per worker at a time
python -m pytest -q -m "not slow" -p xdist -n 4 --dist loadfile \
    tests/test_torch_*.py
# kernel launch geometry (the CUDA sources built for the host, cached per
# source hash) plus the determinism lint; fails only on findings not in
# STATICCHECK_torch_baseline.json
python -m repro_torch.staticcheck --gate
# spec validation + system registry smoke over the committed comparison spec
"${RUN[@]}" examples/specs/compare_smoke.json --dry-run --device cpu
# seeded chaos smoke: faults at the transport and storage boundaries; the
# run completes, its Perfetto trace and CRC'd span log validate, and the
# retry path ran
CHAOS_DIR=$(mktemp -d)
"${RUN[@]}" examples/specs/chaos_smoke.json --device cpu \
    --results-dir "$CHAOS_DIR"
python -m repro_torch.launch.trace_report "$CHAOS_DIR" --validate \
    --require-retries --out "$CHAOS_DIR/report.md"
rm -rf "$CHAOS_DIR"
# streaming smoke: the upload through the memmap ring, server epochs
# overlapping the device round: nonzero overlapped seconds
STREAM_DIR=$(mktemp -d)
"${RUN[@]}" examples/specs/streaming_smoke.json --device cpu \
    --results-dir "$STREAM_DIR"
python - "$STREAM_DIR" <<'PY'
import json, sys
summary = json.load(open(f"{sys.argv[1]}/summary.json"))["summary"]["ampere"]
rows = {r["phase"]: r for r in summary["phases"]}
overlap = rows.get("server", {}).get("overlap_s", 0.0)
assert overlap > 0.0, f"streaming smoke: no server/device overlap: {rows}"
print(f"streaming smoke OK: overlap_s={overlap}")
PY
rm -rf "$STREAM_DIR"
# heterogeneous-cut smoke: a per_profile CutPolicy over a two-class fleet;
# >= 2 distinct per-class cuts, and every phase's bytes balance (down ==
# up per exchange phase, up only for the one-shot activation transfer)
CUT_DIR=$(mktemp -d)
"${RUN[@]}" examples/specs/cut_smoke.json --device cpu \
    --results-dir "$CUT_DIR"
python - "$CUT_DIR" <<'PY'
import json, sys
summary = json.load(open(f"{sys.argv[1]}/summary.json"))["summary"]["ampere"]
cuts = summary["cuts"]
assert not cuts["uniform"] and len(set(cuts["by_class"].values())) >= 2, \
    f"cut smoke: expected heterogeneous per-class cuts, got {cuts}"
rows = {r["phase"]: r for r in summary["phases"]}
for phase, r in rows.items():
    assert r["bytes_total"] == r["bytes_up"] + r["bytes_down"], \
        f"cut smoke: unbalanced bytes in phase {phase}: {r}"
assert rows["fleet"]["bytes_up"] == rows["fleet"]["bytes_down"] > 0, \
    f"cut smoke: fleet exchange not symmetric: {rows['fleet']}"
assert rows["transfer"]["bytes_up"] > 0 and \
    rows["transfer"]["bytes_down"] == 0, \
    f"cut smoke: one-shot upload should be up-only: {rows['transfer']}"
print(f"cut smoke OK: cuts={cuts['by_class']} depths={cuts['depths']}")
PY
rm -rf "$CUT_DIR"
