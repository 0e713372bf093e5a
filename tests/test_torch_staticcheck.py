"""The port's static-analysis pass: CUDA launch geometry + determinism lint.

The counterpart of ``test_staticcheck.py`` for ``repro_torch.staticcheck``.
The load-bearing assertions pin the analyzer to hand derivations from the
``.cu`` sources: every launch the config matrix records (kernel, grid,
threads, dynamic shared memory, attribute) equals ``expect``, the fused
attention backward's dQ turns pass from lower to higher blocks one row of
B Hkv blocks apart, and the published shared-memory sizes sit where the
comments put them.  Toy kernels (``staticcheck_toys.cu``) cover the
negative space: a misaligned ``cp.async``, an output read before it is
written, a wrong-order turn, shared memory over the budget or over the
default without its attribute, a block of part of a warp, an atomic on a
float output — each flagged, each failing the gate.  The lint's rules,
torch's generator among them, are held to ``repro.staticcheck.lint`` on
every port source.  Needs g++ for the kernel prong (skips without it).
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.staticcheck import lint as ref_lint
from repro.benchmarks_epochs import EPOCHS_TABLE4 as REF_EPOCHS
from repro_torch.benchmarks_epochs import EPOCHS_TABLE4
from repro_torch.kernels import build
from repro_torch.launch import trace_report
from repro_torch.staticcheck import (BASELINE_FILE, Baseline, Finding,
                                     analyze_config, analyze_kernel_configs,
                                     host_build, lint_source, lint_tree)
from repro_torch.staticcheck import __main__ as cli
from repro_torch.staticcheck import kernel_configs as KC
from repro_torch.staticcheck.kernel_analyzer import scan_atomics
from repro_torch.staticcheck.kernel_configs import Buf, KernelConfig, Ptr

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOYS = pathlib.Path(__file__).resolve().parent / "staticcheck_toys.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if host_build.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return host_build.build_library(tmp_path_factory.mktemp("host"))


@pytest.fixture(scope="module")
def matrix(lib):
    """The whole config matrix, run once (no cache)."""
    return analyze_kernel_configs(lib=lib, use_cache=False,
                                  repo_root=str(ROOT))


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    if host_build.compiler() is None:
        pytest.skip("needs g++ (C++20)")
    return host_build.build_sources(tmp_path_factory.mktemp("toys"),
                                    {TOYS.name: TOYS.read_text()})


def _launches(observed, name):
    return tuple((la.kernel, la.grid, la.block[0], la.smem, la.attr)
                 for la in observed[name]["launches"])


def _gate_fails(findings):
    return not Baseline.load(str(ROOT / BASELINE_FILE)).check(findings).ok


# ---------------------------------------------------------------------------
# turn order and distance (the reference's revisit distances, on Hopper)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fa_granite_fused_bfloat16",
                                  "fa_granite_fused_float32"])
def test_flash_bwd_fused_turns_pass_in_block_order_one_row_apart(matrix,
                                                                 name):
    """csrc/flash_attention.cu: the CTA of kv tile j (blockIdx.y) waits for
    its turn on each q tile's counter, which kv tile j - 1 handed on one
    row of the grid earlier: distance grid.x = B Hkv blocks."""
    findings, _, observed = matrix
    cfg = KC.get_config(name)
    assert [f for f in findings if f.context == name] == []
    (li, dist), = [(i, d) for i, d in observed[name]["turn_distance"].items()]
    la = observed[name]["launches"][li]
    assert la.kernel.startswith("fa_bwd_tc_kernel<64, float, true")
    assert dist == cfg.expect["turn_distance"] == la.grid[0] == 2
    assert la.grid[1] > 1                     # several kv tiles take turns


def test_fused_backward_with_one_kv_tile_takes_its_turns_alone(matrix):
    """One kv tile: every counter has one holder (no distance), and the
    turns still pass (the buffer reads zero at launch)."""
    findings, _, observed = matrix
    for name in ("fa_noncausal_fused_bfloat16", "fa_no_valid_key_fused_"
                 "bfloat16", "fa_win_cap_ragged_fused_float32"):
        assert [f for f in findings if f.context == name] == []
        assert set(observed[name]["turn_distance"].values()) == {None}
        assert KC.get_config(name).expect["turn_distance"] is None


def test_split_sweeps_and_xent_use_no_accumulator(matrix):
    """The split backward's sweeps and both xent kernels write every output
    once: no turns, and every output buffer takes the NaN pre-fill."""
    findings, _, observed = matrix
    names = [c.name for c in KC.KERNEL_CONFIGS if c.tier == "execute"
             and ("_dq_" in c.name or "_dkv_" in c.name
                  or c.entry.startswith("rt_xent"))]
    assert len(names) >= 10
    for name in names:
        cfg = KC.get_config(name)
        assert "accumulators" not in cfg.expect, name
        assert not any(b.role == "acc" for b in cfg.buffers), name
        assert observed[name]["turn_distance"] == {}, name
        assert [f for f in findings if f.context == name] == [], name


def test_config_matrix_is_clean_and_matches_expectations(matrix):
    findings, summaries, observed = matrix
    assert findings == []
    assert set(observed) == {c.name for c in KC.KERNEL_CONFIGS}
    for cfg in KC.KERNEL_CONFIGS:
        assert _launches(observed, cfg.name) == cfg.expect["launches"], \
            cfg.name
    assert {r["config"] for r in summaries} == set(observed)


def test_record_tier_covers_every_launch_site(matrix):
    """Every <<<...>>> of csrc/*.cu is recorded at a shape the port
    launches."""
    _, _, observed = matrix
    sites = {f"{name}:{i}" for name in build.SOURCES for i, row in
             enumerate((build.CSRC / name).read_text().splitlines(), start=1)
             if "<<<" in row and not row.lstrip().startswith("//")}
    assert len(sites) == 15
    recorded = {la.site for c in KC.KERNEL_CONFIGS if c.tier == "record"
                for la in observed[c.name]["launches"]}
    assert recorded == sites


def test_published_shared_memory_sizes(matrix):
    """The sizes the sources' comments state, as recorded at the shapes
    the port launches (csrc/ssd_chunk.cu, csrc/flash_attention.cu)."""
    _, _, observed = matrix
    smem = {}          # the largest request of each kernel (Q 256 for SSD)
    for v in observed.values():
        for la in v["launches"]:
            smem[la.kernel] = max(la.smem, smem.get(la.kernel, 0))
    assert smem["ssd_bwd_dx_kernel"] == 230656
    assert smem["ssd_state_kernel"] == 221184
    assert smem["ssd_y_kernel"] == 179200
    assert smem["fa_fwd_tc_kernel<128, 3>"] == 208896
    assert smem["fa_fwd_tc_kernel<256, 3>"] == 202752
    assert smem["fa_bwd_tc_kernel<128, float, true, 3>"] == 183808
    assert smem["ssd_bwd_dbc_kernel"] < 49152     # launched without attribute


def test_kernel_tables_name_every_launched_kernel(lib, matrix):
    """Each source's table (rt_*_kernel_name) holds every kernel the
    matrix launches, by the name the analyzer records: the card's phase 19
    looks them up there."""
    _, _, observed = matrix
    table = build.kernel_table(lib)
    assert len(table) == 63
    launched = {la.kernel for v in observed.values() for la in v["launches"]}
    assert launched <= set(table)
    for (kernel, threads, smem, attr) in {
            (la.kernel, la.block[0], la.smem, la.attr)
            for v in observed.values() for la in v["launches"]}:
        a = build.kernel_attrs(lib, table[kernel], threads, smem, attr)
        assert a["blocks_per_sm"] == 1 and a["max_dyn_smem"] == max(attr, 0)


def test_each_host_library_keeps_its_own_mode_and_records(lib, toys):
    """Two host builds in one process (the emulated tests' and the
    analyzer's): a record-only mode left on one does not stop the other's
    kernels, and each records only its own launches."""
    host_build.reset(toys, record_only=True)
    cfg = KC.get_config("xent_fwd_splits")
    findings, launches, _ = analyze_config(lib, cfg)
    assert findings == [] and len(launches) == 3
    assert host_build.launches(toys) == []
    host_build.reset(toys)


def test_xent_split_count_mirrors_the_source(lib):
    for T, V in ((4088, 151936), (16376, 50280), (80, 300), (40, 130),
                 (1024, 256000), (1, 1)):
        assert KC.xent_nsplit(T, V) == lib.rt_xent_tc_nsplit(T, V, 132)


# ---------------------------------------------------------------------------
# negative space: toy kernels that MUST be flagged
# ---------------------------------------------------------------------------

TOY = {
    "misaligned": (KernelConfig(
        "toy_misaligned", "execute", "toy_misaligned",
        (Buf("src", (4,)), Buf("out", (32,), role="out")),
        (Ptr("src"), Ptr("out"), None)), "misaligned-access"),
    "read_before_write": (KernelConfig(
        "toy_accumulate", "execute", "toy_accumulate",
        (Buf("x", (200,)), Buf("out", (200,), role="out")),
        (Ptr("x"), Ptr("out"), 200, None)), "output-read-before-write"),
    "wrong_turn": (KernelConfig(
        "toy_turns", "execute", "toy_turns",
        (Buf("turn", (1,), "int32", "acc"), Buf("out", (3,), role="out")),
        (Ptr("turn"), Ptr("out"), 3, None), {"accumulators": ("turn",)}),
        "turn-order"),
    "smem_over_budget": (KernelConfig(
        "toy_smem_over", "record", "toy_smem",
        (Buf("out", (64,), role="out"),), (Ptr("out"), 232448 + 16, 1, 64,
                                           None)), "smem-over-budget"),
    "smem_no_attribute": (KernelConfig(
        "toy_smem_noattr", "record", "toy_smem",
        (Buf("out", (64,), role="out"),), (Ptr("out"), 49152 + 16, 0, 64,
                                           None)), "smem-attribute-missing"),
    "partial_warp": (KernelConfig(
        "toy_block", "record", "toy_smem", (Buf("out", (64,), role="out"),),
        (Ptr("out"), 0, 0, 48, None)), "block-shape"),
    "unguarded": (KernelConfig(
        "toy_unguarded", "record", "toy_misaligned",
        (Buf("src", (4,)), Buf("out", (32,), role="out")),
        (Ptr("src"), Ptr("out"), None), {"guarded": ("src",)}),
        "alignment-unguarded"),
}


@pytest.mark.parametrize("toy", sorted(TOY))
def test_toy_fault_is_flagged_and_fails_the_gate(toys, toy):
    cfg, rule = TOY[toy]
    findings, _, _ = analyze_config(toys, cfg)
    assert rule in {f.rule for f in findings}, findings
    assert all(f.severity == "error" for f in findings)
    assert _gate_fails(findings)


def test_toys_within_the_limits_are_clean(toys):
    for args in ((Ptr("out"), 232448, 1, 64, None),
                 (Ptr("out"), 49152, 0, 1024, None)):
        cfg = KernelConfig("toy_ok", "record", "toy_smem",
                           (Buf("out", (1024,), role="out"),), args)
        assert analyze_config(toys, cfg)[0] == []


def test_atomic_on_a_float_output_is_flagged_unless_waived():
    src = ("__global__ void k(float* o, const float* x) {\n"
           "  atomicAdd(&o[0], x[threadIdx.x]);\n"
           "  asm volatile(\"red.global.add.f32 [%0], %1;\" :: \"l\"(o), "
           "\"f\"(1.f));\n"
           "}\n")
    found = scan_atomics(src, "toy.cu")
    assert [(f.rule, f.line) for f in found] == [("atomic", 2),
                                                 ("atomic", 3)]
    assert _gate_fails(found)
    waived = src.replace("  atomicAdd", "  // staticcheck: ok=atomic int\n"
                                        "  atomicAdd")
    assert [f.line for f in scan_atomics(waived, "toy.cu")] == [4]
    # comments that name atomics are not atomics (the sources' own notes)
    assert scan_atomics("// no atomicAdd(x) here\n/* atom.add */\n",
                        "toy.cu") == []


# ---------------------------------------------------------------------------
# determinism lint rules
# ---------------------------------------------------------------------------

SIM_PATH = "src/repro_torch/fleet/toy.py"
PERSIST_PATH = "src/repro_torch/runtime/toy.py"
FREE_PATH = "src/repro_torch/observability/toy.py"


def _rules(source, path):
    return [f.rule for f in lint_source(source, path)]


def test_lint_wall_clock_in_sim_domain():
    src = "import time\nt = time.perf_counter()\n"
    assert _rules(src, SIM_PATH) == ["wall-clock"]
    assert _rules(src, FREE_PATH) == []
    assert _rules(src, "src/repro_torch/transport/socket_transport.py") == []
    waived = ("import time\n"
              "t = time.perf_counter()  # staticcheck: ok=wall-clock x\n")
    assert _rules(waived, SIM_PATH) == []


def test_lint_waiver_on_preceding_line():
    src = ("import time\n"
           "# staticcheck: ok=wall-clock display only\n"
           "t = time.perf_counter()\n")
    assert _rules(src, SIM_PATH) == []


def test_lint_sleep_in_sim_domain():
    src = "import time\ntime.sleep(0.1)\n"
    assert _rules(src, SIM_PATH) == ["sleep-in-sim"]
    assert _rules(src, "src/repro_torch/transport/socket_transport.py") == []


def test_lint_unseeded_rng():
    assert _rules("import numpy as np\nx = np.random.rand(3)\n",
                  FREE_PATH) == ["unseeded-rng"]
    assert _rules("import numpy as np\nr = np.random.default_rng()\n",
                  FREE_PATH) == ["unseeded-rng"]
    assert _rules("import numpy as np\nr = np.random.default_rng(0)\n",
                  FREE_PATH) == []
    assert _rules("import random\nx = random.random()\n",
                  FREE_PATH) == ["unseeded-rng"]
    assert _rules("import random\nr = random.Random(7)\n", FREE_PATH) == []


@pytest.mark.parametrize("src,want", [
    ("import torch\nx = torch.randn(3)\n", 1),
    ("import torch\nx = torch.randn(3, generator=g)\n", 0),
    ("from torch import rand\nx = rand(2, 2)\n", 1),
    ("import torch\nx = torch.randint(0, 5, (3,))\n", 1),
    ("import torch\nx = torch.randperm(4)\n", 1),
    ("import torch\nx = torch.rand_like(y)\n", 1),
    ("import torch\nx = torch.normal(0.0, 1.0, (3,))\n", 1),
    ("import torch\nx = torch.bernoulli(p)\n", 1),
    ("import torch\nx = torch.multinomial(p, 2, generator=g)\n", 0),
    ("x.normal_(0, 1)\n", 1),
    ("x.uniform_(generator=g)\n", 0),
    ("x.bernoulli_(0.5)\nx.random_()\nx.exponential_()\n", 3),
    ("import torch\ntorch.nn.init.normal_(w)\n", 1),
    ("import torch\ntorch.manual_seed(0)\n", 1),
    ("import torch\ntorch.cuda.manual_seed_all(0)\n", 1),
    ("import torch\ng = torch.Generator()\n", 1),
    ("import torch\ng = torch.Generator()\ng.manual_seed(3)\n", 0),
    ("import torch\ng = torch.Generator().manual_seed(3)\n", 0),
    ("import torch\nf(torch.Generator())\n", 1),
    ("import torch\n# staticcheck: ok=unseeded-rng meta\n"
     "f(torch.Generator())\n", 0),
])
def test_lint_torch_global_generator(src, want):
    assert _rules(src, FREE_PATH) == ["unseeded-rng"] * want


def test_lint_json_sort_keys_in_persist_domain():
    src = "import json\ns = json.dumps({'a': 1})\n"
    assert _rules(src, PERSIST_PATH) == ["json-unsorted-keys"]
    ok = "import json\ns = json.dumps({'a': 1}, sort_keys=True)\n"
    assert _rules(ok, PERSIST_PATH) == []
    assert _rules(src, "src/repro_torch/core/toy.py") == []


def test_lint_binary_write_without_crc():
    src = ("import struct\n"
           "def save(f, x):\n"
           "    f.write(struct.pack('<I', x))\n")
    assert _rules(src, PERSIST_PATH) == ["binary-no-crc"]
    withcrc = src.replace("import struct\n",
                          "import struct\nfrom repro_torch.transport.framing"
                          " import crc32\n")
    assert _rules(withcrc, PERSIST_PATH) == []


def test_lint_unordered_iteration():
    assert _rules("for x in {1, 2, 3}:\n    pass\n",
                  FREE_PATH) == ["unordered-iteration"]
    assert _rules("for x in sorted({1, 2, 3}):\n    pass\n",
                  FREE_PATH) == []
    assert _rules("ys = [y for y in set([3, 1])]\n",
                  FREE_PATH) == ["unordered-iteration"]


def test_lint_fingerprints_stable_under_line_moves():
    a = lint_source("import time\nt = time.time()\n", SIM_PATH)
    b = lint_source("import time\n\n\n\nt = time.time()\n", SIM_PATH)
    assert [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert a[0].line != b[0].line


def test_lint_matches_the_reference_on_every_port_source():
    """Each port source, linted as itself and by the reference's lint as if
    it lived at src/repro/...: the same findings (rule, line, context,
    detail), since the port's rules add only torch's generator, which no
    port source draws from."""
    port = ROOT / "src" / "repro_torch"
    n = 0
    for path in sorted(port.rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        src = path.read_text()
        mine = [(f.rule, f.line, f.context, f.detail)
                for f in lint_source(src, rel)]
        ref = [(f.rule, f.line, f.context, f.detail) for f in
               ref_lint.lint_source(src, rel.replace("src/repro_torch/",
                                                     "src/repro/"))]
        assert mine == ref, rel
        n += len(mine)
    assert n == len(lint_tree(str(ROOT))) == 24


# ---------------------------------------------------------------------------
# gate contract
# ---------------------------------------------------------------------------


def _finding(rule="wall-clock", detail="time.time#0"):
    return Finding(rule=rule, severity="error",
                   path="src/repro_torch/fleet/x.py", line=3, message="m",
                   context="f", detail=detail)


def test_gate_fails_on_new_passes_on_baselined(tmp_path):
    f = _finding()
    gate = Baseline().check([f])
    assert not gate.ok and gate.new == [f]
    bl = Baseline.from_findings([f], reason="known issue")
    p = str(tmp_path / "bl.json")
    bl.save(p)
    gate = Baseline.load(p).check([f])
    assert gate.ok and gate.accepted == [f] and not gate.stale
    g = _finding(detail="time.time#1")
    gate = Baseline.load(p).check([f, g])
    assert not gate.ok and gate.new == [g]


def test_gate_reports_stale_entries(tmp_path):
    bl = Baseline.from_findings([_finding()], reason="gone")
    gate = bl.check([])
    assert gate.ok and len(gate.stale) == 1


def test_shipped_tree_passes_the_gate(tmp_path, capsys):
    """What ``python -m repro_torch.staticcheck --gate`` runs (the kernel
    prong is the matrix above): 0 on the shipped tree, 1 against a
    baseline that lacks its findings."""
    assert cli.main(["--gate", "--no-kernels"]) == 0
    empty = tmp_path / "empty.json"
    Baseline().save(str(empty))
    assert cli.main(["--gate", "--no-kernels", "--baseline",
                     str(empty)]) == 1
    assert "new finding(s)" in capsys.readouterr().err


def test_baseline_file_reasons_are_filled():
    with open(ROOT / BASELINE_FILE) as f:
        raw = json.load(f)
    assert raw["version"] == 1 and len(raw["accepted"]) == 24
    for e in raw["accepted"]:
        assert e["reason"].strip() and "TODO" not in e["reason"], e
        assert e["path"].startswith("src/repro_torch/"), e


# ---------------------------------------------------------------------------
# the rest of the CI twin
# ---------------------------------------------------------------------------


def test_benchmarks_epochs_equal_the_reference():
    assert EPOCHS_TABLE4 == REF_EPOCHS


def test_trace_report_on_a_chaos_run(tmp_path):
    """The chaos smoke spec through the port's launcher on the CPU, then
    the report in CI mode: CRCs and trace schema valid, retries seen; a
    torn span log fails it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "chaos"
    subprocess.run([sys.executable, "-m",
                    "repro_torch.launch.run_experiment",
                    str(ROOT / "examples/specs/chaos_smoke.json"),
                    "--device", "cpu", "--results-dir", str(out)],
                   cwd=ROOT, env=env, check=True, capture_output=True,
                   timeout=300)
    report = tmp_path / "report.md"
    assert trace_report.main([str(out), "--validate", "--require-retries",
                              "--out", str(report)]) == 0
    text = report.read_text()
    assert "## ampere" in text and "retries:" in text
    retries = int(re.search(r"retries: (\d+)", text).group(1))
    assert retries > 0
    spans = out / "ampere" / "spans.jsonl"
    lines = spans.read_text().splitlines()
    spans.write_text("\n".join(lines[:-1] + [lines[-1][:-9] + "}"]) + "\n")
    assert trace_report.main([str(out), "--validate"]) == 1
