"""Prong 1: the Hopper launch geometry of every hand-written kernel.

The CUDA sources are compiled for the host (:mod:`host_build`), and each
config of :mod:`kernel_configs` calls one ``rt_*`` entry point through the
emulator, which records every launch (kernel, site, grid, block, dynamic
shared memory, the attribute set before it), every turn a CTA awaits or
hands on, and every misaligned ``cp.async`` or ``ldmatrix`` address.  From
those records it checks what a launch on the card would otherwise find out
only when it happens to run:

(a) **turn order** (the counterpart of the reference's aliased-accumulator
    revisit distance): the fused attention backward sums dQ across kv
    tiles in turns, which is safe only while each turn is handed on by a
    block the hardware dispatches earlier (a lower linear block index:
    ``tensor_core.cuh::wait_turn``).  The turn buffer reads zero at launch;
    every ``wait_turn`` must find its turn, set by a lower block.  The
    distance, in blocks, between consecutive holders of a dQ tile's counter
    is reported as the reference reports ``min_revisit``.
(b) **alignment**: 16-B ``cp.async`` on both sides (4-B ``cp.async`` 4),
    16-B ``ldmatrix`` row addresses, and the entry points' guards: an entry
    given a misaligned pointer it names in ``expect["guarded"]`` must
    refuse it and launch nothing.
(c) **budget**, against the H100's published limits: dynamic shared memory
    within the 232,448 B a block may opt into, any request over the
    default 49,152 B only after ``cudaFuncSetAttribute`` raised the limit
    to at least it, a block of at most 1024 threads in whole warps, grid.y
    and grid.z at most 65,535 and grid.x at most 2^31 - 1.
(d) **write-before-read**: each executed config runs twice, its outputs and
    scratch pre-filled with 0 and then with NaN; the outputs must match bit
    for bit.  Only the buffers ``expect["accumulators"]`` names (zeroed by
    the caller, as the wrapper zeroes the fused backward's dQ and turns)
    are exempt from the NaN fill.
(e) **atomics**: a scan of ``csrc/*.cu`` and ``*.cuh`` for ``atomic*``,
    ``atom.`` and ``red.``: an atomic read-modify-write orders a
    floating-point sum by arrival, so every one is an error unless its line
    (or the line above) carries ``// staticcheck: ok=atomic <reason>``.

Results are cached per hash of (the sources, the stand-in headers, the
config, the settings, the analyzer version): the gate re-runs only what
changed, and a tree whose every config hits the cache needs no build.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import re
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.staticcheck import host_build
from repro_torch.staticcheck.findings import ANALYZER_VERSION, Finding
from repro_torch.staticcheck.kernel_configs import KernelConfig, Ptr

CSRC_REL = "src/repro_torch/csrc"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int32": torch.int32}
FAKE_BASE = 1 << 44      # record-only pointers: never dereferenced
FAKE_ALIGN = 256
MISALIGN = 8             # bytes a guarded pointer is moved off its alignment


@dataclasses.dataclass
class AnalyzerSettings:
    """The H100's published limits the budget check counts against."""

    smem_optin_bytes: int = 232448    # dynamic smem a block may opt into
    smem_default_bytes: int = 49152   # without cudaFuncSetAttribute
    max_threads: int = 1024
    warp_size: int = 32
    max_grid_x: int = 2 ** 31 - 1
    max_grid_yz: int = 65535

    def key(self) -> str:
        return "/".join(str(v) for v in dataclasses.astuple(self))


def site_location(site: str) -> Tuple[str, int]:
    """``"xent.cu:597"`` -> (repo-relative path, line)."""
    name, _, line = site.rpartition(":")
    return f"{CSRC_REL}/{name}", int(line)


def _finding(rule, site_or_path, cfg_name, detail, message,
             severity="error") -> Finding:
    if re.search(r":\d+$", site_or_path):
        path, line = site_location(site_or_path)
    else:
        path, line = site_or_path, 0
    return Finding(rule=rule, severity=severity, path=path, line=line,
                   message=message, context=cfg_name, detail=detail)


# ---------------------------------------------------------------------------
# (c) budget


def check_budget(launch: host_build.Launch, cfg_name: str,
                 settings: AnalyzerSettings) -> List[Finding]:
    out = []
    k, site = launch.kernel, launch.site
    threads = math.prod(launch.block)
    if threads > settings.max_threads or threads % settings.warp_size:
        out.append(_finding(
            "block-shape", site, cfg_name, f"{k}/block",
            f"{k}: block {launch.block} has {threads} threads — at most "
            f"{settings.max_threads}, in whole warps of "
            f"{settings.warp_size}"))
    gx, gy, gz = launch.grid
    if (gx > settings.max_grid_x or gy > settings.max_grid_yz
            or gz > settings.max_grid_yz or min(launch.grid) < 1):
        out.append(_finding(
            "grid-too-large", site, cfg_name, f"{k}/grid",
            f"{k}: grid {launch.grid} — grid.x at most "
            f"{settings.max_grid_x}, grid.y and grid.z at most "
            f"{settings.max_grid_yz}, each at least 1"))
    if launch.smem > settings.smem_optin_bytes:
        out.append(_finding(
            "smem-over-budget", site, cfg_name, f"{k}/smem",
            f"{k}: {launch.smem} B of dynamic shared memory — a block may "
            f"opt into at most {settings.smem_optin_bytes} B"))
    elif (launch.smem > settings.smem_default_bytes
          and launch.attr < launch.smem):
        out.append(_finding(
            "smem-attribute-missing", site, cfg_name, f"{k}/attr",
            f"{k}: {launch.smem} B of dynamic shared memory with the "
            f"limit at {max(launch.attr, settings.smem_default_bytes)} B — "
            "above the default a launch needs cudaFuncSetAttribute("
            "MaxDynamicSharedMemorySize) raised to at least its request"))
    return out


# ---------------------------------------------------------------------------
# (a) turn order


def check_turns(turns: Sequence[host_build.Turn],
                launches: Sequence[host_build.Launch], cfg_name: str):
    """(findings, {launch index: min distance between holders or None})."""
    findings, distance = [], {}
    by_launch = collections.defaultdict(list)
    for t in turns:
        by_launch[t.launch].append(t)
    for li, events in sorted(by_launch.items()):
        launch = launches[li]
        state = {}                   # counter -> (value, block that set it)
        holders = collections.defaultdict(list)
        base = min(t.counter for t in events)
        bad = 0
        for t in events:
            value, setter = state.get(t.counter, (0, -1))
            if t.passed:
                state[t.counter] = (t.value, t.block)
                continue
            if t.ok and value == t.value and setter < t.block:
                holders[t.counter].append(t.block)
                continue
            bad += 1
            if bad == 1:
                idx = (t.counter - base) // 4
                findings.append(_finding(
                    "turn-order", launch.site, cfg_name,
                    f"{launch.kernel}/turn",
                    f"{launch.kernel}: block {t.block} waits for turn "
                    f"{t.value} on counter {idx}, which reads {value} "
                    f"(set by block {setter}) — a turn must be handed on "
                    "by a block of lower linear index, which the card "
                    "dispatches first"))
        gaps = [b - a for hs in holders.values() for a, b in zip(hs, hs[1:])]
        distance[li] = min(gaps) if gaps else None
    return findings, distance


# ---------------------------------------------------------------------------
# (b) alignment


def check_faults(total: int, kept: Sequence[host_build.Fault],
                 launches: Sequence[host_build.Launch], cfg_name: str):
    findings, seen = [], set()
    for f in kept:
        launch = launches[f.launch]
        if (launch.kernel, f.kind) in seen:
            continue
        seen.add((launch.kernel, f.kind))
        findings.append(_finding(
            "misaligned-access", launch.site, cfg_name,
            f"{launch.kernel}/{f.kind}",
            f"{launch.kernel}: {f.kind} address {f.address:#x} off its "
            f"alignment (block {f.block}, thread {f.lane}; {total} such "
            "accesses in the run) — the card faults on it"))
    return findings


# ---------------------------------------------------------------------------
# calling an entry point


def _inputs(buf, gen: torch.Generator) -> torch.Tensor:
    if buf.fill.startswith("labels"):
        return torch.randint(0, int(buf.fill[6:]), buf.shape, generator=gen,
                             dtype=torch.int32)
    a = torch.randn(buf.shape, generator=gen, dtype=torch.float64)
    if buf.fill == "dt":
        a = a.abs() * 0.1
    elif buf.fill == "acum":         # (BC, Q, H): decaying along Q
        rate = torch.rand(buf.shape[-1], generator=gen,
                          dtype=torch.float64) * 1.5 + 0.5
        a = -torch.cumsum(a.abs() * 0.1 * rate, dim=1)
    return a.to(TORCH_DTYPE[buf.dtype])


def _call(lib, cfg: KernelConfig, ptr) -> int:
    fn = getattr(lib, cfg.entry)
    vals = [ptr(a) if isinstance(a, Ptr) else a for a in cfg.args]
    if fn.argtypes is None:         # a toy entry: C types from the values
        conv = {float: ctypes.c_float, int: ctypes.c_int}
        vals = [ctypes.c_void_p(v) if isinstance(a, Ptr) or v is None
                else conv[type(v)](v) for a, v in zip(cfg.args, vals)]
        fn.restype = ctypes.c_int
    return fn(*vals)


def _fake_pointers(cfg: KernelConfig) -> Dict[str, int]:
    out, at = {}, FAKE_BASE
    for b in cfg.buffers:
        out[b.name] = at
        at += -(-b.nbytes // FAKE_ALIGN) * FAKE_ALIGN + FAKE_ALIGN
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit patterns (NaN equals NaN of the same payload)."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int32: torch.int32}[t.dtype])


def _record(lib, cfg):
    """Record-only tier: the call's launches, and each guard's check."""
    findings = []
    ptrs = _fake_pointers(cfg)
    host_build.reset(lib, record_only=True)
    rc = _call(lib, cfg, ptrs.__getitem__)
    launches = host_build.launches(lib)
    if rc:
        findings.append(_finding(
            "entry-refused", cfg.path, cfg.name, cfg.entry,
            f"{cfg.entry} returned error {rc} at the config's shape"))
    for name in cfg.expect.get("guarded", ()):
        moved = dict(ptrs, **{name: ptrs[name] + MISALIGN})
        host_build.reset(lib, record_only=True)
        rc_bad = _call(lib, cfg, moved.__getitem__)
        if rc_bad == 0 or host_build.launches(lib):
            findings.append(_finding(
                "alignment-unguarded", cfg.path, cfg.name,
                f"{cfg.entry}/{name}",
                f"{cfg.entry} took {name} {MISALIGN} B off its 16-B "
                "alignment and launched — its 16-B copies fault on the "
                "card"))
    return findings, launches, {}


def _execute(lib, cfg):
    """Execute tier: two runs (0 and NaN fills) and what they log."""
    findings = []
    acc = set(cfg.expect.get("accumulators", ()))
    gen = torch.Generator().manual_seed(zlib.crc32(cfg.name.encode()))
    ins = {b.name: _inputs(b, gen) for b in cfg.buffers if b.role == "in"}
    results = []
    for fill in (0.0, math.nan):
        bufs = dict(ins)
        for b in cfg.buffers:
            if b.role == "in":
                continue
            v = 0 if b.name in acc else fill
            if b.dtype == "int32" and v != 0:
                v = -1
            bufs[b.name] = torch.full(b.shape, v, dtype=TORCH_DTYPE[b.dtype])
        host_build.reset(lib, record_only=False, turn_abort=False)
        rc = _call(lib, cfg, lambda n: bufs[n].data_ptr())
        run = dict(rc=rc, launches=host_build.launches(lib),
                   turns=host_build.turns(lib), faults=host_build.faults(lib),
                   outs={b.name: _bits(bufs[b.name]) for b in cfg.buffers
                         if b.role in ("out", "acc")})
        results.append(run)
    first = results[0]
    if first["rc"]:
        findings.append(_finding(
            "entry-refused", cfg.path, cfg.name, cfg.entry,
            f"{cfg.entry} returned error {first['rc']} at the config's "
            "shape"))
    tf, distance = check_turns(first["turns"], first["launches"], cfg.name)
    findings += tf
    for run in results:
        for f in check_faults(*run["faults"], run["launches"], cfg.name):
            if f not in findings:
                findings.append(f)
    for name, bits in first["outs"].items():
        if not torch.equal(results[1]["outs"][name], bits):
            findings.append(_finding(
                "output-read-before-write", cfg.path, cfg.name,
                f"{cfg.entry}/{name}",
                f"{cfg.entry}: output {name} differs between runs with its "
                "outputs and scratch pre-filled with 0 and with NaN — a "
                "kernel reads memory before it writes it"))
    return findings, first["launches"], distance


def analyze_config(lib, cfg: KernelConfig,
                   settings: Optional[AnalyzerSettings] = None):
    """(findings, launches, {launch index: turn distance}) of one config
    on a host-built library."""
    settings = settings or AnalyzerSettings()
    run = _record if cfg.tier == "record" else _execute
    findings, launches, distance = run(lib, cfg)
    seen = set()
    for launch in launches:
        for f in check_budget(launch, cfg.name, settings):
            if f.fingerprint not in seen:
                seen.add(f.fingerprint)
                findings.append(f)
    return findings, launches, distance


# ---------------------------------------------------------------------------
# (e) atomics

ATOMIC = re.compile(r"\batomic[A-Z]\w*\s*\(|\b(?:atom|red)\.[a-z]")
_C_WAIVER = re.compile(r"//\s*staticcheck:\s*ok=([A-Za-z0-9_,-]+)")


def _strip_comments(text: str) -> List[str]:
    """The lines of a C++ source with comments blanked (strings kept)."""
    out, in_block = [], False
    for line in text.splitlines():
        code, i = [], 0
        while i < len(line):
            if in_block:
                j = line.find("*/", i)
                if j < 0:
                    i = len(line)
                else:
                    in_block, i = False, j + 2
            elif line.startswith("//", i):
                break
            elif line.startswith("/*", i):
                in_block, i = True, i + 2
            else:
                code.append(line[i])
                i += 1
        out.append("".join(code))
    return out


def scan_atomics(text: str, path: str) -> List[Finding]:
    raw = text.splitlines()
    waived = {i + 1 for i, line in enumerate(raw)
              if (m := _C_WAIVER.search(line))
              and {"atomic", "all"} & set(m.group(1).split(","))}
    findings, ordinal = [], collections.Counter()
    for i, line in enumerate(_strip_comments(text), start=1):
        for m in ATOMIC.finditer(line):
            if i in waived or i - 1 in waived:
                continue
            token = m.group(0).rstrip("( \t")
            n = ordinal[token]
            ordinal[token] += 1
            findings.append(Finding(
                rule="atomic", severity="error", path=path, line=i,
                message=f"{token}: an atomic read-modify-write orders a "
                        "floating-point sum by arrival, so results change "
                        "run to run — sum in a fixed order, or waive an "
                        "integer counter with // staticcheck: ok=atomic "
                        "<reason>",
                context="atomics", detail=f"{token}#{n}"))
    return findings


def scan_atomics_tree(repo_root: str) -> List[Finding]:
    findings = []
    csrc = pathlib.Path(repo_root) / CSRC_REL
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        findings += scan_atomics(f.read_text(), f"{CSRC_REL}/{f.name}")
    return findings


# ---------------------------------------------------------------------------
# config-matrix driver with source-hash caching


def _config_cache_key(cfg: KernelConfig, settings: AnalyzerSettings,
                      sources: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{ANALYZER_VERSION}|{cfg!r}|{settings.key()}|{sources}"
             .encode())
    h.update(pathlib.Path(__file__).read_bytes())
    return h.hexdigest()


def _rows(cfg_name, launches, distance):
    return [{"config": cfg_name, "kernel": l.kernel, "site": l.site,
             "grid": "x".join(map(str, l.grid)), "block": l.block[0],
             "smem": l.smem, "attr": l.attr if l.attr >= 0 else "-",
             "turn": "-" if distance.get(i) is None else distance[i]}
            for i, l in enumerate(launches)]


def analyze_kernel_configs(configs=None, *,
                           settings: Optional[AnalyzerSettings] = None,
                           cache_path: Optional[str] = None,
                           use_cache: bool = True, lib=None,
                           repo_root: Optional[str] = None):
    """Run the analyzer over the config matrix and the atomics scan.

    Returns ``(findings, summaries, observed)``: ``observed`` maps each
    config run this time (cache hits carry findings and summary rows only)
    to its launches and turn distances.  ``lib``: a host-built library
    (built on the first cache miss when not given)."""
    from repro_torch.staticcheck.kernel_configs import KERNEL_CONFIGS

    settings = settings or AnalyzerSettings()
    configs = list(KERNEL_CONFIGS if configs is None else configs)
    cache = {}
    if use_cache and cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    sources = host_build.source_hash()
    findings: List[Finding] = []
    summaries: List[dict] = []
    observed: Dict[str, dict] = {}
    dirty = False
    for cfg in configs:
        key = _config_cache_key(cfg, settings, sources)
        hit = cache.get(cfg.name)
        if use_cache and hit and hit.get("key") == key:
            findings.extend(Finding(**f) for f in hit["findings"])
            summaries.extend(hit["summary"])
            continue
        if lib is None:
            lib = host_build.build_library()
        fs, launches, distance = analyze_config(lib, cfg, settings)
        rows = _rows(cfg.name, launches, distance)
        findings.extend(fs)
        summaries.extend(rows)
        observed[cfg.name] = {"launches": launches, "turn_distance": distance}
        cache[cfg.name] = {"key": key,
                           "findings": [dataclasses.asdict(f) for f in fs],
                           "summary": rows}
        dirty = True
    if use_cache and cache_path and dirty:
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, cache_path)
    root = repo_root or str(pathlib.Path(__file__).resolve().parents[3])
    findings.extend(scan_atomics_tree(root))
    return findings, summaries, observed
