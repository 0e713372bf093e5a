"""Static kernel-safety and determinism analysis of the port.

The Hopper counterpart of ``repro.staticcheck``, with its names.  Two
prongs: :mod:`~repro_torch.staticcheck.kernel_analyzer` checks the launch
geometry of every hand-written CUDA kernel (turn order, alignment, the
shared-memory, block and grid budget, write-before-read, atomics) over a
config matrix run through the CUDA sources compiled for the host
(:mod:`~repro_torch.staticcheck.host_build`, the stand-in headers in
``emu/``), without a card; :mod:`~repro_torch.staticcheck.lint` catches
determinism regressions (wall-clock, unseeded numpy / stdlib / torch
generators, unordered serialization) in ``src/repro_torch/``.
``python -m repro_torch.staticcheck --gate`` fails only on findings absent
from the committed ``STATICCHECK_torch_baseline.json``.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.staticcheck.findings import (ANALYZER_VERSION, Baseline,
                                              BaselineEntry, Finding,
                                              GateResult, format_json,
                                              format_markdown, format_text,
                                              sort_findings)
from repro_torch.staticcheck.kernel_analyzer import (AnalyzerSettings,
                                                     analyze_config,
                                                     analyze_kernel_configs)
from repro_torch.staticcheck.lint import lint_source, lint_tree

BASELINE_FILE = "STATICCHECK_torch_baseline.json"
REPORT_FILE = "STATICCHECK_torch_report.md"
CACHE_FILE = ".staticcheck_torch_cache.json"

__all__ = [
    "ANALYZER_VERSION", "AnalyzerSettings", "Baseline", "BaselineEntry",
    "Finding", "GateResult", "analyze_config", "analyze_kernel_configs",
    "format_json", "format_markdown", "format_text", "lint_source",
    "lint_tree", "run_staticcheck", "sort_findings",
]


def run_staticcheck(repo_root: str, *, kernels: bool = True,
                    lint: bool = True, use_cache: bool = True,
                    settings: Optional[AnalyzerSettings] = None):
    """Run both prongs; returns ``(findings, kernel_summaries)``."""
    findings, summaries = [], []
    if kernels:
        cache_path = os.path.join(repo_root, CACHE_FILE)
        kf, summaries, _ = analyze_kernel_configs(
            settings=settings, cache_path=cache_path, use_cache=use_cache,
            repo_root=repo_root)
        findings.extend(kf)
    if lint:
        findings.extend(lint_tree(repo_root))
    return sort_findings(findings), summaries
