"""Typed findings, stable fingerprints, and the accepted-findings baseline.

Every check in :mod:`repro_torch.staticcheck` reports :class:`Finding`
records.
A finding's *fingerprint* is a short blake2b digest over the fields that
identify it across unrelated edits — rule id, repo-relative path, the
enclosing context (function / kernel entry point), and the detail key —
deliberately **excluding line numbers**, so moving code within a file
does not churn the baseline.

``STATICCHECK_torch_baseline.json`` (committed at the repo root) carries
the accepted findings, each with a human reason string.  The gate
contract: only findings *not* in the baseline fail the run; baseline
entries whose finding disappeared are reported as stale so the file never
rots silently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

SEVERITIES = ("error", "warning")

#: bump when a check's semantics change enough to invalidate cached
#: kernel-analysis results (see kernel_analyzer caching)
ANALYZER_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``context`` names the enclosing unit (a function for lint findings, a
    kernel config id for analyzer findings); ``detail`` is a short stable
    key distinguishing multiple findings of the same rule in the same
    context (an operand name, a call ordinal) — together with ``rule``
    and ``path`` they make the fingerprint.
    """

    rule: str
    severity: str          # "error" | "warning"
    path: str              # repo-relative
    line: int              # 0 when not tied to a source line
    message: str
    context: str = ""
    detail: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.rule, self.path, self.context, self.detail))
        return hashlib.blake2b(key.encode(), digest_size=8).hexdigest()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        ctx = f" [{self.context}]" if self.context else ""
        return (f"{self.severity.upper():7s} {self.rule:24s} {loc}{ctx}\n"
                f"        {self.message}")


def sort_findings(findings: Sequence[Finding]) -> List[Finding]:
    """Deterministic report order: errors first, then path/line/rule."""
    sev_rank = {"error": 0, "warning": 1}
    return sorted(findings, key=lambda f: (sev_rank[f.severity], f.path,
                                           f.line, f.rule, f.detail))


# ---------------------------------------------------------------------------
# baseline


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    fingerprint: str
    rule: str
    path: str
    context: str
    reason: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Baseline:
    """The committed set of accepted findings."""

    def __init__(self, entries: Sequence[BaselineEntry] = ()):
        self.entries = list(entries)
        self._by_fp: Dict[str, BaselineEntry] = {
            e.fingerprint: e for e in self.entries}

    def __contains__(self, finding: Finding) -> bool:
        return finding.fingerprint in self._by_fp

    def __len__(self) -> int:
        return len(self.entries)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != 1:
            raise ValueError(f"unsupported baseline version in {path!r}")
        return cls([BaselineEntry(**e) for e in raw["accepted"]])

    def save(self, path: str) -> None:
        payload = {
            "version": 1,
            "accepted": [e.to_dict() for e in
                         sorted(self.entries,
                                key=lambda e: (e.path, e.rule,
                                               e.fingerprint))],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      reason: str) -> "Baseline":
        """``reason`` is required: every accepted finding carries an
        explicit justification into the committed baseline."""
        return cls([BaselineEntry(fingerprint=f.fingerprint, rule=f.rule,
                                  path=f.path, context=f.context,
                                  reason=reason)
                    for f in sort_findings(findings)])

    def check(self, findings: Sequence[Finding]) -> "GateResult":
        """Split findings into accepted / new, and find stale entries."""
        seen = {f.fingerprint for f in findings}
        new = [f for f in findings if f not in self]
        accepted = [f for f in findings if f in self]
        stale = [e for e in self.entries if e.fingerprint not in seen]
        return GateResult(new=sort_findings(new),
                          accepted=sort_findings(accepted), stale=stale)


@dataclasses.dataclass
class GateResult:
    new: List[Finding]
    accepted: List[Finding]
    stale: List[BaselineEntry]

    @property
    def ok(self) -> bool:
        return not self.new


# ---------------------------------------------------------------------------
# report formatting


def format_text(findings: Sequence[Finding], gate: Optional[GateResult]
                = None) -> str:
    lines: List[str] = []
    for f in sort_findings(findings):
        mark = ""
        if gate is not None:
            mark = ("  (baseline)" if f.fingerprint in
                    gate_accepted_set(gate) else "  (NEW)")
        lines.append(f.format() + mark)
    if gate is not None and gate.stale:
        lines.append("")
        lines.append("stale baseline entries (finding no longer present):")
        for e in gate.stale:
            lines.append(f"  - {e.fingerprint} {e.rule} {e.path}")
    return "\n".join(lines)


def gate_accepted_set(gate: GateResult):
    return {f.fingerprint for f in gate.accepted}


def format_markdown(findings: Sequence[Finding],
                    gate: Optional[GateResult] = None,
                    kernel_summaries: Sequence[dict] = ()) -> str:
    """The committed ``STATICCHECK_torch_report.md`` body."""
    out: List[str] = ["# Static-analysis report", ""]
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    out.append(f"{len(findings)} finding(s): {n_err} error(s), "
               f"{n_warn} warning(s).")
    if gate is not None:
        out.append(f"Gate: {len(gate.new)} new, {len(gate.accepted)} "
                   f"baselined, {len(gate.stale)} stale baseline entries.")
    out.append("")
    if kernel_summaries:
        out.append("## Launch geometry")
        out.append("")
        out.append("| config | kernel | site | grid | block | dynamic "
                   "smem (B) | attribute (B) | min turn distance |")
        out.append("|---|---|---|---|---|---|---|---|")
        for s in kernel_summaries:
            out.append(
                "| {config} | `{kernel}` | `{site}` | {grid} | {block} | "
                "{smem} | {attr} | {turn} |".format(**s))
        out.append("")
    if findings:
        out.append("## Findings")
        out.append("")
        accepted = gate_accepted_set(gate) if gate is not None else set()
        out.append("| status | severity | rule | location | message |")
        out.append("|---|---|---|---|---|")
        for f in sort_findings(findings):
            status = "baseline" if f.fingerprint in accepted else "new"
            loc = f"`{f.path}:{f.line}`" if f.line else f"`{f.path}`"
            msg = f.message.replace("|", "\\|")
            out.append(f"| {status} | {f.severity} | `{f.rule}` | {loc} "
                       f"| {msg} |")
        out.append("")
    if gate is not None and gate.stale:
        out.append("## Stale baseline entries")
        out.append("")
        for e in gate.stale:
            out.append(f"- `{e.fingerprint}` `{e.rule}` `{e.path}` — "
                       f"{e.reason}")
        out.append("")
    return "\n".join(out)


def format_json(findings: Sequence[Finding],
                gate: Optional[GateResult] = None) -> str:
    payload: dict = {
        "findings": [f.to_dict() for f in sort_findings(findings)]}
    if gate is not None:
        payload["gate"] = {
            "ok": gate.ok,
            "new": [f.fingerprint for f in gate.new],
            "accepted": [f.fingerprint for f in gate.accepted],
            "stale": [e.fingerprint for e in gate.stale],
        }
    return json.dumps(payload, indent=1, sort_keys=True)
