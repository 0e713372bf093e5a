"""Phase and round metrics: counters, gauges, histograms, as
``repro.observability.metrics``.

The registry is the accounting breakdown that the two history scalars
(``comm_bytes``, ``sim_time``) do not give: bytes by direction x phase,
retry and exclusion counts per phase, staleness distributions, per-round
wall and simulated durations.  It is write-only from the run's point of
view: nothing reads a metric back into control flow, so a registry, on
or off, never changes training.

Keys are ``name`` plus sorted ``label=value`` pairs, Prometheus-style:
``comm_bytes{direction=up,phase=device}``.  Histograms keep raw samples
up to a cap and summarize on serialization (count/min/max/mean/p50/p90).
Stdlib-only.
"""

from __future__ import annotations

from typing import Dict, List


_HIST_CAP = 65536     # samples kept per histogram; count keeps incrementing


def metric_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_metric_key(key: str):
    """Inverse of :func:`metric_key`: ``(name, labels)``."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels = {}
    for pair in rest.rstrip("}").split(","):
        if pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class MetricsRegistry:
    """Counters / gauges / histograms behind one no-op-able surface.

    ``enabled=False`` turns every record call into a single boolean
    check, so trainers thread one registry unconditionally.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, dict] = {}   # key -> {count,total,samples}

    # ------------------------------------------------------------------
    def counter(self, name: str, value: float = 1, **labels):
        if not self.enabled:
            return
        k = metric_key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels):
        if not self.enabled:
            return
        self.gauges[metric_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels):
        if not self.enabled:
            return
        h = self.hists.setdefault(metric_key(name, labels),
                                  {"count": 0, "total": 0.0, "samples": []})
        h["count"] += 1
        h["total"] += value
        if len(h["samples"]) < _HIST_CAP:
            h["samples"].append(float(value))

    # ------------------------------------------------------------------
    def hist_summary(self, key: str) -> dict:
        h = self.hists[key]
        s = sorted(h["samples"])
        return {"count": h["count"], "total": h["total"],
                "min": s[0] if s else 0.0, "max": s[-1] if s else 0.0,
                "mean": (h["total"] / h["count"]) if h["count"] else 0.0,
                "p50": _percentile(s, 0.5), "p90": _percentile(s, 0.9)}

    def to_dict(self) -> dict:
        """JSON-serializable snapshot (histograms summarized)."""
        return {
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "histograms": {k: self.hist_summary(k)
                           for k in sorted(self.hists)},
        }

    # ------------------------------------------------------------------
    def phase_table(self) -> List[dict]:
        """Per-phase breakdown rows for the experiment summary.

        One row per phase seen by any metric: bytes up/down (falling
        back to the undirected phase total when no transport split the
        directions), wall + sim time, steps, retries, excluded devices.
        """
        phases: Dict[str, dict] = {}

        def row(phase):
            return phases.setdefault(phase, {
                "phase": phase, "steps": 0, "bytes_up": 0, "bytes_down": 0,
                "bytes_total": 0, "wall_s": 0.0, "sim_s": 0.0,
                "overlap_s": 0.0, "retries": 0, "excluded": 0})

        for key, v in self.counters.items():
            name, lab = parse_metric_key(key)
            phase = lab.get("phase")
            if phase is None:
                continue
            r = row(phase)
            if name == "comm_bytes":
                d = lab.get("direction")
                if d == "up":
                    r["bytes_up"] += int(v)
                elif d == "down":
                    r["bytes_down"] += int(v)
                else:
                    r["bytes_total"] += int(v)
            elif name == "steps":
                r["steps"] += int(v)
            elif name in ("retries", "transport_retries"):
                r["retries"] += int(v)
            elif name == "excluded_devices":
                # transport_failures deliberately not folded in: one
                # excluded device can be several failed messages
                r["excluded"] += int(v)
            elif name == "overlap_s":
                # streamed server seconds hidden behind the device round
                r["overlap_s"] += float(v)
        for key, h in self.hists.items():
            name, lab = parse_metric_key(key)
            phase = lab.get("phase")
            if phase is None:
                continue
            if name == "step_wall_s":
                row(phase)["wall_s"] += h["total"]
            elif name == "step_sim_s":
                row(phase)["sim_s"] += h["total"]
        for r in phases.values():
            if not r["bytes_total"]:
                r["bytes_total"] = r["bytes_up"] + r["bytes_down"]
            r["wall_s"] = round(r["wall_s"], 6)
            r["sim_s"] = round(r["sim_s"], 9)
            r["overlap_s"] = round(r["overlap_s"], 9)
        return [phases[p] for p in sorted(phases)]


NULL_METRICS = MetricsRegistry(enabled=False)


def format_phase_table(rows: List[dict], *, title: str = "") -> str:
    """Render :meth:`MetricsRegistry.phase_table` rows as Markdown."""
    if not rows:
        return "(no per-phase metrics)"
    cols = ["phase", "steps", "bytes_down", "bytes_up", "bytes_total",
            "wall_s", "sim_s", "overlap_s", "retries", "excluded"]
    out = []
    if title:
        out.append(f"### {title}")
    out.append("| " + " | ".join(cols) + " |")
    out.append("|" + "|".join("---" for _ in cols) + "|")
    for r in rows:
        out.append("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    return "\n".join(out)
