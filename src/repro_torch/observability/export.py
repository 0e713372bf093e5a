"""Trace exporters: Chrome trace-event JSON (Perfetto) and the CRC'd
span JSONL, as ``repro.observability.export``.

* ``trace.json`` — the Chrome trace-event format (complete events
  ``ph="X"`` for spans, ``ph="i"`` for instants, ``ph="M"`` metadata
  naming processes and threads).  Open it at https://ui.perfetto.dev or
  ``chrome://tracing``.  One process per track group (``server``,
  ``device``, ``scheduler``, ``transport``), one thread per full track.
  Wall-domain spans are placed at microseconds since the tracer started,
  sim-domain spans (the scheduler's) at simulated microseconds; their
  tracks are disjoint, so the two time bases never share a row.
* ``spans.jsonl`` — one line per event with a canonical-JSON CRC32
  trailer field, as the round journal and the fleet trace store theirs:
  a bit flip or a torn write is detected at load.

Both files are the reference's format: the reference's validators and
readers accept the port's, and the port's the reference's.
Stdlib-only.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from repro_torch.observability.tracer import SpanRecord, Tracer
from repro_torch.transport.framing import crc32

SPAN_LOG_FORMAT = "span-log-v1"


def _canonical(rec: dict) -> bytes:
    return json.dumps(rec, sort_keys=True, separators=(",", ":")).encode()


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:
        return v.item()          # numpy scalars
    except Exception:
        return repr(v)


# ---------------------------------------------------------------------------
# Chrome trace-event JSON
# ---------------------------------------------------------------------------


def to_chrome_trace(tracer: Tracer) -> dict:
    """Tracer -> Chrome trace-event dict (``{"traceEvents": [...]}``)."""
    groups: List[str] = []
    tids: dict = {}

    def ids(track: str):
        group = track.split("/", 1)[0]
        if group not in groups:
            groups.append(group)
        pid = groups.index(group) + 1
        key = (pid, track)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == pid]) + 1
        return pid, tids[key]

    events = []
    for e in tracer.events:
        pid, tid = ids(e.track)
        if e.clock == "sim":
            ts = (e.t_sim or 0.0) * 1e6
            dur = (e.dur_sim or 0.0) * 1e6
        else:
            ts = e.t_wall * 1e6
            dur = e.dur_wall * 1e6
        args = {k: _json_safe(v) for k, v in e.attrs.items()}
        args["clock"] = e.clock
        if e.clock == "wall" and e.t_sim is not None:
            args["sim_t"] = e.t_sim
            if e.dur_sim is not None:
                args["sim_dur"] = e.dur_sim
        if e.kind == "instant":
            events.append({"ph": "i", "ts": round(ts, 3), "pid": pid,
                           "tid": tid, "name": e.name, "s": "t",
                           "cat": e.track, "args": args})
        else:
            events.append({"ph": "X", "ts": round(ts, 3),
                           "dur": round(dur, 3), "pid": pid, "tid": tid,
                           "name": e.name, "cat": e.track, "args": args})
    meta = []
    for group in groups:
        pid = groups.index(group) + 1
        meta.append({"ph": "M", "ts": 0, "pid": pid, "tid": 0,
                     "name": "process_name", "args": {"name": group}})
    for (pid, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                     "name": "thread_name", "args": {"name": track}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped,
                          "format": "repro-trace-v1"}}


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    doc = to_chrome_trace(tracer)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"))
        f.write("\n")
    return doc


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema problems (empty list = valid).

    Checks the invariants the tests and CI gate on: every event carries
    ``ph``/``ts``/``pid``/``tid``; ``X`` events carry a non-negative
    ``dur``; span nesting on one (pid, tid, clock) row is LIFO —
    children close before parents, i.e. spans on a row are properly
    bracketed.
    """
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    rows: dict = {}
    for i, e in enumerate(events):
        for field in ("ph", "ts", "pid", "tid"):
            if field not in e:
                problems.append(f"event {i} ({e.get('name')!r}) missing "
                                f"{field!r}")
        if e.get("ph") == "X":
            if "dur" not in e or e["dur"] < 0:
                problems.append(f"X event {i} ({e.get('name')!r}) has no "
                                "non-negative dur")
            else:
                rows.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e.get("name")))
    # ts/dur are rounded to 1e-3 us on export, so two back-to-back spans
    # (scheduler rounds sharing a boundary) can appear to overlap by a
    # rounding quantum; anything under EPS is adjacency, not nesting
    eps = 5e-3
    for (pid, tid), spans in rows.items():
        # bracketing: overlapping spans on one row must nest (LIFO);
        # at equal start the enclosing (longer) span must come first
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, name in spans:
            while stack and stack[-1][1] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                problems.append(
                    f"row pid={pid} tid={tid}: span {name!r} "
                    f"[{t0},{t1}] crosses parent {stack[-1][2]!r} "
                    f"[{stack[-1][0]},{stack[-1][1]}] — not LIFO")
            stack.append((t0, t1, name))
    return problems


# ---------------------------------------------------------------------------
# CRC'd span JSONL
# ---------------------------------------------------------------------------


def write_span_log(tracer: Tracer, path: str) -> int:
    """Stream the tracer's events to JSONL with per-record CRCs.

    One header line (format tag + counts), then one line per event.
    Returns the number of event records written.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as f:
        header = {"kind": "header", "format": SPAN_LOG_FORMAT,
                  "num_events": len(tracer.events),
                  "dropped": tracer.dropped}
        f.write(json.dumps(header) + "\n")
        for e in tracer.events:
            rec = {"kind": e.kind, "name": e.name, "track": e.track,
                   "clock": e.clock, "t_wall": round(e.t_wall, 9),
                   "dur_wall": round(e.dur_wall, 9), "depth": e.depth,
                   "attrs": {k: _json_safe(v) for k, v in e.attrs.items()}}
            if e.t_sim is not None:
                rec["t_sim"] = e.t_sim
            if e.dur_sim is not None:
                rec["dur_sim"] = e.dur_sim
            rec["_crc"] = crc32(_canonical(rec))
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def read_span_log(path: str, *, strict: bool = True) -> List[SpanRecord]:
    """Load a span JSONL, verifying every record's CRC.

    ``strict=True`` raises on a corrupt record (the FleetTrace
    convention — a report built from silently skewed spans is worse
    than no report); ``strict=False`` skips corrupt lines (the journal
    convention) for salvage reads.
    """
    out: List[SpanRecord] = []
    declared = None
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if strict:
                    raise ValueError(
                        f"{path}:{lineno}: unparseable span record (torn "
                        f"write?): {line[:80]!r}")
                continue
            if rec.get("kind") == "header":
                declared = rec.get("num_events")
                continue
            crc = rec.pop("_crc", None)
            if crc is None or crc != crc32(_canonical(rec)):
                if strict:
                    raise ValueError(
                        f"{path}:{lineno}: span record CRC mismatch (bit "
                        f"flip or torn write): {line[:80]!r}")
                continue
            out.append(SpanRecord(
                name=rec["name"], track=rec["track"], kind=rec["kind"],
                t_wall=float(rec["t_wall"]),
                dur_wall=float(rec["dur_wall"]),
                t_sim=rec.get("t_sim"), dur_sim=rec.get("dur_sim"),
                clock=rec.get("clock", "wall"),
                depth=int(rec.get("depth", 0)),
                attrs=rec.get("attrs", {})))
    if strict and declared is not None and len(out) != int(declared):
        raise ValueError(
            f"{path}: truncated span log — header declares {declared} "
            f"events, {len(out)} read")
    return out


def export_artifacts(tracer: Tracer, directory: str, *,
                     trace_json: bool = True,
                     span_log: bool = True) -> dict:
    """Write the standard artifact pair into ``directory``."""
    written = {}
    if trace_json:
        path = os.path.join(directory, "trace.json")
        write_chrome_trace(tracer, path)
        written["trace_json"] = path
    if span_log:
        path = os.path.join(directory, "spans.jsonl")
        write_span_log(tracer, path)
        written["span_log"] = path
    return written
