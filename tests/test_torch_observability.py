"""The port's span tracer, metrics registry, exporters and profiler
coupling (``repro_torch.observability``), held to the reference
(``repro.observability``) on the same events: the same Chrome trace and
span log, each accepted by both packages' validators and readers, the
same phase table and histograms; and the committed chaos-smoke artifacts
read strictly by the port."""

import itertools
import json
import os
import sys

import pytest
import torch

import repro.observability.export as j_export
import repro.observability.metrics as j_metrics
import repro.observability.tracer as j_tracer
import repro_torch.observability.export as t_export
import repro_torch.observability.metrics as t_metrics
import repro_torch.observability.tracer as t_tracer
from repro_torch.observability import NULL_OBS, Observability, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES = os.path.join(REPO, "examples", "traces")


def _clock():
    """A deterministic wall clock: 0, 0.25, 0.5, ... seconds."""
    ticks = itertools.count()
    return lambda: next(ticks) * 0.25


def _traced(mod):
    """One tracer of ``mod`` (either package) with nested spans, an
    instant and a sim-domain span, on a deterministic clock."""
    t = mod.Tracer(sim_clock=lambda: 0.0, wall_clock=_clock())
    with t.span("round", track="device/3", round=0):
        with t.span("step", track="device/3") as sp:
            sp.set(loss=1.5)
    t.instant("excluded", track="transport", device=5)
    t.record_span("round", track="scheduler", t_sim=1.0, dur_sim=2.5,
                  round=0)
    return t


# ---------------------------------------------------------------------------
# tracer semantics
# ---------------------------------------------------------------------------


def test_span_nesting_and_attributes_match_reference():
    def run(mod):
        t = mod.Tracer(sim_clock=lambda: 42.0, wall_clock=_clock())
        with t.span("outer", track="server", epoch=3) as outer:
            with t.span("inner", track="server") as inner:
                inner.set(loss=1.5)
            outer.set(val_acc=0.9)
        t.instant("marker", track="server", round=7)
        return t

    t, j = run(t_tracer), run(j_tracer)
    assert [e.name for e in t.events] == ["inner", "outer", "marker"]
    inner, outer, marker = t.events
    assert (inner.depth, outer.depth) == (1, 0)
    assert outer.attrs == {"epoch": 3, "val_acc": 0.9}
    assert marker.kind == "instant" and marker.attrs["round"] == 7
    assert outer.t_sim == 42.0 and outer.dur_sim == 0.0
    assert outer.dur_wall >= inner.dur_wall >= 0.0
    assert [vars(e) for e in t.events] == [vars(e) for e in j.events]
    assert t.summary() == j.summary() and t.tracks() == ["server"]


def test_disabled_tracer_records_nothing_and_yields_null_span():
    t = t_tracer.Tracer(enabled=False)
    with t.span("x", track="a") as sp:
        assert sp is t_tracer.NULL_SPAN
        sp.set(anything=1)
    t.instant("y")
    t.record_span("z", t_sim=0.0, dur_sim=1.0)
    assert t.events == [] and t.summary()["events"] == 0
    assert NULL_OBS.tracer is t_tracer.NULL_TRACER
    assert not NULL_OBS.enabled and not NULL_OBS.metrics.enabled


def test_event_cap_drops_and_counts():
    t = t_tracer.Tracer(max_events=2)
    for i in range(5):
        t.instant(f"e{i}")
    assert len(t.events) == 2 and t.dropped == 3
    assert t.summary()["dropped"] == 3


def test_sim_clock_binds_once():
    t = t_tracer.Tracer()
    t.bind_sim_clock(lambda: 1.0)
    t.bind_sim_clock(lambda: 2.0)
    t.instant("x")
    assert t.events[0].t_sim == 1.0


def test_ingest_fleet_trace_matches_reference():
    """The same fleet config's trace (the port's scheduler draws as the
    reference's) ingests into the same scheduler-track events, and a
    scheduler built with ``tracer=`` ingests its own trace."""
    from repro.fleet import FleetConfig as JCfg
    from repro.fleet import FleetScheduler as JSched
    from repro.fleet import sample_population as j_pop
    from repro_torch.fleet import (FleetConfig, FleetScheduler,
                                   sample_population)

    kw = dict(n_devices=8, seed=1, min_cohort=2, max_cohort=4,
              init_cohort=4, quorum_frac=0.5)
    t = t_tracer.Tracer(wall_clock=_clock())
    trace = FleetScheduler(sample_population(FleetConfig(**kw)),
                           lambda p: 1.0 / p.speed_factor,
                           FleetConfig(**kw), tracer=t).simulate(4)
    j = j_tracer.Tracer(wall_clock=_clock())
    JSched(j_pop(JCfg(**kw)), lambda p: 1.0 / p.speed_factor, JCfg(**kw),
           tracer=j).simulate(4)
    assert [vars(e) for e in t.events] == [vars(e) for e in j.events]
    assert sum(e.name == "round" for e in t.events) == len(trace.rounds)
    assert t.tracks() == ["scheduler", "scheduler/events"]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _metered(mod):
    m = mod.MetricsRegistry()
    m.counter("comm_bytes", 100, phase="device", direction="up")
    m.counter("comm_bytes", 40, phase="device", direction="down")
    m.counter("comm_bytes", 999, phase="transfer")
    m.counter("steps", 2, phase="device")
    m.counter("retries", 3, phase="device")
    m.counter("excluded_devices", 1, phase="device")
    m.counter("overlap_s", 0.25, phase="server")
    m.observe("step_wall_s", 0.5, phase="device")
    m.observe("step_sim_s", 2.0, phase="device")
    m.gauge("ring", 3.0)
    for v in range(1, 101):
        m.observe("staleness", float(v), phase="fedbuff")
    return m


def test_metric_key_round_trip_and_phase_table_match_reference():
    k = t_metrics.metric_key("comm_bytes", {"phase": "device",
                                            "direction": "up"})
    assert k == "comm_bytes{direction=up,phase=device}"
    assert t_metrics.parse_metric_key(k) == (
        "comm_bytes", {"direction": "up", "phase": "device"})
    assert t_metrics.parse_metric_key("plain") == ("plain", {})
    t, j = _metered(t_metrics), _metered(j_metrics)
    rows = {r["phase"]: r for r in t.phase_table()}
    dev = rows["device"]
    assert (dev["bytes_up"], dev["bytes_down"], dev["bytes_total"]) == \
        (100, 40, 140)
    assert (dev["steps"], dev["retries"], dev["excluded"]) == (2, 3, 1)
    assert rows["transfer"]["bytes_total"] == 999
    assert t.phase_table() == j.phase_table()
    assert t.to_dict() == j.to_dict()
    md = t_metrics.format_phase_table(t.phase_table(), title="t")
    assert md == j_metrics.format_phase_table(j.phase_table(), title="t")
    assert md.startswith("### t") and "| device |" in md
    assert t_metrics.format_phase_table([]) == "(no per-phase metrics)"


def test_histogram_quantiles_match_reference():
    t, j = _metered(t_metrics), _metered(j_metrics)
    h = t.hist_summary("staleness{phase=fedbuff}")
    assert h["count"] == 100 and (h["min"], h["max"]) == (1.0, 100.0)
    assert h["p50"] == pytest.approx(50.0, abs=1.0)
    assert h["p90"] == pytest.approx(90.0, abs=1.0)
    assert h == j.hist_summary("staleness{phase=fedbuff}")
    off = t_metrics.MetricsRegistry(enabled=False)
    off.counter("x")
    off.observe("y", 1.0)
    assert off.to_dict() == {"counters": {}, "gauges": {},
                             "histograms": {}}


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def test_chrome_trace_matches_reference_and_both_validators_accept():
    t = _traced(t_tracer)
    doc = t_export.to_chrome_trace(t)
    assert doc == j_export.to_chrome_trace(_traced(j_tracer))
    assert t_export.validate_chrome_trace(doc) == []
    assert j_export.validate_chrome_trace(doc) == []
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"device", "transport", "scheduler"}
    sched = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["args"].get("clock") == "sim"]
    assert sched[0]["ts"] == 1.0e6 and sched[0]["dur"] == 2.5e6
    assert any(e["ph"] == "i" and e["name"] == "excluded"
               for e in doc["traceEvents"])


@pytest.mark.parametrize("doc,problem", [
    ({}, "traceEvents missing or empty"),
    ({"traceEvents": [{"ph": "X", "ts": 0, "pid": 1}]}, "missing 'tid'"),
    ({"traceEvents": [
        {"ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1, "name": "a"},
        {"ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1, "name": "b"}]},
     "not LIFO"),
], ids=["empty", "missing_tid", "crossing"])
def test_chrome_trace_validator_catches_broken_documents(doc, problem):
    got = t_export.validate_chrome_trace(doc)
    assert any(problem in p for p in got)
    assert got == j_export.validate_chrome_trace(doc)


def test_span_log_round_trip_and_corruption_read_by_both(tmp_path):
    t = _traced(t_tracer)
    path = str(tmp_path / "spans.jsonl")
    assert t_export.write_span_log(t, path) == len(t.events)
    j_path = str(tmp_path / "j_spans.jsonl")
    j_export.write_span_log(_traced(j_tracer), j_path)
    assert open(path).read() == open(j_path).read()
    for read in (t_export.read_span_log, j_export.read_span_log):
        back = read(path, strict=True)
        assert [(e.name, e.track, e.kind, e.attrs) for e in back] == \
            [(e.name, e.track, e.kind, e.attrs) for e in t.events]
    raw = open(path).read()
    corrupted = raw.replace('"round": 0', '"round": 1', 1)
    assert corrupted != raw
    bad = tmp_path / "corrupt.jsonl"
    bad.write_text(corrupted)
    for read in (t_export.read_span_log, j_export.read_span_log):
        with pytest.raises(ValueError, match="CRC mismatch|truncated"):
            read(str(bad), strict=True)
        assert len(read(str(bad), strict=False)) < len(t.events)
    torn = tmp_path / "torn.jsonl"
    torn.write_text(raw[:len(raw) - 20])
    with pytest.raises(ValueError):
        t_export.read_span_log(str(torn), strict=True)


def test_export_artifacts_and_json_safe(tmp_path):
    t = t_tracer.Tracer()
    with t.span("s", track="server", n=torch.tensor(3).item(),
                obj=object()) as sp:
        sp.set(vals=(1, 2.5), d={"a": [1]})
    arts = t_export.export_artifacts(t, str(tmp_path))
    doc = json.load(open(arts["trace_json"]))
    assert t_export.validate_chrome_trace(doc) == []
    assert j_export.validate_chrome_trace(doc) == []
    (rec,) = j_export.read_span_log(arts["span_log"], strict=True)
    assert rec.attrs["vals"] == [1, 2.5] and rec.attrs["d"] == {"a": [1]}
    assert rec.attrs["obj"].startswith("<object")
    assert t_export.export_artifacts(t, str(tmp_path / "none"),
                                     trace_json=False, span_log=False) == {}


def test_committed_chaos_smoke_artifacts_read_strictly():
    spans = t_export.read_span_log(
        os.path.join(TRACES, "chaos_smoke_spans.jsonl"), strict=True)
    j_spans = j_export.read_span_log(
        os.path.join(TRACES, "chaos_smoke_spans.jsonl"), strict=True)
    assert [vars(e) for e in spans] == [vars(e) for e in j_spans]
    assert any(e.track == "transport" for e in spans)
    assert any(e.attrs.get("attempts", 1) > 1 for e in spans
               if e.name == "xfer")
    with open(os.path.join(TRACES, "chaos_smoke_trace.json")) as f:
        assert t_export.validate_chrome_trace(json.load(f)) == []


def test_delta_stats_resets_mark_but_not_cumulative():
    from repro_torch.transport import InProcessTransport

    t = InProcessTransport()
    t.transfer("a", 100)
    d1 = t.delta_stats()
    assert d1["sends"] == 1 and d1["wire_bytes"] == 100
    assert "retries" not in d1
    t.transfer("b", 50)
    assert t.delta_stats() == {"sends": 1, "delivered": 1, "wire_bytes": 50}
    assert t.delta_stats() == {}
    assert t.stats["sends"] == 2 and t.stats["wire_bytes"] == 150


def test_transport_spans_and_metrics_match_reference():
    """A faulty transport with observability records the reference's
    ``xfer`` spans (attributes included) and metrics."""
    from repro.observability import Observability as JObs
    from repro.transport import FaultPlan as JPlan
    from repro.transport import FaultSpec as JSpec
    from repro.transport import InProcessTransport as JTransport
    from repro.transport import cohort_exchange as j_exchange
    from repro_torch.transport import (FaultPlan, FaultSpec,
                                       InProcessTransport, cohort_exchange)

    faults = dict(seed=7, drop_prob=0.3, corrupt_prob=0.2, reset_prob=0.1,
                  duplicate_prob=0.2, perma_fail_devices=(2,))
    runs = []
    for obs_cls, tr_cls, plan, spec, exchange in (
            (Observability, InProcessTransport, FaultPlan, FaultSpec,
             cohort_exchange),
            (JObs, JTransport, JPlan, JSpec, j_exchange)):
        obs = obs_cls()
        obs.tracer._wall = _clock()
        obs.tracer.t0 = 0.0
        tr = tr_cls(plan(spec(**faults)), obs=obs)
        exchange(tr, round_key="r0", clients=[1, 2, 3], one_way_bytes=500,
                 quorum_frac=0.5, phase="device")
        runs.append((obs, tr))
    (t, tt), (j, jt) = runs
    assert [vars(e) for e in t.tracer.events] == \
        [vars(e) for e in j.tracer.events]
    assert t.metrics.to_dict() == j.metrics.to_dict()
    assert tt.stats == jt.stats
    assert any(e.name == "excluded" for e in t.tracer.events)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_annotate_is_a_shared_no_op_when_profiling_is_off():
    assert not profiling.annotations_active()
    assert profiling.annotate("flash_fwd") is profiling.annotate("x")
    with profiling.annotate("flash_fwd"):
        pass


def test_profiled_ranges_are_recorded_on_the_cpu(tmp_path):
    """Inside ``profile_run`` a kernel entry point's range and a
    ``profile=True`` tracer's spans are ``record_function`` ranges that
    ``torch.profiler`` records (no NVTX without CUDA), and the Chrome
    trace is written; the kernels' ops run inside their ranges."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.xent.ops import cross_entropy

    obs = Observability(profile=True)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 16, 1, 2, 8), generator=g, requires_grad=True)
    k = torch.randn((1, 16, 1, 8), generator=g, requires_grad=True)
    h = torch.randn((6, 8), generator=g, requires_grad=True)
    w = torch.randn((8, 11), generator=g)
    labels = torch.arange(6, dtype=torch.int32)
    with profiling.profile_run(str(tmp_path)) as prof:
        assert profiling.annotations_active()
        with obs.tracer.span("device.round", track="device"):
            flash_attention(q, k, k).sum().backward()
            cross_entropy(h, w, labels)[0].backward()
    assert not profiling.annotations_active()
    names = [e.name for e in prof.events()]
    for rng in ("device.round", "flash_fwd", "flash_bwd_fused",
                "fused_xent_pallas"):
        assert rng in names, rng
    assert names.count("fused_xent_pallas") == 2      # forward, backward
    with open(prof.trace_path) as f:
        doc = json.load(f)
    assert any(e.get("cat") == "user_annotation"
               and e["name"] == "flash_fwd" for e in doc["traceEvents"])
    assert obs.tracer.summary()["open_spans"] == 0


def test_profiled_tracer_raises_when_a_range_cannot_open(monkeypatch):
    """Only "profiling off" is silent: a ``profile=True`` tracer whose
    range fails to enter raises instead of recording nothing."""
    class Broken:
        def __enter__(self):
            raise RuntimeError("profiler range refused")

    monkeypatch.setattr(profiling, "trace_annotation", lambda name: Broken())
    t = t_tracer.Tracer(profile=True)
    with pytest.raises(RuntimeError, match="refused"):
        with t.span("x"):
            pass
    plain = t_tracer.Tracer()          # profile=False opens no range
    with plain.span("x"):
        pass
    assert len(plain.events) == 1


def test_chip_call_site_reader_attributes_launches_to_ranges():
    """``chip_smoke.call_sites`` (phase 14(b)) on a synthetic profiler
    trace: each kernel is attributed through its launch's correlation id
    to the range of its entry point on the launching thread, kernels of
    the round window to the tracer's spans on any thread, and each span's
    device time and idle share come from the kernels it launched."""
    sys.path.insert(0, REPO)
    import chip_smoke

    ev = []

    def x(cat, name, ts, dur, tid, **args):
        ev.append(dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                       pid=1, args=args))

    x("user_annotation", "window", 0, 200, 1)
    x("user_annotation", "device.round", 1, 150, 1)
    x("user_annotation", "flash_fwd", 10, 10, 1)
    x("cuda_runtime", "cudaLaunchKernel", 12, 2, 1, correlation=1)
    x("kernel", "void fa_fwd_tc_kernel<128, 1>(...)", 15, 5, 7,
      correlation=1)
    x("user_annotation", "flash_bwd_fused", 30, 10, 2)   # autograd thread
    x("cuda_runtime", "cudaLaunchKernel", 31, 2, 2, correlation=2)
    x("kernel", "void fa_bwd_tc_kernel<128, true>(...)", 35, 20, 7,
      correlation=2)
    x("user_annotation", "fused_xent_pallas", 50, 10, 1)
    x("cuda_runtime", "cudaLaunchKernel", 51, 1, 1, correlation=3)
    x("kernel", "xent_combine_kernel", 52, 3, 7, correlation=3)
    x("cuda_runtime", "cudaLaunchKernel", 61, 1, 2, correlation=4)
    x("kernel", "xent_tc_gemm_kernel", 62, 3, 7, correlation=4)  # stray
    x("cuda_runtime", "cudaLaunchKernel", 160, 1, 1, correlation=5)
    x("kernel", "void at::fill_kernel", 161, 3, 7, correlation=5)
    x("kernel", "orphan", 170, 1, 7, correlation=99)
    out = chip_smoke.call_sites({"traceEvents": ev}, ["device.round"],
                                "window")
    assert out["sites"]["flash_fwd"] == {
        "range": "flash_fwd", "kernels": 1, "in_range": 1,
        "ranges_by_family": {"fa_fwd_tc_kernel": 1}}
    assert out["sites"]["flash_bwd_fused"]["in_range"] == 1
    xent = out["sites"]["xent"]
    assert (xent["kernels"], xent["in_range"]) == (2, 1)
    assert xent["ranges_by_family"]["xent_combine_kernel"] == 1
    assert xent["ranges_by_family"]["xent_tc_gemm_kernel"] == 0
    assert (out["window_kernels"], out["window_kernels_in_spans"],
            out["unlinked"]) == (5, 4, 1)
    row = out["table"]["device.round"]
    assert row["device_ms"] == pytest.approx(0.031)
    # busy: [15, 20], [35, 55] and [62, 65] of the span's 150 us
    assert row["idle_share"] == pytest.approx(1 - 28 / 150)
    assert row["top"][0]["name"].startswith("void fa_bwd_tc_kernel")
