"""The port's fleet layer against the reference's, without training:
population sampling, latency pricing, the scheduler's sync and async
traces (saved to the same bytes), trace replay pricing, the elastic
cohort, heartbeats, the engine's batch indices and the FedBuff
aggregation arithmetic."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import FedConfig as JFed
from repro.configs.base import RunConfig as JRun
from repro.core import aggregation as j_agg
from repro.data import federate as j_federate
from repro.data import make_dataset_for_model as j_dataset
from repro.fleet import FleetConfig as JFleet
from repro.fleet import FleetEngine as JEngine
from repro.fleet import FleetScheduler as JScheduler
from repro.fleet import FleetTrace as JTrace
from repro.fleet import make_latency_fn as j_latency
from repro.fleet import sample_population as j_population
from repro.fleet import trace_round_times as j_round_times
from repro.models import build_model as j_build
from repro.runtime.elastic import ElasticCohort as JElastic
from repro.runtime.fault_tolerance import Heartbeats as JHeartbeats
from repro.streaming.versions import VersionRing as JRing
from repro_torch.configs import registry
from repro_torch.configs.base import FedConfig, RunConfig
from repro_torch.core import aggregation
from repro_torch.data import federate, make_dataset_for_model
from repro_torch.fleet import (FleetConfig, FleetEngine, FleetScheduler,
                               FleetTrace, make_latency_fn,
                               sample_population, trace_round_times)
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.runtime.elastic import ElasticCohort
from repro_torch.runtime.fault_tolerance import Heartbeats, RoundJournal
from repro_torch.streaming import VersionRing

COMMITTED_TRACE = str(pathlib.Path(__file__).resolve().parents[1]
                      / "examples/specs/fleet_trace_smoke.jsonl")
FED = dict(num_clients=40, clients_per_round=8, local_steps=8,
           device_batch_size=8, server_batch_size=64)

# scheduler configurations: the committed comparison's, elastic sizing
# with straggler deadlines, quorum-degraded rounds over shared uplinks,
# and the buffered async mode (with and without a staleness bound)
SCHEDULES = {
    "compare_smoke": dict(n_devices=40, mean_session_rounds=8.0,
                          mean_off_rounds=3.0, p_online0=0.7,
                          dropout_hazard=0.04, deadline_factor=2.5,
                          min_cohort=4, max_cohort=8, init_cohort=8,
                          target_round_time_factor=1.5),
    "elastic": dict(n_devices=40, dropout_hazard=0.05, deadline_factor=2.5,
                    target_round_time_factor=1.05, min_cohort=2,
                    max_cohort=16, init_cohort=8, latency_jitter=0.01),
    "quorum_shared_uplink": dict(n_devices=40, quorum_frac=0.6,
                                 shared_uplink=True, init_cohort=8),
    "async": dict(n_devices=40, dropout_hazard=0.04, async_buffer_size=4,
                  max_staleness=4, max_concurrent=8),
    "async_unbounded_shared": dict(n_devices=40, async_buffer_size=3,
                                   max_concurrent=6, shared_uplink=True),
}


def _models(arch):
    j_run = JRun(arch=arch, fed=JFed(**FED))
    t_run = RunConfig(arch=arch, fed=FedConfig(**FED))
    return ((j_build(j_registry.get_smoke_config(arch)), j_run),
            (registry.get_smoke_config(arch), t_run))


@pytest.fixture(scope="module")
def priced():
    """Both packages' mobilenet-l smoke model, run config and Ampere
    latency function."""
    (jm, j_run), (tcfg, t_run) = _models("mobilenet-l")
    from repro_torch.models import build_model
    tm = build_model(tcfg)
    return {"j": (jm, j_run, j_latency(jm, j_run, algo="ampere")),
            "t": (tm, t_run, make_latency_fn(tm, t_run, algo="ampere"))}


def test_population_equals_reference():
    for kw in SCHEDULES.values():
        a = sample_population(FleetConfig(**kw))
        b = j_population(JFleet(**kw))
        assert [dataclasses.asdict(p) for p in a] == \
            [dataclasses.asdict(p) for p in b]
    assert sample_population(FleetConfig()) == \
        sample_population(FleetConfig())


@pytest.mark.parametrize("arch,seq", [("mobilenet-l", 0),
                                      ("qwen3-1.7b", 32)])
@pytest.mark.parametrize("algo", ["ampere", "splitfed", "fedavg",
                                  "scaffold", "pipar"])
def test_latency_fn_equals_reference(arch, seq, algo):
    (jm, j_run), (tcfg, t_run) = _models(arch)
    from repro_torch.models import build_model
    tm = build_model(tcfg)
    pop = sample_population(FleetConfig(n_devices=25))
    jpop = j_population(JFleet(n_devices=25))
    tl = make_latency_fn(tm, t_run, algo=algo, seq_len=seq)
    jl = j_latency(jm, j_run, algo=algo, seq_len=seq)
    assert [tl(p) for p in pop] == [jl(p) for p in jpop]
    assert [tl.parts(p) for p in pop] == [jl.parts(p) for p in jpop]


def test_latency_fn_refuses_per_class_cuts(priced):
    """Per-class cuts are no longer refused: each class prices at its own
    cut, as the reference prices it (``tests/test_torch_cuts.py`` holds
    more cases), and an empty assignment is the uniform cut."""
    tm, t_run, _ = priced["t"]
    jm, j_run, _ = priced["j"]
    pop = sample_population(FleetConfig(n_devices=6))
    jpop = j_population(JFleet(n_devices=6))
    cut = make_latency_fn(tm, t_run, cuts={"jetson-fast": 2})
    assert [cut(p) for p in pop] == \
        [j_latency(jm, j_run, cuts={"jetson-fast": 2})(p) for p in jpop]
    assert any(cut(p) != priced["t"][2](p) for p in pop)
    lat = make_latency_fn(tm, t_run, cuts={})
    p = sample_population(FleetConfig(n_devices=1))[0]
    assert lat(p) == priced["t"][2](p)


def _traces(priced, kw, rounds, tmp_path):
    """The port's and the reference's trace of config ``kw``, each saved;
    returns (port trace, reference trace, port bytes, reference bytes)."""
    out = []
    for side, cfg_cls, pop_fn, sched in (
            ("t", FleetConfig, sample_population, FleetScheduler),
            ("j", JFleet, j_population, JScheduler)):
        cfg = cfg_cls(**kw)
        trace = sched(pop_fn(cfg), priced[side][2], cfg).simulate(rounds)
        path = tmp_path / f"{side}.jsonl"
        trace.save(str(path))
        out.append((trace, path.read_bytes()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_trace_saves_the_reference_bytes(priced, name, tmp_path):
    t_trace, j_trace, t_bytes, j_bytes = _traces(priced, SCHEDULES[name],
                                                 12, tmp_path)
    assert t_bytes == j_bytes
    assert t_trace.is_async == j_trace.is_async == name.startswith("async")
    assert t_trace.cohort_sizes == j_trace.cohort_sizes
    assert len(t_trace.events) == len(j_trace.events) > 0
    # without the events the round lines still agree
    t_trace.save(str(tmp_path / "t_noev.jsonl"), events=False)
    j_trace.save(str(tmp_path / "j_noev.jsonl"), events=False)
    assert (tmp_path / "t_noev.jsonl").read_bytes() == \
        (tmp_path / "j_noev.jsonl").read_bytes()
    back = FleetTrace.load(str(tmp_path / "t.jsonl"))
    assert back.rounds == t_trace.rounds and back.events == t_trace.events
    assert FleetTrace.peek_is_async(str(tmp_path / "t.jsonl")) == \
        JTrace.peek_is_async(str(tmp_path / "j.jsonl"))


def test_scheduler_repeats_and_seed_moves_it(priced):
    _, _, lat = priced["t"]
    cfg = FleetConfig(**SCHEDULES["compare_smoke"])
    sched = FleetScheduler(sample_population(cfg), lat, cfg)
    a, b = sched.simulate(8), sched.simulate(8)
    assert a.rounds == b.rounds and a.events == b.events
    c = FleetScheduler(sample_population(cfg), lat, cfg, seed=1).simulate(8)
    assert c.rounds != a.rounds
    for p in a.rounds:
        assert p.round_time == pytest.approx(p.t_end - p.t_start)
        assert set(p.clients).isdisjoint(p.dropped)
        assert len(p.clients) >= 1 and not p.staleness
        assert sum(p.weights) == pytest.approx(1.0)


def test_committed_trace_round_trips_in_both_packages(tmp_path):
    raw = open(COMMITTED_TRACE, "rb").read()
    t = FleetTrace.load(COMMITTED_TRACE)
    j = JTrace.load(COMMITTED_TRACE)
    assert len(t.rounds) == 12 and not t.is_async
    t.save(str(tmp_path / "t.jsonl"))
    j.save(str(tmp_path / "j.jsonl"))
    saved = (tmp_path / "t.jsonl").read_bytes()
    assert saved == (tmp_path / "j.jsonl").read_bytes()
    # the committed lines carry no per-record CRC (an older writer); a
    # re-saved trace adds one, and from there the round trip is a fixed
    # point: load and save again give the same bytes
    assert b'"_crc"' not in raw and b'"_crc"' in saved
    FleetTrace.load(str(tmp_path / "t.jsonl")).save(str(tmp_path / "u.jsonl"))
    assert (tmp_path / "u.jsonl").read_bytes() == saved
    assert FleetTrace.load(str(tmp_path / "u.jsonl")).rounds == t.rounds
    assert [p.as_cohort()["clients"].tolist() for p in t.rounds] == \
        [p.as_cohort()["clients"].tolist() for p in j.rounds]
    assert "round_time" not in t.rounds[0].as_cohort()


def test_trace_load_refuses_corrupt_and_truncated(tmp_path):
    FleetTrace.load(COMMITTED_TRACE).save(str(tmp_path / "crc.jsonl"))
    lines = (tmp_path / "crc.jsonl").read_text().splitlines(keepends=True)
    flipped = lines[2].replace('"cohort_size": 8', '"cohort_size": 9')
    assert flipped != lines[2]
    (tmp_path / "flip.jsonl").write_text("".join(
        lines[:2] + [flipped] + lines[3:]))
    with pytest.raises(ValueError, match="CRC"):
        FleetTrace.load(str(tmp_path / "flip.jsonl"))
    (tmp_path / "cut.jsonl").write_text("".join(lines[:5]))
    with pytest.raises(ValueError, match="truncated"):
        FleetTrace.load(str(tmp_path / "cut.jsonl"))


@pytest.mark.parametrize("algo", ["splitfed", "fedavg", "splitgp"])
def test_trace_round_times_equal_reference(priced, algo):
    trace = FleetTrace.load(COMMITTED_TRACE)
    jtrace = JTrace.load(COMMITTED_TRACE)
    tm, t_run, _ = priced["t"]
    jm, j_run, _ = priced["j"]
    kw = SCHEDULES["compare_smoke"]
    got = trace_round_times(trace, sample_population(FleetConfig(**kw)),
                            make_latency_fn(tm, t_run, algo=algo))
    want = j_round_times(jtrace, j_population(JFleet(**kw)),
                         j_latency(jm, j_run, algo=algo))
    assert got == want and len(got) == 12


def test_async_scheduler_raises_when_buffer_cannot_fill(priced):
    _, _, lat = priced["t"]
    kw = dict(n_devices=10, dropout_hazard=1.0, async_buffer_size=4,
              max_concurrent=4)
    msgs = []
    for sched, cfg_cls, pop_fn, lat_ in (
            (FleetScheduler, FleetConfig, sample_population, lat),
            (JScheduler, JFleet, j_population, priced["j"][2])):
        cfg = cfg_cls(**kw)
        with pytest.raises(RuntimeError, match="no progress") as e:
            sched(pop_fn(cfg), lat_, cfg).simulate(3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scheduler_journal_records(priced, tmp_path):
    _, _, lat = priced["t"]
    for name in ("compare_smoke", "async"):
        cfg = FleetConfig(**SCHEDULES[name])
        journal = RoundJournal(str(tmp_path / f"{name}.jsonl"))
        trace = FleetScheduler(sample_population(cfg), lat, cfg,
                               journal=journal).simulate(5)
        last = journal.last()
        assert last["round"] == 4 and last["phase"] == "fleet-sched"
        assert last["clients"] == list(trace.rounds[-1].clients)
        if trace.is_async:
            assert last["staleness"] == list(trace.rounds[-1].staleness)


def test_async_plans_carry_staleness_weights(priced, tmp_path):
    t_trace, _, _, _ = _traces(priced, SCHEDULES["async"], 10, tmp_path)
    assert any(max(p.staleness) > 0 for p in t_trace.rounds)
    for p in t_trace.rounds:
        assert len(p.clients) == 4 and max(p.staleness) <= 4
        np.testing.assert_array_equal(
            p.weights, aggregation.staleness_weights(p.staleness))


def test_elastic_hysteresis_boundaries():
    T = 10.0
    for cls in (ElasticCohort, JElastic):
        ec = cls(min_clients=2, max_clients=32, current=8)
        assert ec.adjust(0.8 * T, T) == 8
        assert ec.adjust(0.8 * T - 1e-9, T) == 16
        assert ec.adjust(1.25 * T, T) == 16
        assert ec.adjust(1.25 * T + 1e-9, T) == 8
        for rt in (0.9 * T, T, 1.2 * T):
            assert ec.adjust(rt, T) == 8
        assert cls(2, 32, 32).adjust(0.1 * T, T) == 32
        assert cls(2, 32, 2).adjust(10 * T, T) == 2


def test_scheduler_drives_elastic_from_measured_times(priced):
    _, _, lat = priced["t"]
    cfg = FleetConfig(**SCHEDULES["elastic"], seed=0)
    trace = FleetScheduler(sample_population(cfg), lat, cfg).simulate(30)
    sizes = trace.cohort_sizes
    assert len(set(sizes)) > 1
    assert all(cfg.min_cohort <= s <= cfg.max_cohort for s in sizes)
    for a, b in zip(sizes, sizes[1:]):
        assert b in (a, min(2 * a, cfg.max_cohort),
                     max(a // 2, cfg.min_cohort))


def test_heartbeats_equal_reference():
    t, j = Heartbeats(timeout=1.5), JHeartbeats(timeout=1.5)
    for hb in (t, j):
        hb.beat(3, now=0.0)
        hb.beat(5, now=1.0)
        hb.beat(np.int64(7), now=2.0)
    for now in (0.5, 1.6, 2.6, 3.6):
        got, want = t.alive([1, 3, 5, 7], now), j.alive([1, 3, 5, 7], now)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
    # never seen = alive (joined since the last beat window)
    assert list(t.alive([1], now=100.0)) == [1]
    assert list(t.alive([3, 5], now=2.4)) == [5]


@pytest.fixture(scope="module")
def engines():
    """Both packages' engine over one mobilenet-l smoke population."""
    (jm, j_run), (tcfg, t_run) = _models("mobilenet-l")
    from repro_torch.models import build_model
    tm = build_model(tcfg)
    t_clients = federate(make_dataset_for_model(tm, 320, seed=0), 40, 0.33,
                         seed=0)
    j_clients = j_federate(j_dataset(jm, 320, seed=0), 40, 0.33, seed=0)
    return (FleetEngine(tm, t_run, t_clients, device="cpu"),
            JEngine(jm, j_run, j_clients, seed=0))


def test_round_indices_equal_reference(engines):
    t, j = engines
    assert t.resident and j.resident
    np.testing.assert_array_equal(t.offsets, j.offsets)
    for rnd, ids in ((0, [0, 4, 7]), (3, [39, 1, 1, 20]), (11, [5])):
        np.testing.assert_array_equal(t.round_indices(rnd, ids),
                                      j.round_indices(rnd, ids))
        np.testing.assert_array_equal(t.buffered_round_indices(rnd, ids),
                                      j.buffered_round_indices(rnd, ids))
    idx = t.round_indices(3, [0, 4, 7])
    for k, c in enumerate([0, 4, 7]):
        assert (idx[k] >= t.offsets[c]).all()
        assert (idx[k] < t.offsets[c] + t.client_sizes[c]).all()
    # a device twice in one buffer trains on distinct batches
    twice = t.buffered_round_indices(3, [5, 5])
    assert not np.array_equal(twice[0], twice[1])
    assert aggregation.pad_cohort([2, 5], [0.5, 0.5], 4) == \
        j.pad_cohort([2, 5], [0.5, 0.5], 4)


def test_staleness_weights_equal_reference():
    for s in ([0, 0, 0], [0, 1, 2, 3], [4], [2, 0, 7, 1, 1]):
        got = aggregation.staleness_weights(s)
        np.testing.assert_array_equal(got, j_agg.staleness_weights(s))
        assert got.sum() == pytest.approx(1.0)


def _random_trees(k, seed):
    rng = np.random.default_rng(seed)
    def tree():
        return {"a": rng.standard_normal((5, 7)).astype(np.float32),
                "layers": [{"w": rng.standard_normal(9).astype(np.float32)},
                           {"w": rng.standard_normal(9).astype(np.float32)}],
                "b": rng.standard_normal(3).astype(np.float32)}
    return [tree() for _ in range(k)]


def _close(t_tree, j_tree, tol):
    got = jax.tree.leaves(to_numpy_tree(t_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("weights", [[0.5, 0.3, 0.2], [1.0, 0.0, 0.0],
                                     [2.0, 1.0, 1.0]])
def test_fedavg_and_fedbuff_equal_reference(weights):
    trained = _random_trees(3, 0)
    snaps = _random_trees(3, 1)
    glob = _random_trees(1, 2)[0]
    t = [from_numpy_tree(x) for x in trained]
    s = [from_numpy_tree(x) for x in snaps]
    _close(aggregation.fedavg(t, weights),
           j_agg.fedavg([jax.tree.map(jnp.asarray, x) for x in trained],
                        weights), 1e-6)
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.stack(xs), *trees)
    for server_lr in (1.0, 0.5):
        got = aggregation.fedbuff_stacked(from_numpy_tree(glob), t, s,
                                          weights, server_lr=server_lr)
        want = j_agg.fedbuff_stacked(jax.tree.map(jnp.asarray, glob),
                                     stack(trained), stack(snaps),
                                     jnp.asarray(weights), server_lr)
        _close(got, want, 1e-6)
    _close(aggregation.fedavg_stacked(t, weights),
           j_agg.fedavg_stacked(stack(trained), jnp.asarray(weights)), 1e-6)
    # snapshots all the global: the delta fold is weighted FedAvg
    g = from_numpy_tree(glob)
    _close(aggregation.fedbuff_stacked(g, t, [g] * 3, weights),
           j_agg.fedavg_stacked(stack(trained), jnp.asarray(weights)), 1e-5)


def test_version_ring_equals_reference():
    rings = [VersionRing({"x": 0}, s_max=2), JRing({"x": 0}, s_max=2)]
    for v in range(1, 6):
        for r in rings:
            r.append(v, {"x": v})
        assert rings[0].versions() == rings[1].versions()
        assert len(rings[0]) <= 3
    assert rings[0].state_dict() == rings[1].state_dict()
    assert [s["x"] for s in rings[0].snapshots(5, [0, 2, 1])] == [5, 3, 4]
    with pytest.raises(KeyError, match="s_max=2"):
        rings[0].get(2)
    back = VersionRing.from_state_dict(rings[0].state_dict(), s_max=2)
    assert back.latest() == {"x": 5} and 4 in back and 1 not in back
    with pytest.raises(ValueError):
        VersionRing(s_max=-1)
