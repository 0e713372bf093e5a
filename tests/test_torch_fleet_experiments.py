"""The port's fleet slice against the reference with training, on the
CPU, every system from the reference's init (``torch_experiment_parity``):

* ``examples/specs/compare_smoke.json`` — all seven of its systems
  (Ampere and FedBuff on the fleet, the SFL baselines replaying the
  committed trace, SplitFed-PA on its derived async schedule) on the
  ``mobilenet-l`` smoke config, through ``run_experiment`` in both
  packages from a temporary copy of the trace, at 2 rounds and 1 server
  epoch (the spec's 12 and 4 cut for time): losses within 1e-4 relative
  (as ``tests/test_torch_vision_experiments.py``), accuracies within
  1e-2, ``comm_bytes`` and ``sim_time`` ``==``.
* A ``qwen3-1.7b`` smoke spec with a small mixed-class fleet (4 devices,
  cohort 2, dropouts) whose trace each package simulates: Ampere through
  ``run_fleet_device_phase`` and the parallel upload, FedBuff,
  SplitFed-PA and the synchronous systems compare_smoke leaves out
  (SplitFed-V2, SCAFFOLD, PiPar) replaying it through ``cohort_plan``;
  histories within 1e-5 relative (as the qwen3 smoke baselines), the
  accounting ``==``, and the traces the same bytes.
* ``FleetEngine.run_round`` against the reference's vmapped round (a
  padded cohort) on both smoke configs, trees within 1e-5 of each leaf's
  scale floored at 1e-1 of the tree's largest; the port's sequential
  round and host-pool fallback equal to its round; a buffered round
  with a stale snapshot against the reference's; a zero-staleness
  buffered round reducing to FedAvg.
* A persisted FedBuff run killed after two aggregations and rerun
  equals an uninterrupted one exactly.
"""

import dataclasses
import functools
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.configs import registry as j_registry
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.core import auxiliary as JA
from repro.core import splitting as JS
from repro.data import federate as j_federate
from repro.data import make_dataset_for_model as j_dataset
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import api as j_api
from repro.fleet import FleetConfig as JFleet
from repro.fleet import FleetEngine as JEngine
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import aggregation, comm_model
from repro_torch.data import federate, make_dataset_for_model
from repro_torch.experiments import (ExperimentSpec,
                                     SystemContext, resolve_setup,
                                     resolve_trace, run_experiment)
from repro_torch.experiments.systems import fedbuff_schedule
from repro_torch.fleet import (FleetConfig, FleetEngine, FleetTrace,
                               make_latency_fn, sample_population,
                               trace_round_times)
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import build_model as t_build

SPECS = pathlib.Path(__file__).resolve().parents[1] / "examples/specs"
COMPARE = str(SPECS / "compare_smoke.json")
TRACE = str(SPECS / "fleet_trace_smoke.jsonl")
COMPARE_ROUNDS, COMPARE_EPOCHS = 2, 1
COMPARE_SYSTEMS = ("ampere", "splitfed", "splitfed_mb", "splitfed_pa",
                   "splitgp", "fedavg", "fedbuff")
# a small mixed fleet over the qwen3 smoke federation: one device per
# client, dropouts and stragglers, buffered aggregation of 2 updates
LM_FLEET = dict(n_devices=4, seed=0, p_online0=1.0,
                class_mix=(("jetson-fast", 0.4), ("jetson-slow", 0.3),
                           ("phone-3g", 0.3)),
                mean_session_rounds=50.0, mean_off_rounds=1.0,
                dropout_hazard=0.3, deadline_factor=2.0, min_cohort=1,
                max_cohort=2, init_cohort=2, async_buffer_size=2,
                max_staleness=2, max_concurrent=3, heartbeat_loss_prob=0.0)
LM_SYSTEMS = ("ampere", "fedbuff", "splitfed_pa", "splitfedv2", "scaffold",
              "pipar")
LM_ROUNDS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _both(tmp, j_spec, t_spec):
    """Both packages' run_experiment of a spec pair, the port from the
    reference's inits."""
    j_out, inits = P.reference_systems_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_systems_run(t_spec, inits, mp)
    return j_out, t_out


@pytest.fixture(scope="module")
def compare_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compare_smoke")
    out = {}
    for side, cls in (("j", JSpec), ("t", ExperimentSpec)):
        # each package reads its own copy: resolve_trace writes a trace
        # where the file is missing
        trace = tmp / f"{side}_trace.jsonl"
        shutil.copy(TRACE, trace)
        out[side] = dataclasses.replace(
            cls.load(COMPARE), trace_path=str(trace),
            max_rounds=COMPARE_ROUNDS, max_server_epochs=COMPARE_EPOCHS,
            results_dir=str(tmp / side))
    assert out["t"].validate() == [] and out["t"].systems == COMPARE_SYSTEMS
    return _both(tmp, out["j"], out["t"])


def _check(t_hist, j_hist, name, rounds, epochs, rtol):
    if "server" in j_hist:
        P.check_histories(t_hist, j_hist, rounds, epochs, rtol)
        for t_rec, j_rec in zip(t_hist["device"], j_hist["device"]):
            extra = set(j_rec) - {"loss", "val_loss", "val_acc"}
            assert extra and {k: t_rec[k] for k in extra} == \
                {k: j_rec[k] for k in extra}, name
    else:
        P.check_rounds(t_hist, j_hist, rounds, rtol)


@pytest.mark.parametrize("name", COMPARE_SYSTEMS)
def test_compare_smoke_matches_reference(compare_runs, name):
    j_out, t_out = compare_runs
    _check(t_out["results"][name]["history"],
           j_out["results"][name]["history"], name, COMPARE_ROUNDS,
           COMPARE_EPOCHS, 1e-4)
    assert t_out["summary"][name]["comm_bytes"] == \
        j_out["summary"][name]["comm_bytes"]


def test_compare_smoke_trace_pricing(compare_runs):
    """The clocks, recomputed: each baseline sums the committed trace's
    rounds re-priced for its own exchange on the fleet's profiles
    (``trace_round_times``); Ampere sums the trace's own round times, the
    parallel upload (the slowest client's shard over its own link) and
    the server epoch; SplitFed-PA sums its derived async schedule's
    aggregation intervals."""
    _, t_out = compare_runs
    spec, model, clients, _ = resolve_setup(t_out["spec"])
    trace = FleetTrace.load(spec.trace_path)
    pop = sample_population(spec.fleet)
    for name in ("splitfed", "splitfed_mb", "splitgp", "fedavg"):
        lat = make_latency_fn(model, spec.run, algo=name)
        want = 0.0
        for t in trace_round_times(trace, pop, lat)[:COMPARE_ROUNDS]:
            want += t
        assert t_out["results"][name]["history"]["sim_time"] == want, name
    amp = t_out["results"]["ampere"]
    store = amp["store"]
    want = 0.0
    for p in trace.rounds[:COMPARE_ROUNDS]:
        want += p.round_time
    per_sample = store.bytes_received / store.num_samples()
    bw = {p.device_id: p.bandwidth_bps for p in pop}
    want += max(len(c.dataset) * per_sample / bw[c.client_id]
                for c in clients)
    want += comm_model.ampere_server_epoch_time(
        model, spec.run.split, comm_model.TimeModel(),
        n_samples=store.num_samples())
    assert amp["history"]["sim_time"] == want
    assert [r["round"] for r in amp["history"]["device"]] == [0, 1]
    ctx = SystemContext(model=model, run_cfg=spec.run, clients=clients,
                        eval_data=None, trace=trace, population=pop,
                        fleet_cfg=spec.fleet, device="cpu")
    want = 0.0
    for p in fedbuff_schedule(ctx, COMPARE_ROUNDS,
                              algo="splitfed").rounds:
        want += p.round_time
    assert t_out["results"]["splitfed_pa"]["history"]["sim_time"] == want


def _lm_specs(tmp):
    j, t = P.lm_specs(tmp, systems=LM_SYSTEMS)
    j = dataclasses.replace(j, fleet=JFleet(**LM_FLEET), max_rounds=LM_ROUNDS)
    t = dataclasses.replace(t, fleet=FleetConfig(**LM_FLEET),
                            max_rounds=LM_ROUNDS)
    return j, t


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_fleet")
    j, t = _lm_specs(tmp)
    assert t.validate() == []
    return _both(tmp, j, t)


@pytest.mark.parametrize("name", LM_SYSTEMS)
def test_lm_fleet_systems_match_reference(lm_runs, name):
    j_out, t_out = lm_runs
    _check(t_out["results"][name]["history"],
           j_out["results"][name]["history"], name, LM_ROUNDS,
           P.LM_ROUNDS, 1e-5)


def test_lm_fleet_schedules(lm_runs, tmp_path):
    """Both packages simulate the same sync trace (same bytes) and derive
    the same async schedule, with a stale update in it; the trace has
    drops, so rounds are padded."""
    j, t = _lm_specs(tmp_path)
    j = dataclasses.replace(j, trace_path=str(tmp_path / "j.jsonl"))
    t = dataclasses.replace(t, trace_path=str(tmp_path / "t.jsonl"))
    j, jm, _, _ = j_api.resolve_setup(j)
    t, tm, clients, evald = resolve_setup(t)
    jt, jpop = j_api.resolve_trace(j, jm, j.run, seq_len=32)
    tt, tpop = resolve_trace(t, tm, t.run, seq_len=32)
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    assert any(p.dropped for p in tt.rounds)
    assert [dataclasses.asdict(p) for p in tpop] == \
        [dataclasses.asdict(p) for p in jpop]
    # loaded now that the file exists; a longer budget than it holds raises
    again, _ = resolve_trace(t, tm, t.run, seq_len=32)
    assert again.rounds == tt.rounds
    with pytest.raises(ValueError, match="regenerate"):
        resolve_trace(dataclasses.replace(t, max_rounds=LM_ROUNDS + 5),
                      tm, t.run, seq_len=32)
    ctx = SystemContext(model=tm, run_cfg=t.run, clients=clients,
                        eval_data=evald, trace=tt, population=tpop,
                        fleet_cfg=t.fleet, device="cpu")
    sched = fedbuff_schedule(ctx, LM_ROUNDS)
    assert sched.is_async and len(sched.rounds) == LM_ROUNDS
    assert any(max(p.staleness) > 0 for p in sched.rounds)
    j_out, t_out = lm_runs
    fb = t_out["results"]["fedbuff"]["history"]["device"]
    assert [r["staleness_max"] for r in fb] == \
        [max(p.staleness) for p in sched.rounds]


def test_fedbuff_killed_and_resumed_equals_uninterrupted(tmp_path,
                                                        monkeypatch):
    _, t = _lm_specs(tmp_path)
    run = dataclasses.replace(t.run, checkpoint_every=1)

    def spec(name):
        return dataclasses.replace(
            t, systems=("fedbuff",), run=run, persist=True,
            results_dir=str(tmp_path / name))

    full = run_experiment(spec("full"), device="cpu", write_results=False)
    s, model, clients, evald = resolve_setup(spec("resumed"))
    trace, pop = resolve_trace(s, model, s.run, seq_len=32)
    from repro_torch.experiments.systems import FedBuffSystem
    ctx = SystemContext(model=model, run_cfg=s.run, clients=clients,
                        eval_data=evald, trace=trace, population=pop,
                        fleet_cfg=s.fleet,
                        workdir=os.path.join(s.results_dir, "fedbuff"),
                        patience=s.patience, device="cpu")
    dev_state, _ = FedBuffSystem().init_state(ctx)
    sched = fedbuff_schedule(ctx, LM_ROUNDS)
    ctx.trainer.run_buffered_device_phase(dev_state, sched, 2)  # killed
    ctx.trainer.runner.close()
    killed = ctx.trainer.history["device"]
    assert len(killed) == 2
    # count the aggregations the resumed invocation itself trains: a rerun
    # from scratch would give the same history, a resume trains only the
    # ones after the checkpoint
    trained = []
    real = FleetEngine.run_buffered_round

    def counted(self, state, snapshots, round_idx, *a, **k):
        trained.append(round_idx)
        return real(self, state, snapshots, round_idx, *a, **k)

    monkeypatch.setattr(FleetEngine, "run_buffered_round", counted)
    resumed = run_experiment(spec("resumed"), device="cpu",
                             write_results=False)
    h_full = full["results"]["fedbuff"]["history"]
    h_res = resumed["results"]["fedbuff"]["history"]
    assert h_res == h_full
    assert len(h_full["device"]) > 2
    assert trained == list(range(2, len(h_full["device"])))
    assert h_res["device"][:2] == killed
    got = jax.tree.leaves(to_numpy_tree(
        resumed["results"]["fedbuff"]["merged_params"]))
    want = jax.tree.leaves(to_numpy_tree(
        full["results"]["fedbuff"]["merged_params"]))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_run_fleet_equals_the_ampere_system(tmp_path):
    """``AmpereTrainer.run_fleet``, the trainer's shim, runs the same
    pipeline as ``run_experiment``'s Ampere on the same trace and
    population."""
    _, t = _lm_specs(tmp_path)
    t = dataclasses.replace(t, systems=("ampere",))
    want = run_experiment(t, device="cpu", write_results=False)
    s, model, clients, evald = resolve_setup(t)
    trace, pop = resolve_trace(s, model, s.run, seq_len=32)
    from repro_torch.core.uit import AmpereTrainer
    tr = AmpereTrainer(model, s.run, clients, evald, patience=s.patience,
                       device="cpu")
    got = tr.run_fleet(trace, max_rounds=s.max_rounds,
                       max_server_epochs=s.max_server_epochs,
                       population=pop)
    assert got["history"] == want["results"]["ampere"]["history"]


# ---------------------------------------------------------------------------
# the engine against the reference's vmapped round
# ---------------------------------------------------------------------------

ENGINE_FED = dict(num_clients=6, clients_per_round=3, local_steps=2,
                  device_batch_size=4, seed=0)
LR = 0.1
TOL = 1e-5


def _close_trees(got, want, tol=TOL):
    """Leaf by leaf within ``tol`` of its largest magnitude, floored at
    1e-1 of the tree's largest (``tests/test_torch_baselines.py``)."""
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    top = max(float(np.abs(b).max()) for _, b in w if np.size(b))
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = max(1e-6, 1e-1 * top, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _engines(arch):
    """(port engine, reference engine, numpy {"device", "aux"} state)."""
    jm = j_build(j_registry.get_smoke_config(arch))
    tm = t_build(t_registry.get_smoke_config(arch))
    optim = dict(name="sgd", lr=LR)
    j_run = JRun(arch=arch, fed=JFed(**ENGINE_FED), optim=JOptim(**optim))
    t_run = TRun(arch=arch, fed=TFed(**ENGINE_FED), optim=TOptim(**optim))
    kw = {"seq_len": 16} if jm.kind == "lm" else {}
    j_clients = j_federate(j_dataset(jm, 96, seed=0, **kw), 6, 0.5, seed=0)
    t_clients = federate(make_dataset_for_model(tm, 96, seed=0, **kw), 6,
                         0.5, seed=0)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)(key)
    dev, _ = JS.split_params(jm, params, j_run.split.split_point)
    aux = jax.jit(lambda k: JA.init_aux(jm, k, j_run.split))(
        jax.random.fold_in(key, 7))
    state = jax.tree.map(np.array, {"device": dev, "aux": aux})
    return (FleetEngine(tm, t_run, t_clients, device="cpu"),
            JEngine(jm, j_run, j_clients, seed=0, donate=False), state)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mobilenet-l"])
def test_engine_round_matches_reference_vmapped_round(arch):
    t, j, state = _engines(arch)
    ids, w = [4, 1], [0.6, 0.4]     # padded to 3 with a zero-weight slot
    t_state, t_m = t.run_round(from_numpy_tree(state), 2, ids, w, LR,
                               pad_to=3)
    j_state, j_m = j.run_round(jax.tree.map(jnp.asarray, state), 2, ids,
                               w, LR, pad_to=3)
    _close_trees(to_numpy_tree(t_state), jax.tree.map(np.asarray, j_state))
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=TOL)
    # the sequential reference round sees the same batches; zero-weight
    # padding changes nothing
    s_state, s_m = t.sequential_round(from_numpy_tree(state), 2, ids, w, LR)
    _close_trees(to_numpy_tree(s_state), to_numpy_tree(t_state))
    np.testing.assert_allclose(float(s_m["loss"]), float(t_m["loss"]),
                               rtol=TOL)


@pytest.mark.parametrize("buffered", [False, True])
def test_engine_host_pool_fallback_equals_resident(buffered):
    t, _, state = _engines("qwen3-1.7b")
    host = FleetEngine(t.model, dataclasses.replace(
        t.run, device_pool_budget_mb=0), t.clients, device="cpu")
    assert t.resident and not host.resident and host.pool is None
    ids, w = [0, 3, 5], [0.5, 0.3, 0.2]
    if buffered:
        older = from_numpy_tree(jax.tree.map(
            lambda a: (a * 0.9).astype(a.dtype), state))
        cur = from_numpy_tree(state)
        a, m_a = t.run_buffered_round(cur, [cur, older, older], 5, ids, w,
                                      LR)
        b, m_b = host.run_buffered_round(cur, [cur, older, older], 5, ids,
                                         w, LR)
    else:
        a, m_a = t.run_round(from_numpy_tree(state), 5, ids, w, LR)
        b, m_b = host.run_round(from_numpy_tree(state), 5, ids, w, LR)
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert all(np.array_equal(x, y) for x, y in zip(
        jax.tree.leaves(to_numpy_tree(a)), jax.tree.leaves(to_numpy_tree(b))))


def test_buffered_round_with_stale_snapshot_matches_reference():
    t, j, state = _engines("qwen3-1.7b")
    older = jax.tree.map(lambda a: (a * 0.9).astype(a.dtype), state)
    ids, stal = [2, 2, 5], [0, 2, 1]
    w = aggregation.staleness_weights(stal)
    t_snaps = [from_numpy_tree(s) for s in (state, older, older)]
    t_new, t_m = t.run_buffered_round(from_numpy_tree(state), t_snaps, 4,
                                      ids, w, LR)
    j_snaps = j.stack_states([jax.tree.map(jnp.asarray, s)
                              for s in (state, older, older)])
    j_new, j_m = j.run_buffered_round(jax.tree.map(jnp.asarray, state),
                                      j_snaps, 4, ids, w, LR)
    _close_trees(to_numpy_tree(t_new), jax.tree.map(np.asarray, j_new))
    np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]),
                               rtol=TOL)
    # the stale snapshots moved the result away from the fresh round's
    fresh, _ = t.run_buffered_round(
        from_numpy_tree(state), [from_numpy_tree(state)] * 3, 4, ids, w, LR)
    diffs = [float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(to_numpy_tree(fresh)),
        jax.tree.leaves(to_numpy_tree(t_new)))]
    assert max(diffs) > 1e-4


def test_buffered_round_zero_staleness_is_fedavg():
    """Every snapshot the current state and uniform weights: the delta
    fold equals FedAvg of the trained states on the same (slot-seeded)
    batches."""
    t, _, state = _engines("mobilenet-l")
    cur = from_numpy_tree(state)
    ids, w = [1, 3, 4], [1 / 3] * 3
    new, m = t.run_buffered_round(cur, [cur] * 3, 2, ids, w, LR)
    idx = t.buffered_round_indices(2, ids)
    dev, aux, losses = [], [], []
    for k in range(3):
        batches = {n: v[torch.as_tensor(idx[k], dtype=torch.long)]
                   for n, v in t.pool.items()}
        d, a, loss = t._client_round(cur["device"], cur["aux"], batches, LR)
        dev.append(d)
        aux.append(a)
        losses.append(float(loss))
    with torch.no_grad():
        ref = {"device": aggregation.fedavg(dev, w),
               "aux": aggregation.fedavg(aux, w)}
    _close_trees(to_numpy_tree(new), to_numpy_tree(ref))
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=TOL)
