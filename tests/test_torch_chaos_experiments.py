"""The port's transport, quorum-degraded rounds, torn writes and
observability through every trainer and ``run_experiment``, on the CPU,
held to the reference (``torch_experiment_parity``: the reference's
initial states, histories within ``check_histories``' tolerances):

* ``examples/specs/chaos_smoke.json`` (vit-s smoke; drops, corruptions,
  duplicates, spikes, resets, torn checkpoint and journal writes;
  observability on) through both packages: the wire statistics, the
  tracer's digest, the metrics' counters, ``comm_bytes``, ``sim_time`` and
  the torn journal ``==``.
* Ampere and FedBuff under the reference chaos test's knobs: two faulted
  runs ``==``, and the faulted trajectory equals the clean one less
  ``comm_bytes`` and ``sim_time``.
* A perma-failed device: excluded and its round reweighted as the
  reference does, in the device phase and the upload; ``QuorumError``
  with the reference's message under ``quorum_frac=1.0``.
* SplitFed and FedAvg under a faulty transport, against the reference.
* The fleet scheduler's quorum rounds, with the tracer's ingested events.
* A fault-free transport with observability on equals the plain run for
  ``compare_smoke.json``'s seven systems; ``cut_smoke.json`` whole.
* A chaos run killed and resumed equals the uninterrupted one.
* ``python -m repro_torch.launch.run_experiment``.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.core import aggregation as j_aggregation
from repro.core.uit import AmpereTrainer as JTrainer
from repro.data.activation_store import ActivationStore as JStore
from repro.experiments import DataSpec as JData
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import build_transport as j_build_transport
from repro.experiments import resolve_setup as j_resolve_setup
from repro.experiments.spec import TransportSpec as JTransportSpec
from repro.fleet import FleetConfig as JFleet
from repro.transport import FaultSpec as JFaults
from repro.transport import QuorumError as JQuorumError
from repro_torch.configs.base import FedConfig, OptimConfig, RunConfig
from repro_torch.core import aggregation
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import ActivationStore
from repro_torch.experiments import (AmpereSystem, DataSpec, ExperimentSpec,
                                     ObservabilitySpec, SystemContext,
                                     TransportSpec, build_transport,
                                     resolve_setup, run_experiment)
from repro_torch.fleet import FleetConfig
from repro_torch.launch import run_experiment as cli
from repro_torch.observability import Observability
from repro_torch.transport import FaultSpec, QuorumError

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAOS_SMOKE = str(ROOT / "examples/specs/chaos_smoke.json")
CUT_SMOKE = str(ROOT / "examples/specs/cut_smoke.json")
COMPARE_SMOKE = ROOT / "examples/specs/compare_smoke.json"
ARCH = "vit-s"
# the reference chaos test's knobs: six attempts absorb every fault
TRANSPORT = dict(quorum_frac=0.5, max_attempts=6, base_backoff_s=0.01,
                 max_backoff_s=0.1, attempt_timeout_s=0.2)
FAULTS = dict(seed=7, drop_prob=0.15, corrupt_prob=0.15,
              duplicate_prob=0.1, latency_spike_prob=0.1, reset_prob=0.05)
FED = dict(num_clients=6, clients_per_round=3, local_steps=2,
           device_batch_size=4, server_batch_size=8, dirichlet_alpha=0.5)
OPTIM = dict(name="momentum", lr=0.1, schedule="inverse_time",
             decay_gamma=0.01)
FLEET = dict(n_devices=6, seed=0, min_cohort=2, max_cohort=3,
             init_cohort=3, dropout_hazard=0.0, p_online0=1.0,
             async_buffer_size=2, max_concurrent=3)
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _specs(results_dir, *, faults=None, transport=None, **kw):
    """The (reference, port) pair of the reference chaos test's vit-s spec
    (six clients, cohort 3, 2 rounds, 1 epoch)."""
    base = dict(name="tt", arch=ARCH, max_rounds=2, max_server_epochs=1,
                patience=50, **kw)
    j = JSpec(run=JRun(arch=ARCH, fed=JFed(**FED), optim=JOptim(**OPTIM)),
              data=JData(train_samples=144, eval_samples=48),
              results_dir=str(results_dir / "j"),
              transport=(JTransportSpec(**transport)
                         if transport is not None else None),
              faults=JFaults(**faults) if faults is not None else None,
              **{k: (JFleet(**v) if k == "fleet" else v)
                 for k, v in base.items()})
    t = ExperimentSpec(
        run=RunConfig(arch=ARCH, fed=FedConfig(**FED),
                      optim=OptimConfig(**OPTIM)),
        data=DataSpec(train_samples=144, eval_samples=48),
        results_dir=str(results_dir / "t"),
        transport=(TransportSpec(**transport) if transport is not None
                   else None),
        faults=FaultSpec(**faults) if faults is not None else None,
        **{k: (FleetConfig(**v) if k == "fleet" else v)
           for k, v in base.items()})
    return j, t


def _first_cohort_client():
    """A client of the spec's round-0 cohort (both packages draw it)."""
    cohort = aggregation.sample_cohort(np.random.default_rng(0),
                                       FedConfig(**FED), 0)
    return int(cohort["clients"][1])


def _no_obs(history):
    return {k: v for k, v in history.items() if k != "observability"}


def _counters(out, name="ampere"):
    return out["results"][name]["history"]["observability"]["metrics"][
        "counters"]


def _flat(tree, path=""):
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, f"{path}/{k}")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# chaos_smoke.json through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_smoke_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chaos_smoke")
    j_spec = dataclasses.replace(JSpec.load(CHAOS_SMOKE),
                                 results_dir=str(tmp / "j"))
    t_spec = dataclasses.replace(ExperimentSpec.load(CHAOS_SMOKE),
                                 results_dir=str(tmp / "t"))
    assert t_spec.validate() == []
    assert ExperimentSpec.load(CHAOS_SMOKE).to_json() == \
        JSpec.load(CHAOS_SMOKE).to_json()
    j_out, init, _ = P.reference_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_run(t_spec, init, mp)
    return tmp, j_out, t_out


def test_chaos_smoke_matches_reference(chaos_smoke_runs):
    tmp, j_out, t_out = chaos_smoke_runs
    t_sum, j_sum = t_out["summary"]["ampere"], j_out["summary"]["ampere"]
    assert t_sum["wire"] == j_sum["wire"]
    assert t_sum["wire"]["retries"] + t_sum["wire"]["duplicates"] > 0
    assert t_sum["trace"] == j_sum["trace"]
    assert _counters(t_out) == _counters(j_out)
    drop_wall = [{k: v for k, v in r.items() if k != "wall_s"}
                 for r in t_sum["phases"]]
    assert drop_wall == [{k: v for k, v in r.items() if k != "wall_s"}
                         for r in j_sum["phases"]]
    t_hist = t_out["results"]["ampere"]["history"]
    j_hist = j_out["results"]["ampere"]["history"]
    P.check_histories(t_hist, j_hist, 2, 1, RTOL)
    assert t_hist["comm_bytes"] == t_sum["wire"]["wire_bytes"]
    # the same appends tore at the same fraction: one torn journal line
    journals = [(tmp / d / "ampere" / "journal.jsonl").read_bytes()
                for d in ("t", "j")]
    assert journals[0] == journals[1]
    assert sum(1 for line in journals[0].splitlines()
               if b"_crc" not in line) == 1


# ---------------------------------------------------------------------------
# faults absorbed by retries leave the trajectory alone
# ---------------------------------------------------------------------------


def test_chaos_run_is_deterministic_and_trajectory_matches_faultfree(
        tmp_path):
    """Ampere and FedBuff on a fleet under every fault kind: two runs give
    the same summary and histories, and the faulted trajectory is the
    clean one's, only ``comm_bytes`` and ``sim_time`` larger."""
    _, faulted = _specs(tmp_path, transport=TRANSPORT, faults=FAULTS,
                        systems=("ampere", "fedbuff"), fleet=FLEET)
    out1 = run_experiment(faulted, write_results=False, device="cpu")
    out2 = run_experiment(faulted, write_results=False, device="cpu")
    assert out1["summary"] == out2["summary"]
    _, plain = _specs(tmp_path, systems=("ampere", "fedbuff"), fleet=FLEET)
    clean = run_experiment(plain, write_results=False, device="cpu")
    for name in ("ampere", "fedbuff"):
        hf = out1["results"][name]["history"]
        assert hf == out2["results"][name]["history"]
        hc = clean["results"][name]["history"]
        rest = {k: v for k, v in hf.items()
                if k not in ("comm_bytes", "sim_time")}
        assert rest == {k: v for k, v in hc.items()
                        if k not in ("comm_bytes", "sim_time")}
        assert hf["comm_bytes"] > hc["comm_bytes"]
        assert hf["sim_time"] > hc["sim_time"]
        wire = out1["summary"][name]["wire"]
        assert wire["wire_bytes"] == hf["comm_bytes"]
        assert wire["retries"] + wire["duplicates"] > 0
        assert wire["failures"] == 0
    assert "wire" not in clean["summary"]["ampere"]


# ---------------------------------------------------------------------------
# quorum-degraded rounds
# ---------------------------------------------------------------------------


def test_perma_failed_device_excluded_and_reweighted_as_reference(tmp_path):
    """A device of round 0's cohort fails every attempt: both packages
    exclude it, train the round on the survivors with the same
    renormalized weights (``pad_cohort``'s padding included) and the same
    histories; with ``quorum_frac=1.0`` the port raises the reference's
    ``QuorumError``."""
    dead = _first_cohort_client()
    faults = dict(seed=3, perma_fail_devices=(dead,))
    j_spec, t_spec = _specs(tmp_path, transport=TRANSPORT, faults=faults)
    calls = {"t": [], "j": []}

    def capture(mod, key):
        pad = mod.pad_cohort

        def wrapped(ids, weights, k):
            out = pad(ids, weights, k)
            calls[key].append(out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_aggregation, "pad_cohort",
                   capture(j_aggregation, "j"))
        j_out, init, _ = P.reference_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aggregation, "pad_cohort", capture(aggregation, "t"))
        t_out = P.port_run(t_spec, init, mp)
    assert calls["t"] == calls["j"] and len(calls["t"]) == 2
    ids, w = calls["t"][0]
    assert dead not in ids[:2] and w[2] == 0.0 and sum(w) == \
        pytest.approx(1.0)
    t_hist = t_out["results"]["ampere"]["history"]
    P.check_histories(t_hist, j_out["results"]["ampere"]["history"], 2, 1,
                      RTOL)
    assert t_out["summary"]["ampere"]["wire"] == \
        j_out["summary"]["ampere"]["wire"]

    strict = dataclasses.replace(t_spec, transport=dataclasses.replace(
        t_spec.transport, quorum_frac=1.0))
    j_strict = dataclasses.replace(j_spec, transport=dataclasses.replace(
        j_spec.transport, quorum_frac=1.0))
    with pytest.raises(QuorumError) as te:
        run_experiment(strict, write_results=False, device="cpu")
    with pytest.raises(JQuorumError) as je:
        from repro.experiments import run_experiment as j_run
        j_run(j_strict, write_results=False)
    assert str(te.value) == str(je.value)


def test_generate_activations_quorum_exclusion_matches_reference(tmp_path):
    """Client 0 fails every upload: its shards never half-land, the others
    are stored, and the wire statistics, stored bytes and ``comm_bytes``
    are the reference's; with only one client left and quorum 0.5 both
    packages raise the same ``QuorumError``."""
    def trainers(faults):
        j_spec, t_spec = _specs(tmp_path, transport=TRANSPORT,
                                faults=faults)
        j_spec, j_model, j_clients, j_eval = j_resolve_setup(j_spec)
        jt = JTrainer(j_model, j_spec.run, j_clients, j_eval,
                      transport=j_build_transport(j_spec),
                      quorum_frac=j_spec.transport.quorum_frac)
        t_spec, model, clients, evald = resolve_setup(t_spec)
        tt = AmpereTrainer(model, t_spec.run, clients, evald, device="cpu",
                           transport=build_transport(t_spec),
                           quorum_frac=t_spec.transport.quorum_frac)
        jd, _, ja = jt._init_states(jax.random.PRNGKey(0))
        td, _, ta = tt._init_states(torch.Generator().manual_seed(0))
        return ((jt, {"device": jd, "aux": ja}),
                (tt, {"device": td, "aux": ta}))

    (jt, jst), (tt, tst) = trainers(dict(seed=3, perma_fail_devices=(0,)))
    j_store, t_store = JStore(seed=0), ActivationStore(seed=0)
    jt.generate_activations(jst, j_store)
    tt.generate_activations(tst, t_store)
    assert t_store.clients() == j_store.clients() == [1, 2, 3, 4, 5]
    assert t_store.bytes_received == j_store.bytes_received
    assert tt.transport.stats == jt.transport.stats
    assert tt.history["comm_bytes"] == jt.history["comm_bytes"] > \
        t_store.bytes_received
    assert tt.history["sim_time"] == jt.history["sim_time"]

    (jt, jst), (tt, tst) = trainers(
        dict(seed=3, perma_fail_devices=(0, 1, 2, 3, 4)))
    with pytest.raises(JQuorumError) as je:
        jt.generate_activations(jst, JStore(seed=0))
    with pytest.raises(QuorumError) as te:
        tt.generate_activations(tst, ActivationStore(seed=0))
    assert str(te.value) == str(je.value)


def test_sfl_and_fedavg_under_a_faulty_transport_match_reference(tmp_path):
    """SplitFed and FedAvg with every fault kind and a perma-failed device
    of round 0's cohort: rounds reweighted over the survivors, histories
    within the gate, wire statistics and counters ``==``."""
    faults = dict(FAULTS, perma_fail_devices=(_first_cohort_client(),))
    j_spec, t_spec = _specs(tmp_path, transport=TRANSPORT, faults=faults,
                            systems=("splitfed", "fedavg"))
    j_spec = dataclasses.replace(
        j_spec, observability=JSpec.load(CHAOS_SMOKE).observability)
    t_spec = dataclasses.replace(t_spec, observability=ObservabilitySpec())
    j_out, inits = P.reference_systems_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_systems_run(t_spec, inits, mp)
    for name in ("splitfed", "fedavg"):
        P.check_rounds(t_out["results"][name]["history"],
                       j_out["results"][name]["history"], 2, RTOL)
        wire = t_out["summary"][name]["wire"]
        assert wire == j_out["summary"][name]["wire"]
        assert wire["failures"] > 0
        assert _counters(t_out, name) == _counters(j_out, name)
        assert any(k.startswith("excluded_devices")
                   for k in _counters(t_out, name))


def test_scheduler_quorum_closes_rounds_early_with_tracer_events():
    """The port's scheduler with ``quorum_frac`` closes rounds early as the
    reference's does (the same trace), and ``tracer=`` ingests the same
    scheduler-track events, the quorum instants among them."""
    from repro.fleet import FleetScheduler as JSched
    from repro.fleet import sample_population as j_pop
    from repro.observability import Observability as JObs
    from repro_torch.fleet import FleetScheduler, sample_population
    from repro_torch.transport import required_quorum

    base = dict(n_devices=12, seed=0, min_cohort=4, max_cohort=6,
                init_cohort=6, dropout_hazard=0.0, p_online0=1.0,
                mean_session_rounds=1e6)

    def lat(p):
        return 1.0 / p.speed_factor

    full = FleetScheduler(sample_population(FleetConfig(**base)), lat,
                          FleetConfig(**base)).simulate(6)
    obs, j_obs = Observability(), JObs()
    for o in (obs, j_obs):
        o.tracer._wall = lambda: 0.0
        o.tracer.t0 = 0.0
    qcfg = FleetConfig(quorum_frac=0.5, **base)
    quor = FleetScheduler(sample_population(qcfg), lat, qcfg,
                          tracer=obs.tracer).simulate(6)
    j_quor = JSched(j_pop(JFleet(quorum_frac=0.5, **base)), lat,
                    JFleet(quorum_frac=0.5, **base),
                    tracer=j_obs.tracer).simulate(6)
    assert any(p.dropped for p in quor.rounds)
    assert any(kind == "quorum" for _, kind, _, _ in quor.events)
    for p in quor.rounds:
        assert len(p.clients) >= required_quorum(p.cohort_size, 0.5)
    assert quor.total_time <= full.total_time
    assert [(p.round_idx, p.clients, p.dropped, p.t_end)
            for p in quor.rounds] == \
        [(p.round_idx, p.clients, p.dropped, p.t_end)
         for p in j_quor.rounds]
    assert [vars(e) for e in obs.tracer.events] == \
        [vars(e) for e in j_obs.tracer.events]
    assert any(e.name == "quorum" for e in obs.tracer.events)


# ---------------------------------------------------------------------------
# observability never perturbs a history
# ---------------------------------------------------------------------------


def test_faultfree_transport_and_observability_leave_compare_smoke_alone(
        tmp_path):
    """``compare_smoke.json``'s seven systems on their shared trace (1 of
    12 rounds, 1 of 4 server epochs): with a fault-free transport and
    observability on, every history equals the plain run's, the wire
    moved exactly ``comm_bytes``, and the phase tables add up to it."""
    trace = tmp_path / "trace.jsonl"
    trace.write_bytes((ROOT / "examples/specs/fleet_trace_smoke.jsonl")
                      .read_bytes())
    spec = dataclasses.replace(ExperimentSpec.load(str(COMPARE_SMOKE)),
                               trace_path=str(trace), max_rounds=1,
                               max_server_epochs=1,
                               results_dir=str(tmp_path / "r"))
    plain = run_experiment(spec, write_results=False, device="cpu")
    traced = run_experiment(dataclasses.replace(
        spec, transport=TransportSpec(), observability=ObservabilitySpec()),
        write_results=False, device="cpu")
    assert len(spec.systems) == 7
    for name in spec.systems:
        h = traced["results"][name]["history"]
        assert _no_obs(h) == plain["results"][name]["history"], name
        assert h["observability"]["tracer"]["open_spans"] == 0
        summary = traced["summary"][name]
        assert summary["wire"]["wire_bytes"] == h["comm_bytes"]
        assert summary["wire"]["retries"] == summary["wire"]["failures"] \
            == 0
        assert sum(r["bytes_total"] for r in summary["phases"]) == \
            h["comm_bytes"], name


def test_cut_smoke_whole_matches_reference(tmp_path):
    """``cut_smoke.json`` with its observability section: the histories
    within the gate, the tracer digest and counters ``==`` the
    reference's, and the port's history that of its run without it."""
    j_spec = dataclasses.replace(JSpec.load(CUT_SMOKE),
                                 results_dir=str(tmp_path / "j"))
    t_spec = dataclasses.replace(ExperimentSpec.load(CUT_SMOKE),
                                 results_dir=str(tmp_path / "t"))
    assert t_spec.observability is not None and t_spec.validate() == []
    j_out, init, _ = P.reference_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_run(t_spec, init, mp)
        bare = P.port_run(dataclasses.replace(t_spec, observability=None),
                          init, mp)
    t_hist = t_out["results"]["ampere"]["history"]
    P.check_histories(t_hist, j_out["results"]["ampere"]["history"], 2, 2,
                      RTOL)
    assert _no_obs(t_hist) == bare["results"]["ampere"]["history"]
    assert t_out["summary"]["ampere"]["trace"] == \
        j_out["summary"]["ampere"]["trace"]
    assert _counters(t_out) == _counters(j_out)
    assert "scheduler" in t_out["summary"]["ampere"]["trace"]["tracks"]


# ---------------------------------------------------------------------------
# torn writes: a killed chaos run resumes to the uninterrupted one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("killed_after,retrained", [(1, 2), (2, 0)])
def test_killed_chaos_run_resumes_to_the_uninterrupted_one(
        tmp_path, killed_after, retrained):
    """``chaos_smoke.json`` (checkpoints after every round and epoch, a
    quarter of the writes torn: here the round-0 snapshot and a journal
    line) killed after ``killed_after`` rounds and rerun from its workdir
    equals the uninterrupted run, history and merged parameters compared
    by path.  Killed after one round, the torn round-0 snapshot is
    skipped and the rerun trains both rounds from the init; after two it
    resumes from round 1's and trains none."""
    def spec(name):
        return dataclasses.replace(ExperimentSpec.load(CHAOS_SMOKE),
                                   results_dir=str(tmp_path / name))

    full = run_experiment(spec("full"), device="cpu")
    s, model, clients, evald = resolve_setup(spec("resumed"))
    obs = Observability.from_spec(s.observability)
    ctx = SystemContext(model=model, run_cfg=s.run, clients=clients,
                        eval_data=evald, patience=s.patience, device="cpu",
                        workdir=str(tmp_path / "resumed/ampere"),
                        transport=build_transport(s, obs=obs),
                        quorum_frac=s.transport.quorum_frac, obs=obs)
    dev_state, _ = AmpereSystem().init_state(ctx)
    ctx.trainer.run_device_phase(dev_state, killed_after)      # killed
    ctx.trainer.runner.close()
    rounds = []
    real = AmpereTrainer._init_states

    def counted(self, gen):
        out = real(self, gen)
        step = self._device_round

        def round_step(*a):
            rounds.append(1)
            return step(*a)
        self._device_round = round_step
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AmpereTrainer, "_init_states", counted)
        resumed = run_experiment(s, device="cpu")
    assert len(rounds) == retrained
    h_full, h_res = (_no_obs(o["results"]["ampere"]["history"])
                     for o in (full, resumed))
    assert h_res == h_full
    p_full, p_res = (dict(_flat(o["results"]["ampere"]["merged_params"]))
                     for o in (full, resumed))
    assert p_full.keys() == p_res.keys()
    for k in p_full:
        assert torch.equal(p_full[k], p_res[k]), k


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_run_experiment_cli(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.run_experiment``: a dry run, the
    socket roles' options accepted, a streaming spec's dry run, the
    default device the card, and ``--profile`` on the CPU: observability
    forced on, the phase table printed, the profiler's trace and the span
    artifacts written."""
    assert cli.main([CHAOS_SMOKE, "--dry-run"]) == 0
    assert "dry-run OK" in capsys.readouterr().out
    args = cli.make_parser().parse_args(
        [CHAOS_SMOKE, "--role", "server", "--host", "127.0.0.1", "--port",
         "7734"])
    assert (args.role, args.host, args.port) == ("server", "127.0.0.1",
                                                 7734)
    with pytest.raises(SystemExit):
        cli.make_parser().parse_args([CHAOS_SMOKE, "--role", "client"])
    capsys.readouterr()
    streaming = tmp_path / "streaming.json"
    streaming.write_text((ROOT / "examples/specs/streaming_smoke.json")
                         .read_text())
    assert cli.main([str(streaming), "--dry-run"]) == 0
    assert "dry-run OK" in capsys.readouterr().out
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([CHAOS_SMOKE, "--results-dir", str(tmp_path / "x")])
    spec = dataclasses.replace(ExperimentSpec.load(CHAOS_SMOKE),
                               observability=None, max_rounds=1)
    path = tmp_path / "spec.json"
    spec.save(str(path))
    out_dir = tmp_path / "out"
    assert cli.main([str(path), "--device", "cpu", "--profile",
                     "--results-dir", str(out_dir)]) == 0
    printed = capsys.readouterr().out
    assert "### ampere" in printed and "profiler trace:" in printed
    summary = json.loads((out_dir / "summary.json").read_text())
    assert summary["spec"]["observability"]["profile"] is True
    assert (out_dir / "profile" / "profile_trace.json").exists()
    arts = summary["summary"]["ampere"]["artifacts"]
    assert pathlib.Path(arts["trace_json"]).exists()
