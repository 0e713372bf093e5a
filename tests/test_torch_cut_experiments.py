"""The port's heterogeneous cuts against the reference with training, on
the CPU, from the reference's initial states (``torch_experiment_parity``):

* ``examples/specs/cut_smoke.json`` without its ``observability`` section
  (queue A6): ``mobilenet-l`` smoke, six devices of two classes, phone-3g
  pinned to cut 2, through both packages' ``run_experiment``: the same
  ``cuts`` summary, histories within 1e-4 relative (as compare_smoke),
  accuracies within 1e-2, the trace records, ``comm_bytes`` and
  ``sim_time`` ``==``.
* A two-depth ``qwen3-1.7b`` smoke fleet (depths 1 and 2; rounds that
  train both buckets), held to the reference within 1e-5 relative (as
  the qwen3 smoke baselines), the cut-tagged store equal shard for shard.
* A uniform ``per_profile`` run equals the static run at its cut, for
  Ampere and a baseline.
* The Ampere-only and the over-budget refusals, with the reference's
  messages.
* A persisted heterogeneous run killed after round 1 and rerun equals an
  uninterrupted one exactly, merged parameters compared by path.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.configs.base import RunConfig as JRun
from repro.core.uit import AmpereTrainer as JTrainer
from repro.data.activation_store import ActivationStore as JStore
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import api as j_api
from repro.fleet import FleetConfig as JFleet
from repro.fleet.cuts import CutPolicy as JCut
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import ActivationStore
from repro_torch.experiments import (AmpereSystem, ExperimentSpec,
                                     SystemContext, api, resolve_setup,
                                     run_experiment)
from repro_torch.fleet import CutPolicy, FleetConfig, FleetEngine, resolve_cuts

CUT_SMOKE = str(pathlib.Path(__file__).resolve().parents[1]
                / "examples/specs/cut_smoke.json")
# the qwen3 smoke federation on a fleet of three classes, one device a
# client, phone-3g one layer deeper than the cost model's pick; seed 4
# draws two phones, and its trace trains both depths in round 0 and only
# depth 1 (a straggling phone dropped) in rounds 1 and 2
LM_FLEET = dict(n_devices=4, seed=4, p_online0=1.0,
                class_mix=(("jetson-fast", 0.4), ("jetson-slow", 0.3),
                           ("phone-3g", 0.3)),
                mean_session_rounds=50.0, mean_off_rounds=1.0,
                dropout_hazard=0.0, deadline_factor=2.0, min_cohort=2,
                max_cohort=3, init_cohort=3, heartbeat_loss_prob=0.0)
LM_CUT = dict(mode="per_profile", overrides=(("phone-3g", 2),))
LM_ROUNDS, LM_EPOCHS = 3, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _cut_smoke(cls, results_dir):
    return dataclasses.replace(cls.load(CUT_SMOKE), observability=None,
                               results_dir=str(results_dir))


def _lm_specs(results_dir, **kw):
    j, t = P.specs("qwen3-1.7b", results_dir, fed=dict(P.LM_FED,
                                                         clients_per_round=3),
                   data=P.LM_DATA, rounds=LM_ROUNDS, epochs=LM_EPOCHS)
    return (dataclasses.replace(j, fleet=JFleet(**LM_FLEET),
                                cut=JCut(**LM_CUT), **kw),
            dataclasses.replace(t, fleet=FleetConfig(**LM_FLEET),
                                cut=CutPolicy(**LM_CUT), **kw))


def _both(j_spec, t_spec):
    j_out, init, j_store = P.reference_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_run(t_spec, init, mp)
    return j_out, t_out, j_store


@pytest.fixture(scope="module")
def cut_smoke_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cut_smoke")
    t_spec = _cut_smoke(ExperimentSpec, tmp / "t")
    assert t_spec.validate() == []
    return _both(_cut_smoke(JSpec, tmp / "j"), t_spec)


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    return _both(*_lm_specs(tmp_path_factory.mktemp("lm_cuts")))


def _check(j_out, t_out, rtol):
    j_hist = j_out["results"]["ampere"]["history"]
    t_hist = t_out["results"]["ampere"]["history"]
    P.check_histories(t_hist, j_hist, len(j_hist["device"]),
                      len(j_hist["server"]), rtol)
    for t_rec, j_rec in zip(t_hist["device"], j_hist["device"]):
        for k in ("t_end", "cohort", "survivors"):
            assert t_rec[k] == j_rec[k], k
    assert t_out["summary"]["ampere"]["cuts"] == \
        j_out["summary"]["ampere"]["cuts"]
    assert t_out["spec"].run.split.split_point == \
        j_out["spec"].run.split.split_point == 1
    for k in ("comm_bytes", "sim_time_s"):
        assert t_out["summary"]["ampere"][k] == j_out["summary"]["ampere"][k]


def test_cut_smoke_matches_reference(cut_smoke_runs):
    j_out, t_out, _ = cut_smoke_runs
    assert t_out["summary"]["ampere"]["cuts"] == {
        "by_class": {"jetson-fast": 1, "phone-3g": 2}, "depths": [1, 2],
        "uniform": False}
    _check(j_out, t_out, 1e-4)


def test_two_depth_lm_fleet_matches_reference(lm_runs):
    j_out, t_out, j_store = lm_runs
    _check(j_out, t_out, 1e-5)
    cuts = t_out["summary"]["ampere"]["cuts"]
    assert cuts["depths"] == [1, 2], cuts
    # the trace trains both buckets in one round at least
    t_spec = t_out["spec"]
    _, model, _, _ = resolve_setup(t_spec)
    cuts = resolve_cuts(t_spec.cut, model, t_spec.run, t_spec.fleet,
                        seq_len=P.LM_DATA["seq_len"])
    trace, _ = api.resolve_trace(t_spec, model, t_spec.run,
                                 seq_len=P.LM_DATA["seq_len"],
                                 cuts=cuts.by_class)
    depths = [{cuts.cut_of(c) for c in p.clients}
              for p in trace.rounds[:LM_ROUNDS]]
    assert depths == [{1, 2}, {1}, {1}], depths
    result = t_out["results"]["ampere"]
    assert result["device_state"]["aux"].keys() == {"p1", "p2"}
    assert len(result["device_state"]["device"]["layers"]) == 2
    store = result["store"]
    assert store.cut_depths() == j_store.cut_depths() == [1, 2]
    for d in (1, 2):
        assert store.num_samples(cut=d) == j_store.num_samples(cut=d) > 0
        for k, v in j_store.pool(cut=d).items():
            np.testing.assert_allclose(store.pool(cut=d)[k], v, rtol=1e-5,
                                       atol=1e-5)
    assert store.bytes_received == j_store.bytes_received


def test_uniform_per_profile_equals_static(tmp_path):
    """A per_profile policy that resolves to one depth (an LM's
    activations weigh the same at every depth, so every class picks the
    shallowest cut) runs the static path, for Ampere and a baseline."""
    systems = ("ampere", "splitfed")
    _, t = P.specs("qwen3-1.7b", tmp_path, fed=P.LM_FED, data=P.LM_DATA,
                   rounds=2, epochs=1)
    fleet = FleetConfig(**dict(LM_FLEET, max_cohort=2, init_cohort=2))
    per_prof = dataclasses.replace(t, systems=systems, fleet=fleet,
                                   cut=CutPolicy(mode="per_profile"))
    out = run_experiment(per_prof, write_results=False, device="cpu")
    cuts = out["summary"]["ampere"]["cuts"]
    assert cuts["uniform"] and cuts["depths"] == [1], cuts
    static = dataclasses.replace(per_prof, cut=None)
    base = run_experiment(static, write_results=False, device="cpu")
    for name in systems:
        assert out["results"][name]["history"] == \
            base["results"][name]["history"]
        assert "cuts" not in base["summary"][name]
        assert out["summary"][name]["cuts"] == cuts


def test_ampere_only_refusal_matches_reference(tmp_path):
    j, t = _lm_specs(tmp_path, systems=("ampere", "splitfed"))
    with pytest.raises(ValueError, match="ampere-only") as j_err:
        j_api.run_experiment(j, write_results=False)
    with pytest.raises(ValueError, match="ampere-only") as t_err:
        run_experiment(t, write_results=False, device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_over_budget_refusal_matches_reference(tmp_path):
    """A heterogeneous-cut pool over ``device_pool_budget_mb`` is refused
    by the server phase (no host-streaming fallback, as the reference)."""
    j, t = _lm_specs(tmp_path)
    j_spec, j_model, j_clients, j_eval = j_api.resolve_setup(j)
    j_spec, j_cuts, _ = j_api.resolve_cut_policy(j_spec, j_model,
                                                 seq_len=32)
    t_spec, t_model, t_clients, t_eval = resolve_setup(t)
    t_spec, t_cuts, _ = api.resolve_cut_policy(t_spec, t_model, seq_len=32)
    j_run = dataclasses.replace(j_spec.run, device_pool_budget_mb=0)
    t_run = dataclasses.replace(t_spec.run, device_pool_budget_mb=0)
    j_tr = JTrainer(j_model, j_run, j_clients, j_eval, cuts=j_cuts)
    t_tr = AmpereTrainer(t_model, t_run, t_clients, t_eval, cuts=t_cuts,
                         device="cpu")
    shard = {"acts": np.ones((2, 32, 64), np.float32),
             "tokens": np.zeros((2, 32), np.int32)}
    errors = []
    for tr, store, init in (
            (j_tr, JStore(), jax.jit(j_tr._init_states)(
                jax.random.PRNGKey(0))),
            (t_tr, ActivationStore(),
             t_tr._init_states(torch.Generator().manual_seed(0)))):
        store.add(0, shard, cut=1)
        store.add(1, shard, cut=2)
        dev, srv, aux = init
        with pytest.raises(ValueError, match="resident pool") as err:
            tr.run_server_phase({"device": dev, "aux": aux}, srv, store)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    # the device phase of a heterogeneous trainer is the fleet's
    with pytest.raises(ValueError, match="fleet device phase"):
        t_tr.run_device_phase({"device": dev, "aux": aux}, 1)
    # the server block is split at the shallowest cut
    with pytest.raises(ValueError, match="shallowest cut"):
        AmpereTrainer(t_model, TRun(), t_clients, t_eval, device="cpu",
                      cuts=_shifted(t_cuts))
    with pytest.raises(ValueError, match="shallowest cut"):
        JTrainer(j_model, JRun(), j_clients, j_eval, cuts=_shifted(j_cuts))


def _shifted(cuts):
    """The assignment with every cut one layer deeper."""
    return type(cuts)({k: v + 1 for k, v in cuts.by_class.items()},
                      {k: v + 1 for k, v in cuts.by_client.items()})


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def test_killed_and_resumed_hetero_run_equals_uninterrupted(tmp_path):
    def spec(name):
        _, t = _lm_specs(tmp_path / name, persist=True)
        return dataclasses.replace(t, run=dataclasses.replace(
            t.run, checkpoint_every=1))

    full = run_experiment(spec("full"), device="cpu")
    s = spec("resumed")
    s_res, model, clients, evald = resolve_setup(s)
    s_res, cuts, _ = api.resolve_cut_policy(s_res, model, seq_len=32)
    trace, pop = api.resolve_trace(s_res, model, s_res.run, seq_len=32,
                                   cuts=cuts.by_class)
    ctx = SystemContext(model=model, run_cfg=s_res.run, clients=clients,
                        eval_data=evald, trace=trace, population=pop,
                        patience=s.patience, cuts=cuts, device="cpu",
                        workdir=str(tmp_path / "resumed/ampere"))
    dev_state, _ = AmpereSystem().init_state(ctx)
    ctx.trainer.run_fleet_device_phase(dev_state, trace, 2)   # killed
    ctx.trainer.runner.close()
    rounds = []
    run_round = FleetEngine.run_round

    def counted(self, state, round_idx, *args, **kw):
        rounds.append(round_idx)
        return run_round(self, state, round_idx, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FleetEngine, "run_round", counted)
        resumed = run_experiment(s, device="cpu")
    h_full, h_res = (o["results"]["ampere"]["history"]
                     for o in (full, resumed))
    assert h_res == h_full
    # the rerun trains only the round after its checkpoint (one bucket)
    assert rounds == [2]
    p_full, p_res = (dict(_flat(o["results"]["ampere"]["merged_params"]))
                     for o in (full, resumed))
    assert p_full.keys() == p_res.keys()
    for k in p_full:
        assert torch.equal(p_full[k], p_res[k]), k
