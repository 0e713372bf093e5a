"""The synchronous baselines through the port's experiment layer against
``repro.experiments``, every system starting from the reference's init:

* ``examples/quickstart.py``'s spec shape (``ampere`` + ``splitfed`` on
  the ``mobilenet-l`` smoke config: 8 clients, cohort 4, H 8, device
  batch 16, server batch 32, Dirichlet 0.33, momentum at lr 0.2 with
  inverse_time; 256 training and 64 eval samples, 2 rounds, 2 server
  epochs): histories within 1e-4 relative (as
  ``tests/test_torch_vision_experiments.py``), accuracies within 1e-2,
  ``comm_bytes`` and ``sim_time`` ``==``, and the paper's traffic
  reduction the same in both.
* Every synchronous system on the ``qwen3-1.7b`` smoke config (4 clients,
  cohort 2, H 2, batch 4, seq 32, 2 rounds) in one spec: each history
  within 1e-5 relative, accuracies within 1e-2, the accounting ``==``.
  The reference's run is made once a session
  (``torch_experiment_parity.lm_reference``), and the launcher's tests
  read it too.
* A persisted SCAFFOLD run killed after round 0 and rerun equals an
  uninterrupted one exactly (the ``(state, controls)`` pack and the host
  generators ride in the checkpoint), as the reference's
  ``tests/test_experiments.py::test_sfl_scaffold_resume_continues_from_checkpoint``
  resumes it.
"""

import dataclasses
import os

import pytest
import torch

import torch_experiment_parity as P
from repro_torch.core.baselines import SFLTrainer
from repro_torch.experiments import resolve_setup, run_experiment
from repro_torch.interop import tree_leaves as _leaves
from repro_torch.interop import tree_map
from repro_torch.runtime.fault_tolerance import RoundJournal

SYNC = P.SYNC
QUICKSTART_FED = dict(num_clients=8, clients_per_round=4, local_steps=8,
                      device_batch_size=16, server_batch_size=32,
                      dirichlet_alpha=0.33, seed=0)
QUICKSTART_DATA = dict(train_samples=256, eval_samples=64)
ROUNDS, EPOCHS = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _specs(arch, tmp, systems, fed, data):
    j, t = P.specs(arch, tmp, fed=fed, data=data, rounds=ROUNDS,
                   epochs=EPOCHS)
    return (dataclasses.replace(j, systems=systems),
            dataclasses.replace(t, systems=systems))


def test_quickstart_spec_matches_reference(tmp_path, monkeypatch):
    j_spec, t_spec = _specs("mobilenet-l", tmp_path, ("ampere", "splitfed"),
                            QUICKSTART_FED, QUICKSTART_DATA)
    assert t_spec.validate() == []
    j_out, inits = P.reference_systems_run(j_spec)
    t_out = P.port_systems_run(t_spec, inits, monkeypatch)
    res = {name: (t_out["results"][name]["history"],
                  j_out["results"][name]["history"])
           for name in ("ampere", "splitfed")}
    P.check_histories(*res["ampere"], ROUNDS, EPOCHS, rtol=1e-4)
    P.check_rounds(*res["splitfed"], ROUNDS, rtol=1e-4)
    t_sum = t_out["summary"]
    for name in ("ampere", "splitfed"):
        for k in ("comm_bytes", "sim_time_s"):
            assert t_sum[name][k] == j_out["summary"][name][k]
    reduction = 1 - t_sum["ampere"]["comm_bytes"] / \
        t_sum["splitfed"]["comm_bytes"]
    assert 0 < reduction < 1


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """Every synchronous system on the qwen3 smoke spec: the port's run
    from the reference's inits, and the reference's (shared with the
    launcher's tests)."""
    ref = P.lm_reference(tmp_path_factory)
    _, t_spec = P.lm_specs(tmp_path_factory.mktemp("lm"))
    assert t_spec.validate() == []
    mp = pytest.MonkeyPatch()
    try:
        t_out = P.port_systems_run(t_spec, ref["inits"], mp)
    finally:
        mp.undo()
    return t_out, ref


@pytest.mark.parametrize("system", SYNC)
def test_synchronous_system_matches_reference(lm_runs, system):
    t_out, ref = lm_runs
    t_hist = t_out["results"][system]["history"]
    P.check_rounds(t_hist, ref["histories"][system], ROUNDS, rtol=1e-5)
    for k in ("comm_bytes", "sim_time_s", "num_rounds"):
        assert t_out["summary"][system][k] == ref["summary"][system][k]


def _scaffold_spec(results_dir):
    _, t = P.lm_specs(results_dir, ("scaffold",))
    return dataclasses.replace(
        t, persist=True, max_rounds=3,
        run=dataclasses.replace(t.run, checkpoint_every=1))


def test_scaffold_resume_equals_uninterrupted(tmp_path):
    whole = run_experiment(_scaffold_spec(tmp_path / "whole"), device="cpu")
    spec = _scaffold_spec(tmp_path / "killed")
    spec, model, clients, evald = resolve_setup(spec)
    workdir = os.path.join(spec.results_dir, "scaffold")
    tr = SFLTrainer(model, spec.run, clients, evald, variant="scaffold",
                    workdir=workdir, patience=spec.patience, device="cpu")
    tr.run_rounds(1)                            # killed here
    tr.runner.close()
    assert RoundJournal(os.path.join(workdir, "journal.jsonl")).last() == \
        {"phase": "sfl-scaffold", "round": 0}
    pack, meta = tr.runner.ckpt.restore()
    state, (c, c_k_all) = pack     # the (state, controls) pack survives
    assert set(state) == {"device", "server"} and meta["round"] == 0
    # the cohort's control variates have moved away from zero
    assert any(float(x.abs().sum()) > 0 for x in _leaves(c_k_all))
    resumed = run_experiment(spec, device="cpu")
    h_whole = whole["results"]["scaffold"]["history"]
    h_res = resumed["results"]["scaffold"]["history"]
    assert [r["round"] for r in h_res["rounds"]] == [0, 1, 2]
    assert h_res == h_whole
    for k in ("comm_bytes", "sim_time"):
        assert h_res[k] == h_whole[k]
    t_c, t_ck = resumed["results"]["scaffold"]["controls"]
    w_c, w_ck = whole["results"]["scaffold"]["controls"]
    # matched by key: a restored tree's dicts come back in sorted order
    assert all(_leaves(tree_map(torch.equal, (t_c, t_ck), (w_c, w_ck))))
