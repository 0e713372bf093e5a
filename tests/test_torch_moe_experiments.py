"""The MoE and hybrid archs through the port's experiment layer against
``repro.experiments``, every system starting from the reference's init.

The ``granite-moe-3b-a800m``, ``qwen2-moe-a2.7b`` and
``jamba-1.5-large-398b`` smoke configs on the qwen3 smoke spec's
federation (``torch_experiment_parity.LM_FED`` / ``LM_DATA``: 4 clients,
cohort 2, H 2, batch 4, seq 32, 2 rounds, 2 server epochs): the Ampere
trainer's device and server histories (the server loss carries the MoE
balance loss into its gradient; the device and auxiliary losses leave it
out, as the reference's), and on qwen2-moe one SplitFed and one FedAvg
run, whose losses add the balance loss.  Losses within 1e-5 relative,
accuracies within 1e-2, ``comm_bytes`` and ``sim_time`` ``==``.  Each
reference run is made once per module.
"""

import dataclasses

import pytest

import torch_experiment_parity as P

ROUNDS = EPOCHS = 2
SYSTEMS = {"granite-moe-3b-a800m": ("ampere",),
           "qwen2-moe-a2.7b": ("ampere", "splitfed", "fedavg"),
           "jamba-1.5-large-398b": ("ampere",)}
CASES = [(arch, system) for arch, systems in SYSTEMS.items()
         for system in systems]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> (port's result, reference's result), made on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            j_spec, t_spec = P.specs(
                arch, tmp_path_factory.mktemp(arch), fed=P.LM_FED,
                data=P.LM_DATA, rounds=ROUNDS, epochs=EPOCHS)
            j_spec = dataclasses.replace(j_spec, systems=SYSTEMS[arch])
            t_spec = dataclasses.replace(t_spec, systems=SYSTEMS[arch])
            assert t_spec.validate() == []
            j_out, inits = P.reference_systems_run(j_spec)
            mp = pytest.MonkeyPatch()
            try:
                t_out = P.port_systems_run(t_spec, inits, mp)
            finally:
                mp.undo()
            cache[arch] = (t_out, j_out)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch,system", CASES)
def test_history_matches_reference(runs, arch, system):
    t_out, j_out = runs(arch)
    t_hist = t_out["results"][system]["history"]
    j_hist = j_out["results"][system]["history"]
    if system == "ampere":
        P.check_histories(t_hist, j_hist, ROUNDS, EPOCHS, rtol=1e-5)
    else:
        P.check_rounds(t_hist, j_hist, ROUNDS, rtol=1e-5)
    for k in ("comm_bytes", "sim_time_s"):
        assert t_out["summary"][system][k] == j_out["summary"][system][k]
