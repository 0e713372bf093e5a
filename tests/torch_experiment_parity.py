"""Shared by the port's experiment parity tests: one spec run through the
reference's ``run_experiment`` and through the port's from the reference
trainer's own initial states.

``specs(arch, ...)`` builds the (reference, port) ``ExperimentSpec`` pair;
``reference_run`` runs the reference from its trainer's initial states
(compiled once) and returns its result, those states as numpy trees and
its activation store; ``port_run`` runs the port on the
CPU from those states.  ``check_histories`` holds the port's history to
the reference's: losses within ``rtol`` relative (fp32; the frameworks sum
in different orders and the differences grow over the local steps and
epochs), accuracies within 1e-2 absolute (an argmax can flip on a near
tie), ``comm_bytes`` and ``sim_time`` equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.configs.base import SplitConfig as JSplit
from repro.experiments import DataSpec as JData
from repro.experiments import ExperimentSpec as JSpec
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SplitConfig as TSplit
from repro_torch.core.uit import AmpereTrainer
from repro_torch.experiments import DataSpec, ExperimentSpec, run_experiment
from repro_torch.interop import from_numpy_tree

OPTIM = dict(name="momentum", lr=0.2, schedule="inverse_time",
             decay_gamma=0.005)


def specs(arch, results_dir, *, fed, data, rounds, epochs, smoke=True,
          quantize=False, lr=0.2):
    optim = dict(OPTIM, lr=lr)
    kw = dict(name="t", arch=arch, smoke=smoke, max_rounds=rounds,
              max_server_epochs=epochs, patience=50,
              results_dir=str(results_dir))
    j = JSpec(run=JRun(arch=arch, fed=JFed(**fed), optim=JOptim(**optim),
                       split=JSplit(quantize_activations=quantize)),
              data=JData(**data), **kw)
    t = ExperimentSpec(run=TRun(arch=arch, fed=TFed(**fed),
                                optim=TOptim(**optim),
                                split=TSplit(quantize_activations=quantize)),
                       data=DataSpec(**data), **kw)
    return j, t


_INITS = {}


def reference_run(j_spec):
    """(result, initial states as numpy trees, activation store)."""
    from repro.core.uit import AmpereTrainer as JTrainer
    from repro.experiments import api as j_api
    from repro.experiments import run_experiment as j_run_experiment
    from repro.experiments import systems as j_systems

    _, model, clients, evald = j_api.resolve_setup(j_spec)
    tr = JTrainer(model, j_spec.run, clients, evald, patience=j_spec.patience)
    # one compiled init (eagerly, every parameter shape compiles its own
    # sampler), kept for the next spec with the same model, seed and split
    # (int8 payloads do not change it), handed to the reference's run as
    # fresh arrays
    key = (j_spec.arch, j_spec.smoke, j_spec.run.seed, repr(
        dataclasses.replace(j_spec.run.split, quantize_activations=False)))
    if key not in _INITS:
        dev, srv, aux = jax.jit(tr._init_states)(
            jax.random.PRNGKey(j_spec.run.seed))
        _INITS[key] = jax.tree.map(np.array, {"device": dev, "aux": aux,
                                              "server": srv})
    init = _INITS[key]
    stores = []
    make_store = j_systems.AmpereSystem._make_store
    init_states = JTrainer._init_states

    def capture(self, tr, ctx):
        stores.append(make_store(self, tr, ctx))
        return stores[-1]

    def given_init(self, key):
        st = jax.tree.map(jnp.array, init)
        return st["device"], st["server"], st["aux"]

    j_systems.AmpereSystem._make_store = capture
    JTrainer._init_states = given_init
    try:
        out = j_run_experiment(j_spec, write_results=False)
    finally:
        j_systems.AmpereSystem._make_store = make_store
        JTrainer._init_states = init_states
    return out, init, stores[0]


def port_run(t_spec, init, monkeypatch):
    """The port's run_experiment on the CPU from the reference's init."""
    def init_states(self, gen):
        st = from_numpy_tree(init, self.device)
        return st["device"], st["server"], st["aux"]

    monkeypatch.setattr(AmpereTrainer, "_init_states", init_states)
    return run_experiment(t_spec, write_results=False, device="cpu")


def check_histories(t_hist, j_hist, rounds, epochs, rtol):
    for phase, key, n in (("device", "round", rounds),
                          ("server", "epoch", epochs)):
        assert len(t_hist[phase]) == len(j_hist[phase]) == n
        for t_rec, j_rec in zip(t_hist[phase], j_hist[phase]):
            assert t_rec[key] == j_rec[key]
            for k in ("loss", "val_loss"):
                np.testing.assert_allclose(t_rec[k], j_rec[k], rtol=rtol,
                                           err_msg=f"{phase} {k}")
            np.testing.assert_allclose(t_rec["val_acc"], j_rec["val_acc"],
                                       atol=1e-2)
    for k in ("comm_bytes", "sim_time"):
        assert t_hist[k] == j_hist[k], k
