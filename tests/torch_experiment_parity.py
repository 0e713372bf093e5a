"""Shared by the port's experiment parity tests: one spec run through the
reference's ``run_experiment`` and through the port's from the reference
trainer's own initial states.

``specs(arch, ...)`` builds the (reference, port) ``ExperimentSpec`` pair;
``reference_run`` runs the reference from its trainer's initial states
(compiled once) and returns its result, those states as numpy trees and
its activation store; ``port_run`` runs the port on the
CPU from those states.  ``reference_systems_run`` / ``port_systems_run``
do the same for a spec of any systems (the baselines too): every system
starts from the reference's compiled model init, each baseline trainer's
own initial state captured as numpy.  ``check_histories`` holds the port's
Ampere history to the reference's, ``check_rounds`` a baseline's: losses
within ``rtol`` relative (fp32; the frameworks sum in different orders and
the differences grow over the local steps and epochs), accuracies within
1e-2 absolute (an argmax can flip on a near tie), ``comm_bytes`` and
``sim_time`` equal.  ``lm_reference`` is the reference's run of every
synchronous system on the ``qwen3-1.7b`` smoke spec, made once per test
session and shared by the files that hold the port to it.
``one_torch_thread`` is the fixture body of the files that run both
packages.
"""

import contextlib
import dataclasses
import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

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
from repro_torch.core.baselines import FedAvgTrainer, SFLTrainer
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


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch on one intra-op thread while the block runs.  pytest-xdist
    runs several test processes on the machine's cores, each with JAX's
    own threads; PyTorch's default of a thread per core oversubscribes
    them, and its idle OpenMP workers spin (a 0.4 s launcher run took 10
    s under three workers)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


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


_PARAMS = {}


def reference_systems_run(j_spec):
    """(result, numpy initial state of each system): Ampere's as
    :func:`reference_run` gives it; every baseline from the model init
    compiled once per (arch, smoke, seed), an SFL trainer's ``(state,
    controls)`` captured as its ``_init_state`` returns it."""
    from repro.core.baselines import sfl_family as j_sfl
    from repro.experiments import api as j_api
    from repro.models import model_api as j_model_api

    _, model, _, _ = j_api.resolve_setup(j_spec)
    key = (j_spec.arch, j_spec.smoke, j_spec.run.seed)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.array, jax.jit(model.init)(
            jax.random.PRNGKey(j_spec.run.seed)))
    params = _PARAMS[key]
    inits = {"fedavg": params}
    model_init = j_model_api.Model.init
    sfl_init = j_sfl.SFLTrainer._init_state

    def given_params(self, k):
        if self.cfg == model.cfg:
            return jax.tree.map(jnp.array, params)
        return model_init(self, k)

    def capture(self, k):
        out = sfl_init(self, k)
        inits[self.variant] = jax.tree.map(np.array, out)
        return out

    j_model_api.Model.init = given_params
    j_sfl.SFLTrainer._init_state = capture
    try:
        if "ampere" in j_spec.systems:
            out, inits["ampere"], _ = reference_run(j_spec)
        else:
            from repro.experiments import run_experiment as j_run
            out = j_run(j_spec, write_results=False)
    finally:
        j_model_api.Model.init = model_init
        j_sfl.SFLTrainer._init_state = sfl_init
    return out, inits


def port_systems_run(t_spec, inits, monkeypatch):
    """The port's run_experiment on the CPU, every system from its
    reference init."""
    monkeypatch.setattr(SFLTrainer, "_init_state", lambda self, gen:
                        from_numpy_tree(inits[self.variant], self.device))
    monkeypatch.setattr(FedAvgTrainer, "_init_params", lambda self, gen:
                        from_numpy_tree(inits["fedavg"], self.device))
    if "ampere" in inits:
        return port_run(t_spec, inits["ampere"], monkeypatch)
    return run_experiment(t_spec, write_results=False, device="cpu")


SYNC = ("splitfed", "splitfed_mb", "splitfedv2", "splitgp", "scaffold",
        "pipar", "fedavg")
LM_FED = dict(num_clients=4, clients_per_round=2, local_steps=2,
              device_batch_size=4, server_batch_size=8, seed=0)
LM_DATA = dict(train_samples=64, eval_samples=16, seq_len=32)
LM_ROUNDS = 2


def lm_specs(results_dir, systems=SYNC):
    """The (reference, port) qwen3 smoke spec pair of ``systems``:
    ``LM_FED``, ``LM_DATA``, ``LM_ROUNDS`` rounds and server epochs."""
    j, t = specs("qwen3-1.7b", results_dir, fed=LM_FED, data=LM_DATA,
                 rounds=LM_ROUNDS, epochs=LM_ROUNDS)
    return (dataclasses.replace(j, systems=systems),
            dataclasses.replace(t, systems=systems))


def _session_shared(tmp_path_factory, name, compute):
    """``compute()``, run once per test session by whichever pytest-xdist
    worker asks first (the others wait on a file lock) and read back from
    its pickle by the rest."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released on close
        if not path.exists():
            path.write_bytes(pickle.dumps(compute()))
        return pickle.loads(path.read_bytes())


def lm_reference(tmp_path_factory) -> dict:
    """The reference's ``run_experiment`` of every synchronous system on
    the :func:`lm_specs` spec, once per session: each system's history
    and summary, and the numpy initial states the port starts from."""
    def compute():
        j_spec, _ = lm_specs(tmp_path_factory.mktemp("lm_reference"))
        j_out, inits = reference_systems_run(j_spec)
        return {"histories": {k: r["history"]
                              for k, r in j_out["results"].items()},
                "summary": j_out["summary"], "inits": inits}
    return _session_shared(tmp_path_factory, "lm_reference", compute)


def check_rounds(t_hist, j_hist, rounds, rtol):
    """A baseline's per-round history and accounting."""
    assert len(t_hist["rounds"]) == len(j_hist["rounds"]) == rounds
    for t_rec, j_rec in zip(t_hist["rounds"], j_hist["rounds"]):
        assert t_rec["round"] == j_rec["round"]
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(t_rec[k], j_rec[k], rtol=rtol,
                                       err_msg=f"round {k}")
        np.testing.assert_allclose(t_rec["val_acc"], j_rec["val_acc"],
                                   atol=1e-2)
    for k in ("comm_bytes", "sim_time"):
        assert t_hist[k] == j_hist[k], k


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
