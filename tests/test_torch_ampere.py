"""The whole slice: the port's ``AmpereTrainer`` against
``repro.core.uit.AmpereTrainer`` driven through the same phases.

``qwen3-1.7b`` smoke, 4 clients, cohort 2, H=2, 2 device rounds, one-shot
activations, 2 server epochs, from the JAX trainer's own initial states
(converted through numpy) and the same synthetic data.  The JAX trainer
runs its default ``"xla"`` path; the port runs its kernel path (plain
versions on CPU).  Histories must agree: losses within 1e-5 relative
(fp32; the two frameworks sum in different orders, and the differences,
3e-7 when this test was written, grow over the 2 x 2 local steps and 2
server epochs), next-token accuracy within 1e-2 absolute (an argmax can
flip on a near tie).
"""

import functools

import jax
import numpy as np
import pytest

from repro.configs import registry
from repro.configs.base import FedConfig, OptimConfig, RunConfig
from repro.core.uit import AmpereTrainer as JTrainer
from repro.data import ActivationStore as JStore
from repro.data import federate as j_federate
from repro.data import make_dataset_for_model as j_dataset
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.uit import AmpereTrainer as TTrainer
from repro_torch.data import ActivationStore as TStore
from repro_torch.data import federate as t_federate
from repro_torch.data import make_dataset_for_model as t_dataset
from repro_torch.interop import from_numpy_tree
from repro_torch.models import build_model as t_build

ARCH = "qwen3-1.7b"
FED = dict(num_clients=4, clients_per_round=2, local_steps=2,
           device_batch_size=4, server_batch_size=8, seed=0)
OPTIM = dict(name="momentum", lr=0.2, schedule="inverse_time",
             decay_gamma=0.005)
N_TRAIN, N_EVAL, SEQ = 64, 16, 32
ROUNDS, EPOCHS = 2, 2


@functools.lru_cache(maxsize=None)
def _jax_run():
    model = j_build(registry.get_smoke_config(ARCH))
    run = RunConfig(arch=ARCH, fed=FedConfig(**FED), optim=OptimConfig(**OPTIM))
    train = j_dataset(model, N_TRAIN, seq_len=SEQ, seed=0)
    test = j_dataset(model, N_EVAL, seq_len=SEQ, seed=1)
    tr = JTrainer(model, run, j_federate(train, 4, 0.33, seed=0), test,
                  patience=50)
    dev, srv, aux = tr._init_states(jax.random.PRNGKey(run.seed))
    init = jax.tree.map(np.asarray, {"device": dev, "aux": aux, "server": srv})
    dev_state = tr.run_device_phase({"device": dev, "aux": aux}, ROUNDS)
    store = tr.generate_activations(dev_state, JStore(seed=run.seed))
    tr.run_server_phase(dev_state, srv, store, EPOCHS)
    return init, tr.history, (train, test)


@functools.lru_cache(maxsize=None)
def _torch_run():
    init, _, _ = _jax_run()
    model = t_build(t_registry.get_smoke_config(ARCH))
    run = TRun(arch=ARCH, fed=TFed(**FED), optim=TOptim(**OPTIM))
    train = t_dataset(model, N_TRAIN, seq_len=SEQ, seed=0)
    test = t_dataset(model, N_EVAL, seq_len=SEQ, seed=1)
    tr = TTrainer(model, run, t_federate(train, 4, 0.33, seed=0), test,
                  device="cpu")
    st = from_numpy_tree(init)
    dev_state = tr.run_device_phase({"device": st["device"], "aux": st["aux"]},
                                    ROUNDS)
    store = tr.generate_activations(dev_state, TStore(seed=run.seed))
    tr.run_server_phase(dev_state, st["server"], store, EPOCHS)
    return tr.history, (train, test)


def test_port_data_copies_match_jax():
    """Same corpus and partition: the port's data copies consume numpy RNG
    exactly as the JAX package's."""
    _, _, (j_train, j_test) = _jax_run()
    _, (t_train, t_test) = _torch_run()
    for a, b in ((t_train, j_train), (t_test, j_test)):
        np.testing.assert_array_equal(a.arrays["tokens"], b.arrays["tokens"])
        np.testing.assert_array_equal(a.labels, b.labels)
    jc = j_federate(j_train, 4, 0.33, seed=0)
    tc = t_federate(t_train, 4, 0.33, seed=0)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.dataset.arrays["tokens"],
                                      b.dataset.arrays["tokens"])


@pytest.mark.parametrize("phase,key", [("device", "round"),
                                       ("server", "epoch")])
def test_history_matches_jax_trainer(phase, key):
    _, j_hist, _ = _jax_run()
    t_hist, _ = _torch_run()
    n = ROUNDS if phase == "device" else EPOCHS
    assert len(j_hist[phase]) == len(t_hist[phase]) == n
    for t_rec, j_rec in zip(t_hist[phase], j_hist[phase]):
        assert t_rec[key] == j_rec[key]
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(t_rec[k], j_rec[k], rtol=1e-5,
                                       err_msg=f"{phase} {key} {t_rec[key]} {k}")
            assert np.isfinite(t_rec[k])
        np.testing.assert_allclose(t_rec["val_acc"], j_rec["val_acc"],
                                   atol=1e-2)


def test_round_batches_match_jax():
    """The per-round (K, H, b) stacking the unpooled JAX round consumes."""
    from repro.data import round_batches as j_round
    from repro_torch.data import round_batches as t_round
    _, _, (j_train, _) = _jax_run()
    _, (t_train, _) = _torch_run()
    jc = j_federate(j_train, 4, 0.33, seed=0)
    tc = t_federate(t_train, 4, 0.33, seed=0)
    for ids in ([0, 2], [3, 1]):
        np.testing.assert_array_equal(t_round(tc, ids, 2, 4)["tokens"],
                                      j_round(jc, ids, 2, 4)["tokens"])


def test_launcher_main_on_cpu(capsys):
    """``python -m repro_torch.launch.train --device cpu`` end to end: the
    same final-summary JSON as the JAX launcher, minus comm accounting."""
    import json

    from repro_torch.launch import train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--device-rounds", "1", "--server-epochs", "1",
                       "--clients", "4", "--cohort", "2", "--local-steps",
                       "1", "--batch-size", "4", "--server-batch", "8",
                       "--train-samples", "32", "--eval-samples", "8",
                       "--seq-len", "16", "--quiet"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == ARCH and summary["algo"] == "ampere"
    assert summary["final"]["epoch"] == 0
    assert np.isfinite(summary["final"]["loss"])
