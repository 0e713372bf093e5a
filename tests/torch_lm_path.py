"""Checks shared by the LM main paths' test files
(``tests/test_torch_gemma2.py``, ``tests/test_torch_musicgen.py``): the
port's launcher against its own trainer, and the launcher's merged params
served as ``chip_smoke.py`` serves them against the merged eval.

Both run an arch's smoke config on the CPU under
``tests/test_torch_ampere.py``'s federation, optimizer, data and phases.
"""

import functools

import numpy as np
import torch

import test_torch_ampere as A
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import FedConfig, OptimConfig, RunConfig
from repro_torch.core import evaluate
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import ActivationStore, federate, make_dataset_for_model
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model


def run_cfg(arch):
    return RunConfig(arch=arch, fed=FedConfig(**A.FED),
                     optim=OptimConfig(**A.OPTIM))


@functools.lru_cache(maxsize=None)
def launcher_run(arch):
    """``launch.train.run_training`` on ``arch``'s smoke config on the
    CPU: its output and its train and eval sets."""
    cfg = t_registry.get_smoke_config(arch)
    model = build_model(cfg)
    train = make_dataset_for_model(model, A.N_TRAIN, seq_len=A.SEQ, seed=0)
    evald = make_dataset_for_model(model, A.N_EVAL, seq_len=A.SEQ, seed=1)
    out = launch_train.run_training(cfg, run_cfg(arch), train, evald,
                                    device="cpu", device_rounds=A.ROUNDS,
                                    server_epochs=A.EPOCHS)
    return out, train, evald


def check_launcher_matches_trainer(arch):
    """The launcher's history equals, key for key, that of the trainer
    driven phase by phase from the launcher's own init (a CPU generator
    seeded from the run's seed)."""
    cfg = t_registry.get_smoke_config(arch)
    run = run_cfg(arch)
    model = build_model(cfg)
    out, train, evald = launcher_run(arch)
    tr = AmpereTrainer(model, run, federate(train, run.fed.num_clients,
                                            run.fed.dirichlet_alpha,
                                            seed=run.seed),
                       evald, device="cpu")
    dp, sp, ap = tr._init_states(torch.Generator().manual_seed(run.seed))
    st = tr.run_device_phase({"device": dp, "aux": ap}, A.ROUNDS)
    store = tr.generate_activations(st, ActivationStore(seed=run.seed))
    tr.run_server_phase(st, sp, store, A.EPOCHS)
    got, want = out["history"], tr.history
    assert len(got["device"]) == A.ROUNDS and len(got["server"]) == A.EPOCHS
    for phase in ("device", "server"):
        for g, w in zip(got[phase], want[phase]):
            for k in ("loss", "val_loss", "val_acc"):
                assert np.isfinite(g[k])
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           err_msg=f"{phase} {k}")
    assert got["comm_bytes"] == want["comm_bytes"]
    assert got["sim_time"] == want["sim_time"]


def check_served_merged_params(arch):
    """The launcher's merged params served in ``chip_smoke.served_model``
    (the trainer's merged config): the serving steps' teacher-forced loss
    over the eval set's last 8 positions equals the forward's there, and
    the forward's mean the last epoch's val loss.

    The published config then serves the same model exactly when its head
    is untied: with a tied head its output head is the device's embedding,
    not the server's trained head, and the loss differs."""
    import chip_smoke as C
    cfg = t_registry.get_smoke_config(arch)
    out, _, evald = launcher_run(arch)
    merged, val = out["merged_params"], out["history"]["server"][-1]
    served = C.served_model(cfg)
    tokens = evald.arrays["tokens"]
    per, _ = evaluate.token_losses(served, merged, torch.as_tensor(tokens))
    np.testing.assert_allclose(float(per.mean()), val["val_loss"],
                               rtol=1e-6)
    serve = C.serve_loss(served, merged, tokens, A.SEQ - 8,
                         torch.device("cpu"))
    np.testing.assert_allclose(serve, float(per[:, -8:].mean()), rtol=1e-5)
    published = evaluate.evaluate(build_model(cfg), merged, evald,
                                  "cpu")["loss"]
    if cfg.tie_embeddings:
        assert abs(published - val["val_loss"]) > 1e-3
    else:
        assert served.cfg == build_model(cfg).cfg
        np.testing.assert_allclose(published, val["val_loss"], rtol=1e-6)
