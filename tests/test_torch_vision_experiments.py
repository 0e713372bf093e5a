"""The vision path of the port's experiment layer against
``repro.experiments``: ``run_experiment`` on the ``mobilenet-l`` smoke
Ampere spec shaped like ``examples/quickstart.py`` (8 clients, cohort 4,
H 8, device batch 16, server batch 32, Dirichlet 0.33, momentum at lr 0.2
with inverse_time; 256 training and 64 eval samples, 2 rounds, 2 server
epochs), from the reference trainer's own initial states, with fp32 and
with int8 activation payloads.

Histories within 1e-4 relative (losses: fp32, the frameworks sum in
different orders and 2 x 4 clients x 8 local steps carry the differences
into the aggregate) and 1e-2 absolute (accuracy); ``comm_bytes``,
``sim_time`` and the store's bytes ``==``.  The launcher runs the smoke
classifiers on the CPU.
"""

import json
import math

import numpy as np
import pytest

import torch_experiment_parity as P
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import build_model

ARCH = "mobilenet-l"
FED = dict(num_clients=8, clients_per_round=4, local_steps=8,
           device_batch_size=16, server_batch_size=32, dirichlet_alpha=0.33,
           seed=0)
DATA = dict(train_samples=256, eval_samples=64)
ROUNDS, EPOCHS = 2, 2


@pytest.mark.parametrize("quantize", [False, True])
def test_mobilenet_quickstart_matches_reference(quantize, tmp_path,
                                                monkeypatch):
    j_spec, t_spec = P.specs(ARCH, tmp_path, fed=FED, data=DATA,
                             rounds=ROUNDS, epochs=EPOCHS, quantize=quantize)
    assert t_spec.validate() == []
    j_out, init, j_store = P.reference_run(j_spec)
    t_out = P.port_run(t_spec, init, monkeypatch)
    t_res, j_res = t_out["results"]["ampere"], j_out["results"]["ampere"]
    P.check_histories(t_res["history"], j_res["history"], ROUNDS, EPOCHS,
                      rtol=1e-4)
    model = build_model(registry.get_smoke_config(ARCH))
    elems = math.prod(model.activation_spec(1, dtype="float32").shape)
    rows = elems // model.activation_spec(1).shape[-1]
    per_sample = (elems + rows * 4 if quantize else elems * 4) + 4
    assert t_res["store"].bytes_received == j_store.bytes_received == \
        DATA["train_samples"] * per_sample
    tp, jp = t_res["store"].pool(), j_store.pool()
    assert list(tp) == list(jp)
    for k in tp:
        assert tp[k].dtype == jp[k].dtype, k
    np.testing.assert_array_equal(tp["labels"], jp["labels"])


@pytest.mark.parametrize("arch", ["vgg11", "vit-s", "swin-t"])
def test_launcher_runs_smoke_classifiers_on_cpu(arch, capsys):
    rc = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--device-rounds", "1", "--server-epochs", "1",
                     "--clients", "2", "--cohort", "2", "--local-steps", "2",
                     "--batch-size", "8", "--server-batch", "16",
                     "--train-samples", "64", "--eval-samples", "32",
                     "--lr", "0.05", "--quantize-acts", "--quiet"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == arch
    assert math.isfinite(summary["final"]["val_loss"])
    assert summary["comm_bytes"] > 0
