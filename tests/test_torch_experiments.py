"""The experiment layer of the port against ``repro.experiments``.

* ``run_experiment`` on a ``qwen3-1.7b`` smoke spec (4 clients, cohort 2,
  H 2, 2 rounds, 2 server epochs, seq 32), the port starting from the
  reference trainer's own initial states: histories within the tolerances
  of ``tests/test_torch_ampere.py`` (losses 1e-5 relative, next-token
  accuracy 1e-2 absolute), and ``comm_bytes``, ``sim_time`` and the
  store's ``bytes_received`` equal.  The port's ``run_experiment`` also
  equals its trainer's phases driven by hand, bit for bit.
* Resume: a persisted run killed mid-phase (device or server) and rerun
  gives the uninterrupted run's history and accounting exactly (``==``).
* The runtime pieces (journal, checkpointer, runner, early stop) as the
  reference's ``tests/test_fault_tolerance.py`` checks them.
* The spec's JSON codec against the reference's, its refusals, and the
  MoE and hybrid archs it accepts.
* The launcher's summary against the reference launcher's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.experiments import DataSpec as JData
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import run_experiment as j_run_experiment
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SplitConfig as TSplit
from repro_torch.core import comm_model
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import ActivationStore
from repro_torch.experiments import (AmpereSystem, CutPolicy, DataSpec,
                                     ExperimentSpec, FaultSpec, FleetConfig,
                                     ObservabilitySpec, Runner, StepOutcome,
                                     StreamingSpec, SystemContext,
                                     TransportSpec, resolve_setup,
                                     run_experiment)
from repro_torch.interop import from_numpy_tree
from repro_torch.runtime.checkpoint import (CheckpointCorruptError,
                                            Checkpointer)
from repro_torch.runtime.compression import dequantize_int8
from repro_torch.runtime.fault_tolerance import RoundJournal

ARCH = "qwen3-1.7b"
FED = dict(num_clients=4, clients_per_round=2, local_steps=2,
           device_batch_size=4, server_batch_size=8, seed=0)
OPTIM = dict(name="momentum", lr=0.2, schedule="inverse_time",
             decay_gamma=0.005)
DATA = dict(train_samples=64, eval_samples=16, seq_len=32)
ROUNDS, EPOCHS = 2, 2


def _t_spec(results_dir, **kw):
    run = TRun(arch=ARCH, fed=TFed(**FED), optim=TOptim(**OPTIM),
               checkpoint_every=kw.pop("checkpoint_every", 0))
    base = dict(name="t", arch=ARCH, run=run, data=DataSpec(**DATA),
                max_rounds=ROUNDS, max_server_epochs=EPOCHS, patience=50,
                results_dir=str(results_dir))
    base.update(kw)
    return ExperimentSpec(**base)


def _j_spec(results_dir):
    run = JRun(arch=ARCH, fed=JFed(**FED), optim=JOptim(**OPTIM))
    return JSpec(name="t", arch=ARCH, run=run, data=JData(**DATA),
                 max_rounds=ROUNDS, max_server_epochs=EPOCHS, patience=50,
                 results_dir=str(results_dir))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run_experiment, its initial states and its store."""
    from repro.experiments import api as j_api
    from repro.experiments import systems as j_systems
    from repro.core.uit import AmpereTrainer as JTrainer

    spec = _j_spec(tmp_path_factory.mktemp("ref"))
    _, model, clients, evald = j_api.resolve_setup(spec)
    tr = JTrainer(model, spec.run, clients, evald, patience=spec.patience)
    dev, srv, aux = tr._init_states(jax.random.PRNGKey(spec.run.seed))
    init = jax.tree.map(np.asarray, {"device": dev, "aux": aux,
                                     "server": srv})
    stores = []
    make_store = j_systems.AmpereSystem._make_store

    def capture(self, tr, ctx):
        stores.append(make_store(self, tr, ctx))
        return stores[-1]

    j_systems.AmpereSystem._make_store = capture
    try:
        out = j_run_experiment(spec)
    finally:
        j_systems.AmpereSystem._make_store = make_store
    return out, init, stores[0]


@pytest.fixture
def reference_init(reference, monkeypatch):
    """The port trainer starts from the reference trainer's init."""
    _, init, _ = reference

    def init_states(self, gen):
        st = from_numpy_tree(init, self.device)
        return st["device"], st["server"], st["aux"]

    monkeypatch.setattr(AmpereTrainer, "_init_states", init_states)


def _check_histories(t_hist, j_hist):
    for phase, key, n in (("device", "round", ROUNDS),
                          ("server", "epoch", EPOCHS)):
        assert len(t_hist[phase]) == len(j_hist[phase]) == n
        for t_rec, j_rec in zip(t_hist[phase], j_hist[phase]):
            assert t_rec[key] == j_rec[key]
            for k in ("loss", "val_loss"):
                np.testing.assert_allclose(t_rec[k], j_rec[k], rtol=1e-5,
                                           err_msg=f"{phase} {k}")
            np.testing.assert_allclose(t_rec["val_acc"], j_rec["val_acc"],
                                       atol=1e-2)


def test_run_experiment_matches_reference(reference, reference_init,
                                          tmp_path):
    j_out, _, j_store = reference
    t_out = run_experiment(_t_spec(tmp_path), device="cpu")
    t_res, j_res = t_out["results"]["ampere"], j_out["results"]["ampere"]
    _check_histories(t_res["history"], j_res["history"])
    for k in ("comm_bytes", "sim_time"):
        assert t_res["history"][k] == j_res["history"][k], k
    assert t_res["store"].bytes_received == j_store.bytes_received
    # 64 samples of (seq x d_model) fp32 activations + seq int32 labels
    d_model = t_out["results"]["ampere"]["merged_params"]["embed"][
        "table"].shape[1]
    assert j_store.bytes_received == 64 * (32 * d_model * 4 + 32 * 4)
    t_sum, j_sum = t_out["summary"]["ampere"], j_out["summary"]["ampere"]
    for k in ("comm_bytes", "sim_time_s", "num_server", "num_device"):
        assert t_sum[k] == j_sum[k], k
    with open(tmp_path / "summary.json") as f:
        written = json.load(f)
    assert written["summary"]["ampere"]["comm_bytes"] == \
        j_res["history"]["comm_bytes"]
    with open(tmp_path / "ampere_history.json") as f:
        assert json.load(f)["device"] == t_res["history"]["device"]


def test_run_experiment_matches_trainer_phases(reference_init, tmp_path):
    """run_experiment == the port trainer's phases driven by hand (the
    twin of the reference's test_run_experiment_matches_legacy_ampere)."""
    spec = _t_spec(tmp_path)
    out = run_experiment(spec, write_results=False, device="cpu")
    spec, model, clients, evald = resolve_setup(spec)
    tr = AmpereTrainer(model, spec.run, clients, evald,
                       patience=spec.patience, device="cpu")
    dev, srv, aux = tr._init_states(torch.Generator().manual_seed(0))
    st = tr.run_device_phase({"device": dev, "aux": aux}, ROUNDS)
    store = tr.generate_activations(st, ActivationStore(seed=spec.run.seed))
    tr.run_server_phase(st, srv, store, EPOCHS)
    assert out["results"]["ampere"]["history"] == tr.history


def test_accounting_identities(tmp_path):
    """comm_bytes = rounds x 2K(s_d + s_aux) + bytes_received; sim_time =
    the rounds' slowest clients + bytes / link + epochs x server epoch,
    summed in the Runner's order."""
    from repro_torch.core import aggregation

    spec = _t_spec(tmp_path)
    out = run_experiment(spec, write_results=False, device="cpu")
    hist, store = (out["results"]["ampere"][k] for k in ("history", "store"))
    _, model, _, _ = resolve_setup(spec)
    sizes = comm_model.split_sizes(model, spec.run.split, seq_len=32)
    K = FED["clients_per_round"]
    assert hist["comm_bytes"] == \
        ROUNDS * 2 * K * (sizes.device + sizes.aux) + store.bytes_received
    rng = np.random.default_rng(FED["seed"])
    want = 0.0
    for rnd in range(ROUNDS):
        want += aggregation.sample_cohort(rng, spec.run.fed, rnd)["round_time"]
    want += store.bytes_received / comm_model.BANDWIDTH_BPS
    for _ in range(EPOCHS):
        want += comm_model.ampere_server_epoch_time(
            model, spec.run.split, comm_model.TimeModel(),
            n_samples=store.num_samples(), seq_len=32, sizes=sizes)
    assert hist["sim_time"] == want


def _kill_after(spec, *, rounds, epochs=None):
    """A persisted run stopped after ``rounds`` device rounds (and, with
    ``epochs``, the upload and that many server epochs)."""
    spec, model, clients, evald = resolve_setup(spec)
    ctx = SystemContext(model=model, run_cfg=spec.run, clients=clients,
                        eval_data=evald,
                        workdir=os.path.join(spec.results_dir, "ampere"),
                        patience=spec.patience, device="cpu")
    system = AmpereSystem()
    dev_state, srv = system.init_state(ctx)
    tr = ctx.trainer
    st = tr.run_device_phase(dev_state, rounds)
    if epochs is not None:
        store = tr.generate_activations(st, system._make_store(tr, ctx))
        tr.run_server_phase(st, srv, store, epochs)
    tr.runner.close()
    return tr.history


@pytest.mark.parametrize("killed_in", ["device", "server"])
def test_resume_equals_uninterrupted(tmp_path, killed_in):
    """persist + checkpoint_every=1: a run killed after device round 0 (or
    after server epoch 0) and rerun gives the uninterrupted history,
    comm_bytes and sim_time exactly."""
    whole = run_experiment(_t_spec(tmp_path / "whole", persist=True,
                                   checkpoint_every=1), device="cpu")
    spec = _t_spec(tmp_path / "killed", persist=True, checkpoint_every=1)
    if killed_in == "device":
        partial = _kill_after(spec, rounds=1)
        assert len(partial["device"]) == 1 and not partial["server"]
    else:
        partial = _kill_after(spec, rounds=ROUNDS, epochs=1)
        assert len(partial["server"]) == 1
    resumed = run_experiment(spec, device="cpu")
    h_whole = whole["results"]["ampere"]["history"]
    h_resumed = resumed["results"]["ampere"]["history"]
    assert h_resumed == h_whole
    assert h_resumed["comm_bytes"] == h_whole["comm_bytes"]
    assert h_resumed["sim_time"] == h_whole["sim_time"]
    journal = RoundJournal(str(tmp_path / "killed" / "ampere" /
                               "journal.jsonl"))
    assert journal.last() == {"phase": "server", "epoch": EPOCHS - 1}


def test_upload_prices_one_shared_link(tmp_path):
    """The one-shot upload adds the store's bytes to comm_bytes and their
    time over one 50 Mbps server link to sim_time (the reference's
    ``upload="serial"``), and logs one "transfer" line with those bytes."""
    spec, model, clients, evald = resolve_setup(_t_spec(tmp_path))
    tr = AmpereTrainer(model, spec.run, clients, evald,
                       workdir=str(tmp_path / "w"), patience=50,
                       device="cpu")
    dev, _, aux = tr._init_states(torch.Generator().manual_seed(0))
    store = tr.generate_activations({"device": dev, "aux": aux},
                                    ActivationStore(seed=0))
    tr.runner.close()
    assert store.bytes_received == 64 * (32 * model.cfg.d_model * 4 + 32 * 4)
    assert tr.history["comm_bytes"] == store.bytes_received
    assert tr.history["sim_time"] == (store.bytes_received /
                                      comm_model.BANDWIDTH_BPS)
    with open(tmp_path / "w" / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    transfer = [x for x in lines if x.get("phase") == "transfer"]
    assert len(transfer) == 1
    assert transfer[0]["bytes"] == store.bytes_received
    assert transfer[0]["upload"] == "serial"


def test_store_persists_shards_and_reloads(tmp_path):
    from repro_torch.data.activation_store import load_store

    rng = np.random.default_rng(0)
    st = ActivationStore(directory=str(tmp_path), seed=3)
    for cid in (2, 0, 2):
        shard = {"acts": rng.normal(size=(5, 4, 8)).astype(np.float64),
                 "tokens": rng.integers(0, 9, (5, 4)).astype(np.int32)}
        st.add(cid, shard)
    assert st.bytes_received == 3 * (5 * 4 * 8 * 4 + 5 * 4 * 4)
    assert st.clients() == [0, 2] and st.num_samples(2) == 10
    back = load_store(str(tmp_path), seed=3)
    assert back.num_samples() == 15
    np.testing.assert_array_equal(back.pool(0)["acts"], st.pool(0)["acts"])
    assert st.pool()["acts"].dtype == np.float32
    # an int8 store: one fp32 scale a row, the labels as they are
    q = ActivationStore(directory=str(tmp_path / "q"), quantize_int8=True)
    q.add(1, shard)
    assert q.bytes_received == 5 * 4 * 8 + 5 * 4 * 4 + 5 * 4 * 4
    assert q.pool()["acts"].dtype == np.int8
    assert q.pool()["acts_scale"].shape == (5, 4, 1)
    back = load_store(str(tmp_path / "q")).pool()
    deq = dequantize_int8(torch.from_numpy(back["acts"]),
                          torch.from_numpy(back["acts_scale"])).numpy()
    np.testing.assert_allclose(deq, shard["acts"],
                               atol=np.abs(shard["acts"]).max() / 254)


def test_pool_over_budget_raises(tmp_path):
    """A pool over ``device_pool_budget_mb`` no longer raises: both phases
    stream from the host, as the reference's fallbacks do, and the run
    equals the resident one exactly."""
    spec = _t_spec(tmp_path)
    over = dataclasses.replace(spec, run=dataclasses.replace(
        spec.run, device_pool_budget_mb=0))
    resident = run_experiment(spec, write_results=False, device="cpu")
    streamed = run_experiment(over, write_results=False, device="cpu")
    assert streamed["results"]["ampere"]["history"] == \
        resident["results"]["ampere"]["history"]


# ---------------------------------------------------------------------------
# runtime: twins of tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


def test_journal_skips_torn_middle_line(tmp_path):
    j = RoundJournal(str(tmp_path / "j.jsonl"))
    j.append({"phase": "device", "round": 3})
    with open(j.path, "a") as f:
        f.write('{"phase": "device", "rou\n')  # torn mid-journal
    j.append({"phase": "device", "round": 4})
    j.append({"phase": "device", "round": 5})
    assert j.last() == {"phase": "device", "round": 5}


def test_journal_rejects_bitflipped_and_unverifiable(tmp_path):
    j = RoundJournal(str(tmp_path / "j.jsonl"))
    j.append({"phase": "device", "round": 3})
    j.append({"phase": "device", "round": 9})
    with open(j.path) as f:
        lines = f.readlines()
    rec = json.loads(lines[1])
    rec["round"] = 8                 # still valid JSON; the CRC mismatches
    lines[1] = json.dumps(rec) + "\n"
    with open(j.path, "w") as f:
        f.writelines(lines)
        f.write(json.dumps({"phase": "device", "round": 99}) + "\n")
    assert j.last() == {"phase": "device", "round": 3}
    assert RoundJournal(str(tmp_path / "empty.jsonl")).last() is None


def test_checkpointer_sweeps_stale_tmp_dirs(tmp_path):
    stale = tmp_path / "tmp.7.12345"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"partial")
    ck = Checkpointer(str(tmp_path))
    assert not stale.exists()
    ck.save(1, {"x": torch.ones(2)}, {"phase": "p"})
    got, meta = ck.restore()
    assert meta["step"] == 1 and float(got["x"][0]) == 1.0


def test_checkpoint_keeps_dtypes_devices_and_structure(tmp_path):
    """bf16 leaves travel as their uint16 bits (never as float32); tensors
    come back on the asked device with their dtype; lists, None and Python
    numbers keep their kinds; ``keep`` counts per phase."""
    tree = {"w": torch.randn(3, 5, dtype=torch.bfloat16),
            "layers": [{"a": torch.arange(4, dtype=torch.int32)},
                       {"a": torch.zeros(2)}],
            "none": None, "step": 7, "lr": 0.5}
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save_async(3, tree, {"phase": "device", "round": 3})
    ck.wait()
    with np.load(tmp_path / "step_3" / "arrays.npz") as z:
        assert z["w"].dtype == np.uint16
    got, meta = ck.restore(device="cpu")
    assert meta["round"] == 3 and "torch_dtypes" not in meta
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            tree["w"])
    assert got["layers"][0]["a"].dtype == torch.int32
    assert got["none"] is None
    assert got["step"] == 7 and type(got["step"]) is int
    assert got["lr"] == 0.5 and type(got["lr"]) is float
    for s in (4, 5):
        ck.save(s, tree, {"phase": "device"})
    ck.save(6, tree, {"phase": "server"})
    assert [s for s, _ in ck._step_dirs()] == [4, 5, 6]


def test_runner_checkpoint_cadence_skips_step0(tmp_path):
    r = Runner(str(tmp_path), patience=100)
    def body(s, i, _p):
        return StepOutcome(state=s, record={"round": i})

    r.run_phase("p", 0, ((i, None) for i in range(7)), body,
                history_key="rounds", checkpoint_every=3)
    assert [step for step, _ in r.ckpt._step_dirs()] == [2, 5]


@pytest.mark.parametrize("workdir", [False, True])
def test_runner_body_owns_its_state(tmp_path, workdir):
    """While a step body runs, the Runner holds no reference to the state
    it was given (a checkpoint copies it to the host first): a body that
    rebinds its argument frees the old state before it goes on, as the
    server epoch frees its optimizer buffers before the merged
    evaluation.  A state handed over in a one-element list is taken out
    of it."""
    import gc
    import weakref

    class State:
        def __init__(self, step):
            self.step = step
            self.t = torch.full((3,), float(step))

    def tree(s):
        return {"t": s.t}

    freed = []

    def body(state, i, _p):
        old = weakref.ref(state)
        state = State(i + 1)
        gc.collect()
        freed.append(old() is None)
        return StepOutcome(state=state, record={"round": i})

    r = Runner(str(tmp_path) if workdir else None, patience=100)
    if workdir:   # checkpoint a tree of the state's tensors every step
        save = r.ckpt.save_async
        r.ckpt.save_async = lambda step, s, meta: save(step, tree(s), meta)
    held = [State(0)]
    out = r.run_phase("p", held, ((i, None) for i in range(3)), body,
                      history_key="rounds", checkpoint_every=1)
    r.close()
    assert held == [] and out.step == 3
    assert freed == [True, True, True]


SERIES = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 1.01]


def _series_body(s, i, _p):
    return StepOutcome(state=s, record={"round": i, "val_loss": SERIES[i]},
                       comm_bytes=10, sim_time=0.5)


def test_early_stop_state_survives_resume(tmp_path):
    """A killed and resumed run stops at the same round as an
    uninterrupted one (best at round 1, patience 3: stop after round 4),
    and — the port restores the history with the state — its history and
    accounting equal the uninterrupted run's."""
    def run(workdir, start, stop_after=None):
        r = Runner(str(workdir), patience=3)
        state, first = r.restore("p", 0)
        assert first == start
        n = len(SERIES) if stop_after is None else stop_after
        r.run_phase("p", state, ((i, None) for i in range(first, n)),
                    _series_body, history_key="rounds", monitor="val_loss",
                    mode="min", checkpoint_every=1)
        r.close()
        return r.history

    whole = run(tmp_path / "A", start=0)
    assert [rec["round"] for rec in whole["rounds"]] == [0, 1, 2, 3, 4]
    assert whole["comm_bytes"] == 50 and whole["sim_time"] == 2.5
    killed = run(tmp_path / "B", start=0, stop_after=3)
    assert [rec["round"] for rec in killed["rounds"]] == [0, 1, 2]
    assert run(tmp_path / "B", start=3) == whole


def test_already_stopped_phase_trains_nothing_on_resume(tmp_path):
    r = Runner(str(tmp_path), patience=3)
    r.run_phase("p", 0, ((i, None) for i in range(len(SERIES))),
                _series_body, history_key="rounds", monitor="val_loss",
                mode="min", checkpoint_every=1)
    r.close()
    r2 = Runner(str(tmp_path), patience=3)
    state, first = r2.restore("p", 0)
    assert first == 5
    before = json.dumps(r2.history)
    r2.run_phase("p", state, ((i, None) for i in range(first, 100)),
                 _series_body, history_key="rounds", monitor="val_loss",
                 mode="min", checkpoint_every=1)
    assert json.dumps(r2.history) == before        # nothing retrained
    r2.close()


def _corrupt(path, mode, rng):
    data = bytearray(path.read_bytes())
    if mode == "truncate":
        path.write_bytes(bytes(data[:max(1, int(len(data) *
                                               rng.uniform(0.05, 0.95)))]))
    else:                             # flip one random bit
        i = int(rng.integers(len(data)))
        data[i] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(data))


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_snapshot_is_skipped(tmp_path, mode):
    rng = np.random.default_rng(0 if mode == "truncate" else 1)
    for trial in range(4):
        d = tmp_path / f"ck{trial}"
        ck = Checkpointer(str(d), keep=3)
        ck.save(1, {"x": torch.full((16,), 1.0)}, {"phase": "p"})
        ck.save(2, {"x": torch.full((16,), 2.0)}, {"phase": "p"})
        _corrupt(d / "step_2" / "arrays.npz", mode, rng)
        got, meta = ck.restore()
        assert meta["step"] == 1 and float(got["x"][0]) == 1.0
        with pytest.raises(CheckpointCorruptError):
            ck.restore(step=2)
    r = Runner(str(tmp_path / "run"), patience=5)
    r.ckpt.save(0, {"x": torch.zeros(4)}, {"phase": "p", "round": 0})
    r.ckpt.save(1, {"x": torch.ones(4)}, {"phase": "p", "round": 1})
    _corrupt(tmp_path / "run" / "ckpt" / "step_1" / "arrays.npz", mode, rng)
    state, first = r.restore("p", None)
    assert first == 1 and float(state["x"][0]) == 0.0
    r.close()


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


def _both_specs(**sections):
    """The same spec in both packages, optional sections included."""
    from repro.experiments import (ObservabilitySpec as JObs,
                                   StreamingSpec as JStream,
                                   TransportSpec as JTransport)
    from repro.fleet import FleetConfig as JFleet
    from repro.fleet.cuts import CutPolicy as JCut
    from repro.transport.faults import FaultSpec as JFault

    classes = {"fleet": (FleetConfig, JFleet), "cut": (CutPolicy, JCut),
               "transport": (TransportSpec, JTransport),
               "faults": (FaultSpec, JFault),
               "observability": (ObservabilitySpec, JObs),
               "streaming": (StreamingSpec, JStream)}
    t_kw = {k: classes[k][0](**v) for k, v in sections.items()}
    j_kw = {k: classes[k][1](**v) for k, v in sections.items()}
    return (_t_spec("results/t", **t_kw),
            dataclasses.replace(_j_spec("results/t"), **j_kw))


@pytest.mark.parametrize("sections", [
    {},
    {"fleet": dict(n_devices=4, class_mix=(("jetson-fast", 0.5),
                                           ("phone-3g", 0.5))),
     "cut": dict(mode="per_profile", overrides=(("phone-3g", 1),)),
     "transport": {}, "faults": dict(perma_fail_devices=(1, 2)),
     "observability": {}, "streaming": dict(low_watermark=3)},
], ids=["plain", "all_sections"])
def test_spec_json_roundtrip_matches_reference(sections):
    t_spec, j_spec = _both_specs(**sections)
    assert t_spec.to_dict() == j_spec.to_dict()
    back = ExperimentSpec.from_json(t_spec.to_json())
    assert back == t_spec and back.to_json() == t_spec.to_json()
    assert back.to_json() == j_spec.to_json()
    assert ExperimentSpec.from_json(j_spec.to_json()) == t_spec


def test_spec_save_load_and_partial_dicts(tmp_path):
    spec = _t_spec(tmp_path)
    spec.save(str(tmp_path / "s.json"))
    assert ExperimentSpec.load(str(tmp_path / "s.json")) == spec
    part = ExperimentSpec.from_dict(
        {"name": "x", "run": {"fed": {"num_clients": 9,
                                      "clients_per_round": 3}}})
    assert part.run.fed.num_clients == 9
    assert part.run.fed.local_steps == TFed().local_steps
    with pytest.raises(KeyError):
        ExperimentSpec.from_dict({"name": "x", "sytems": ["ampere"]})
    with pytest.raises(KeyError):
        ExperimentSpec.from_dict({"run": {"fed": {"num_cilents": 9}}})


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_hybrid_specs_validate_and_dry_run(arch):
    """The MoE and hybrid archs (once refused by ``validate``) validate
    clean in both packages and pass the port's dry run."""
    spec = dataclasses.replace(_t_spec("results/t"), arch=arch)
    assert spec.validate() == []
    assert dataclasses.replace(_j_spec("results/t"),
                               arch=arch).validate() == []
    out = run_experiment(spec, dry_run=True)
    assert out["valid"] and out["systems"] == list(spec.systems)


@pytest.mark.parametrize("feature,value", [
    ("transport", TransportSpec()),
    ("faults", FaultSpec(seed=7, drop_prob=0.1, torn_write_prob=0.25)),
    ("observability", ObservabilitySpec()),
    ("streaming", StreamingSpec()),
    ("transport", TransportSpec(kind="socket")),
])
def test_transport_faults_observability_specs_validate_clean(feature,
                                                             value):
    """An in-process transport, fault injection and observability (queue
    A6a), streaming and the socket transport (A6b) run now: each section
    validates clean and passes a dry run."""
    spec = dataclasses.replace(_t_spec("results/t"), **{feature: value})
    assert spec.validate() == []
    assert run_experiment(spec, dry_run=True)["valid"]


@pytest.mark.parametrize("feature,value", [
    ("fleet", FleetConfig(n_devices=4)),
    ("trace_path", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples/specs/fleet_trace_smoke.jsonl")),
    ("systems", ("ampere", "splitfed_pa")),
    ("systems", ("fedbuff",)),
    ("cut", CutPolicy(mode="per_profile")),
])
def test_fleet_and_buffered_specs_validate_clean(feature, value):
    """A fleet, a committed trace and the buffered systems (queue A5) run
    now, and so does a per-profile cut (A5b); a buffered system takes its
    schedule, and a per-profile cut its device classes, from the fleet
    section."""
    kw = {feature: value}
    if feature in ("systems", "cut"):
        kw["fleet"] = FleetConfig(n_devices=4)
    spec = dataclasses.replace(_t_spec("results/t"), **kw)
    assert spec.validate() == []
    assert run_experiment(spec, dry_run=True)["valid"]
    # without a population to derive it from, the buffered schedule (and
    # the per-class cut) is refused as the reference refuses it
    if feature in ("systems", "cut"):
        bare = dataclasses.replace(spec, fleet=None)
        assert any("fleet section" in p for p in bare.validate())


@pytest.mark.parametrize("arch", ["mobilenet-l", "vgg11", "vit-s",
                                  "swin-t"])
@pytest.mark.parametrize("quantize", [False, True])
def test_vision_and_int8_specs_validate_clean(arch, quantize):
    """The vision archs (queue A3) and int8 activations (A2) run now."""
    spec = _t_spec("r", arch=arch, run=TRun(
        arch=arch, split=TSplit(quantize_activations=quantize)))
    assert spec.validate() == []
    assert run_experiment(spec, dry_run=True)["valid"]
    lm = _t_spec("r", run=TRun(arch=ARCH, split=TSplit(
        quantize_activations=quantize)))
    assert lm.validate() == []


def test_spec_keeps_reference_checks():
    assert _t_spec("r").validate() == []
    assert _t_spec("r", cut=CutPolicy()).validate() == []   # static: runs
    bad = _t_spec("r", systems=("ampere", "nope"), arch="zzz", max_rounds=0,
                  max_server_epochs=0)
    problems = "\n".join(bad.validate())
    for word in ("nope", "zzz", "max_rounds", "max_server_epochs"):
        assert word in problems
    assert "outside [1, 2]" in "\n".join(dataclasses.replace(
        _t_spec("r"), run=TRun(split=TSplit(split_point=3))).validate())
    out = run_experiment(_t_spec("r"), dry_run=True)
    assert out["valid"] and out["systems"] == ["ampere"]


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_summary_matches_reference(capsys, tmp_path):
    """``main(["--device", "cpu", ...])`` prints the reference launcher's
    comm_bytes and sim_time_s for the same arguments; --workdir keeps the
    checkpoints, journal and activation shards."""
    from repro.launch import train as j_train
    from repro_torch.launch import train as t_train

    args = ["--arch", ARCH, "--smoke", "--device-rounds", "2",
            "--server-epochs", "1", "--clients", "4", "--cohort", "2",
            "--local-steps", "1", "--batch-size", "4", "--server-batch", "8",
            "--train-samples", "32", "--eval-samples", "8", "--seq-len", "16",
            "--quiet", "--checkpoint-every", "1"]
    assert j_train.main(args) == 0
    j_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_train.main(args + ["--device", "cpu", "--workdir",
                                str(tmp_path), "--patience", "9"]) == 0
    t_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_sum["comm_bytes"] == j_sum["comm_bytes"] > 0
    assert t_sum["sim_time_s"] == j_sum["sim_time_s"] > 0
    assert sorted(os.listdir(tmp_path)) == ["acts", "ckpt", "journal.jsonl",
                                           "metrics.jsonl"]
    assert RoundJournal(str(tmp_path / "journal.jsonl")).last() == \
        {"phase": "server", "epoch": 0}
