"""The port's launcher against ``repro.launch.train`` for every ``--algo``,
and the Ampere paths that came with the baselines:

* The two parsers give the same default for every option they share
  (``--device`` is the port's own), and the same ``--algo`` choices.  The
  reference builds its parser inside ``main``; it is read here by
  stopping ``main`` at ``parse_args``.
* ``main`` on the ``qwen3-1.7b`` smoke config for each ``--algo``: the
  summary's ``comm_bytes`` and ``sim_time_s`` ``==`` the reference's on
  the same arguments, a finite final record.  For Ampere the reference's
  ``main`` runs here; for a baseline its summary comes from the
  reference's run of the same spec, made once a session and shared with
  ``tests/test_torch_baselines_experiments.py``
  (``torch_experiment_parity.lm_reference``), and the reference's
  ``main`` for ``splitfed`` prints exactly that run's summary, which
  shows the arguments coincide.  ``ampere-noconsolidation``
  prints ``ampere``'s summary in both packages (the reference's flag
  picks the same whole pool either way, and the port runs Ampere itself
  for it: ROADMAP.md C4).
* Ampere with ``device_pool_budget_mb=0``: both phases stream from the
  host (per-round batches; the server's store batches through the
  prefetcher), fp32 and int8 payloads, and the history equals the
  resident run's and, within 1e-5 relative, the reference's fallback run
  from the same init, the accounting ``==``; the prefetcher alone keeps
  the producer's order and raises its error.
"""

import argparse
import dataclasses
import io
import json
import math
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.launch import train as j_train
from repro_torch.data.pipeline import DevicePrefetcher
from repro_torch.launch import train as t_train

# the launcher's arguments of torch_experiment_parity.lm_specs' spec
ARGS = ["--arch", "qwen3-1.7b", "--smoke", "--device-rounds", "2",
        "--server-epochs", "1", "--clients", "4", "--cohort", "2",
        "--local-steps", "2", "--batch-size", "4", "--server-batch", "8",
        "--train-samples", "64", "--eval-samples", "16", "--seq-len", "32",
        "--quiet"]
FED, DATA = P.LM_FED, P.LM_DATA


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


class _Parsed(Exception):
    pass


def _reference_parser() -> argparse.ArgumentParser:
    """The parser ``repro.launch.train.main`` builds, caught at its
    ``parse_args``."""
    caught = []

    def stop(self, *a, **k):
        caught.append(self)
        raise _Parsed

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed):
            j_train.main([])
    return caught[0]


def _options(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parsers_share_defaults():
    ref = _options(_reference_parser())
    port = _options(t_train.make_parser())
    assert set(port) - set(ref) == {"device"}
    assert set(ref) == set(port) - {"device"}
    for dest, action in ref.items():
        assert port[dest].default == action.default, dest
        assert port[dest].choices == action.choices, dest
        assert port[dest].type == action.type, dest
    assert port["arch"].default == "mobilenet-l"
    assert port["device"].default == "cuda"


def _main(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def summaries():
    """Each launcher's summary by (package, algo), filled as tests ask."""
    return {}


def _summary(summaries, package, algo):
    """``main``'s summary of ``algo`` on ``ARGS``: the port's on the CPU
    (``package`` "port") or the reference's."""
    if (package, algo) not in summaries:
        argv = ARGS + ["--algo", algo]
        summaries[package, algo] = (
            _main(t_train, argv + ["--device", "cpu"]) if package == "port"
            else _main(j_train, argv))
    return summaries[package, algo]


def _shared_summary(tmp_path_factory, algo) -> dict:
    """A baseline's summary as the reference's ``main`` prints it, from
    the reference's run of the same arguments that
    ``tests/test_torch_baselines_experiments.py`` holds the port to."""
    ref = P.lm_reference(tmp_path_factory)
    return {"arch": "qwen3-1.7b", "algo": algo,
            "final": ref["histories"][algo]["rounds"][-1],
            "comm_bytes": ref["summary"][algo]["comm_bytes"],
            "sim_time_s": ref["summary"][algo]["sim_time_s"]}


@pytest.mark.parametrize("algo", t_train.ALGOS)
def test_launcher_accounting_matches_reference(summaries, tmp_path_factory,
                                               algo):
    t_sum = _summary(summaries, "port", algo)
    j_sum = (_summary(summaries, "reference", algo)
             if algo.startswith("ampere")
             else _shared_summary(tmp_path_factory, algo))
    assert t_sum["algo"] == j_sum["algo"] == algo
    assert t_sum["comm_bytes"] == j_sum["comm_bytes"] > 0
    assert t_sum["sim_time_s"] == j_sum["sim_time_s"] > 0
    assert set(t_sum["final"]) == set(j_sum["final"])
    assert math.isfinite(t_sum["final"]["val_loss"])


def test_reference_main_prints_the_shared_run(summaries, tmp_path_factory):
    """``ARGS`` are the shared spec's: the reference's own ``main`` prints
    that run's summary (its final merged evaluation within 1e-5 relative:
    the shared run's model init is compiled, ``main``'s eager), so the
    baselines above are held to it."""
    got = dict(_summary(summaries, "reference", "splitfed"))
    want = _shared_summary(tmp_path_factory, "splitfed")
    got_final, want_final = got.pop("final"), want.pop("final")
    assert got == want
    assert set(got_final) == set(want_final)
    for k, v in want_final.items():
        np.testing.assert_allclose(got_final[k], v, rtol=1e-5, err_msg=k)


def test_noconsolidation_equals_ampere(summaries):
    for package in ("port", "reference"):
        ablation = dict(_summary(summaries, package,
                                 "ampere-noconsolidation"))
        assert ablation.pop("algo") == "ampere-noconsolidation"
        ampere = dict(_summary(summaries, package, "ampere"))
        ampere.pop("algo")
        assert ablation == ampere


@pytest.mark.parametrize("quantize", [False, True])
def test_over_budget_fallback_matches_resident_and_reference(
        quantize, tmp_path, monkeypatch):
    j_spec, t_spec = P.specs("qwen3-1.7b", tmp_path, fed=FED, data=DATA,
                             rounds=2, epochs=2, quantize=quantize)
    j_spec, t_spec = (dataclasses.replace(s, run=dataclasses.replace(
        s.run, device_pool_budget_mb=0)) for s in (j_spec, t_spec))
    j_out, init, _ = P.reference_run(j_spec)
    t_out = P.port_run(t_spec, init, monkeypatch)
    resident = P.port_run(dataclasses.replace(t_spec, run=dataclasses.replace(
        t_spec.run, device_pool_budget_mb=1024)), init, monkeypatch)
    t_hist = t_out["results"]["ampere"]["history"]
    assert t_hist == resident["results"]["ampere"]["history"]
    P.check_histories(t_hist, j_out["results"]["ampere"]["history"], 2, 2,
                      rtol=1e-5)


def test_prefetcher_keeps_order_and_raises_the_producers_error():
    """The server fallback's ``DevicePrefetcher``, as the reference's in
    ``tests/test_server_epoch.py``: batches in producer order, as
    tensors, and a producer's error raised to the consumer."""
    items = [{"x": np.full(3, i, np.float32)} for i in range(5)]
    got = list(DevicePrefetcher(iter(items), "cpu"))
    assert [int(b["x"][0]) for b in got] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in got)

    def failing():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("producer failed")

    it = iter(DevicePrefetcher(failing(), "cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
