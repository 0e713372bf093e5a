"""The port's socket transport and its two-process Ampere roles, on the
CPU, held to the reference:

* ``SocketTransport`` / ``FrameReceiver`` over a socket pair under
  corruptions and duplicates: every message delivered once, in order,
  with the reference's sender and receiver statistics ``==``; a
  reference sender to a port receiver, and the reverse, decode the same
  frames.
* The two roles on a qwen3 smoke spec, in two threads, from the
  reference's init: the same frames on the wire as the reference's roles
  (every frame's length ``==`` but the ``done`` frame's, whose JSON
  history carries each package's own float digits), the same analytic
  bytes, frame statistics and accounting, losses within the parity gate;
  and the port's roles ``==`` its in-process run (as the reference's
  roles equal its own).
* ``python -m repro_torch.launch.run_experiment --role server --device
  cpu`` as a real subprocess against the device role: the measured wire
  bytes within 10% of the analytic upload (the reference's rule).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_experiment_parity as P
from repro.core.uit import AmpereTrainer as JTrainer
from repro.experiments.spec import TransportSpec as JTransportSpec
from repro.transport import FaultPlan as JFaultPlan
from repro.transport import FaultSpec as JFaultSpec
from repro.transport import FrameReceiver as JReceiver
from repro.transport import RetryPolicy as JRetry
from repro.transport import SocketTransport as JSocketTransport
from repro.transport import roles as j_roles
from repro_torch.configs.base import FedConfig, OptimConfig, RunConfig
from repro_torch.experiments import DataSpec, ExperimentSpec, TransportSpec
from repro_torch.transport import (FaultPlan, FaultSpec, Frame,
                                   FrameReceiver, RetryPolicy,
                                   SocketTransport, encode_frame, roles)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
JOIN_S = 300.0          # a role thread's deadline (the roles wait 600 s)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _in_thread(fn, *args, **kw):
    """Start ``fn`` in a daemon thread; returns ``(thread, out)``, ``out``
    getting ``"result"`` or ``"error"``."""
    out = {}

    def run():
        try:
            out["result"] = fn(*args, **kw)
        except BaseException as err:      # raised again by _joined
            out["error"] = err

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, out


def _joined(th, out):
    th.join(timeout=JOIN_S)
    assert not th.is_alive(), "role thread still running"
    if "error" in out:
        raise out["error"]
    return out["result"]


# ---------------------------------------------------------------------------
# the stop-and-wait protocol
# ---------------------------------------------------------------------------


# the reference's socket test's faults and retries (in both packages a bit
# flip that lands in a frame's length field stalls the stream until the
# receiver's deadline, so the knobs stay the ones the reference holds)
FAULTS = dict(seed=2, corrupt_prob=0.3, duplicate_prob=0.3)
RETRY = dict(max_attempts=6, base_backoff_s=0.0, attempt_timeout_s=2.0)


def _exchange(sender_cls, receiver_cls, retry, plan, n=20):
    """``n`` frames from a ``sender_cls`` to a ``receiver_cls`` over a
    socket pair; returns (received payloads by id, sender, receiver)."""
    a, b = socket.socketpair()
    sender = sender_cls(a, retry=retry, fault_plan=plan)
    receiver = receiver_cls(b, timeout_s=10.0)
    got = {}

    def serve():
        for _ in range(n):
            f = receiver.recv()
            got[f.msg_id] = (f.kind, f.payload)

    th, out = _in_thread(serve)
    try:
        for i in range(n):
            status = sender.send(Frame(kind="data", msg_id=f"m{i}",
                                       payload=bytes([i]) * 100))
            assert status in ("ok", "dup")
        _joined(th, out)
    finally:
        a.close()
        b.close()
    return got, sender, receiver


def test_socket_stop_and_wait_with_faults_matches_reference():
    """Corruptions and duplicates injected by the sender: the receiver's
    CRC and idempotency key deliver every message exactly once, and both
    sides' statistics are the reference's."""
    got, sender, receiver = _exchange(
        SocketTransport, FrameReceiver, RetryPolicy(**RETRY),
        FaultPlan(FaultSpec(**FAULTS)))
    j_got, j_sender, j_receiver = _exchange(
        JSocketTransport, JReceiver, JRetry(**RETRY),
        JFaultPlan(JFaultSpec(**FAULTS)))
    want = {f"m{i}": ("data", bytes([i]) * 100) for i in range(20)}
    assert got == j_got == want
    assert sender.stats == j_sender.stats
    assert receiver.stats == j_receiver.stats
    assert sender.stats["corruptions"] + sender.stats["duplicates"] > 0
    assert receiver.stats["corrupt"] == sender.stats["corruptions"]
    assert sender.stats["failures"] == 0
    assert sender.sent_bytes == j_sender.sent_bytes
    assert receiver.received_bytes == j_receiver.received_bytes


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_socket_interoperates_with_reference(direction):
    """A sender of one package and a receiver of the other: the same
    frames decoded, the same bytes counted on both ends."""
    if direction == "reference_to_port":
        pair = (JSocketTransport, FrameReceiver, JRetry(**RETRY),
                JFaultPlan(JFaultSpec(**FAULTS)))
    else:
        pair = (SocketTransport, JReceiver, RetryPolicy(**RETRY),
                FaultPlan(FaultSpec(**FAULTS)))
    got, sender, receiver = _exchange(*pair)
    assert got == {f"m{i}": ("data", bytes([i]) * 100) for i in range(20)}
    assert sender.stats["failures"] == 0
    assert receiver.stats["corrupt"] == sender.stats["corruptions"] > 0


# ---------------------------------------------------------------------------
# the two roles
# ---------------------------------------------------------------------------


def _recorded_frames(monkeypatch, receiver_cls, log):
    """Record every frame a ``receiver_cls`` hands out, by (kind, id) and
    encoded length."""
    recv = receiver_cls.recv

    def recording(self):
        frame = recv(self)
        log.append((frame.kind, frame.msg_id, len(encode_frame(frame))))
        return frame

    monkeypatch.setattr(receiver_cls, "recv", recording)


def _roles(module, spec, results_dir, **kw):
    """The server role in one thread, the device role in another, over
    loopback; returns (server summary, device result)."""
    port = _free_port()
    srv = _in_thread(module.run_server_role, spec, port=port,
                     results_dir=str(results_dir), **kw)
    dev = _in_thread(module.run_device_role, spec, port=port, **kw)
    return _joined(*srv)["summary"], _joined(*dev)


def test_roles_match_reference_and_in_process_run(tmp_path, monkeypatch):
    j_spec, t_spec = P.specs("qwen3-1.7b", tmp_path / "in", fed=P.LM_FED,
                             data=P.LM_DATA, rounds=2, epochs=2)
    j_out, init, _ = P.reference_run(j_spec)
    t_out = P.port_run(t_spec, init, monkeypatch)     # patches the init
    monkeypatch.setattr(JTrainer, "_init_states", lambda self, key: (
        lambda st: (st["device"], st["server"], st["aux"]))(
            jax.tree.map(jnp.array, init)))
    frames = {"t": [], "j": []}
    _recorded_frames(monkeypatch, FrameReceiver, frames["t"])
    _recorded_frames(monkeypatch, JReceiver, frames["j"])
    j_sum, j_dev = _roles(j_roles, dataclasses.replace(
        j_spec, transport=JTransportSpec(kind="socket")), tmp_path / "j")
    t_sock = dataclasses.replace(t_spec, transport=TransportSpec(
        kind="socket"))
    assert t_sock.validate() == []
    t_sum, t_dev = _roles(roles, t_sock, tmp_path / "t", device="cpu")

    # the wire: the state frame, one frame per shard, the done frame
    kinds = [k for k, _, _ in frames["t"]]
    assert kinds == ["state"] + ["shard"] * (len(kinds) - 2) + ["done"]
    assert frames["t"][:-1] == frames["j"][:-1]
    done_t, done_j = frames["t"][-1][2], frames["j"][-1][2]
    for s, f in ((t_sum, frames["t"]), (j_sum, frames["j"])):
        assert s["measured_wire_bytes"] == sum(n for _, _, n in f)
        assert s["device_sent_bytes"] == s["measured_wire_bytes"] - f[-1][2]
    assert t_sum["measured_wire_bytes"] - j_sum["measured_wire_bytes"] == \
        done_t - done_j
    for k in ("device_sent_bytes", "analytic_transfer_bytes",
              "device_analytic_bytes", "frames", "comm_bytes",
              "sim_time_s", "num_device", "num_server", "system", "mode"):
        assert t_sum[k] == j_sum[k], k
    assert t_sum["analytic_transfer_bytes"] == \
        t_out["results"]["ampere"]["store"].bytes_received
    assert t_dev["analytic_bytes"] == j_dev["analytic_bytes"]
    assert t_dev["stats"] == j_dev["stats"]
    assert t_dev["result"] == t_sum
    np.testing.assert_allclose(t_sum["final_val_loss"],
                               j_sum["final_val_loss"], rtol=RTOL)
    np.testing.assert_allclose(t_sum["final_val_acc"],
                               j_sum["final_val_acc"], atol=1e-2)
    on_disk = json.loads((tmp_path / "t" / "summary.json").read_text())
    assert on_disk["summary"] == t_sum

    # each package's roles equal its own in-process run
    for roles_sum, out in ((j_sum, j_out), (t_sum, t_out)):
        in_process = out["summary"]["ampere"]
        assert {k: roles_sum[k] for k in in_process} == in_process


def test_server_role_subprocess_wire_within_ten_percent(tmp_path):
    """The server role as a real process (``--role server --device
    cpu``), the device role here: on a fault-free run the wire bytes the
    server measured (framing, the state and every shard) are within 10%
    of the analytic upload, as the reference's two-process test holds."""
    spec = ExperimentSpec(
        name="socket_e2e", systems=("ampere",), arch="vit-s",
        run=RunConfig(arch="vit-s", fed=FedConfig(
            num_clients=6, clients_per_round=3, local_steps=2,
            device_batch_size=4, server_batch_size=8, dirichlet_alpha=0.5),
            optim=OptimConfig(name="momentum", lr=0.1,
                              schedule="inverse_time", decay_gamma=0.01)),
        data=DataSpec(train_samples=432, eval_samples=48), max_rounds=2,
        max_server_epochs=1, patience=50,
        transport=TransportSpec(kind="socket"))
    path = tmp_path / "spec.json"
    spec.save(str(path))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.run_experiment",
         str(path), "--role", "server", "--device", "cpu", "--port",
         str(port), "--results-dir", str(tmp_path / "out")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        dev = _joined(*_in_thread(roles.run_device_role, spec, port=port,
                                  device="cpu"))
        stdout, stderr = proc.communicate(timeout=JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())[
        "summary"]
    assert json.loads(stdout[stdout.index("{"):]) == summary
    measured = summary["measured_wire_bytes"]
    analytic = summary["analytic_transfer_bytes"]
    assert analytic > 0 and summary["device_analytic_bytes"] == analytic
    assert abs(measured - analytic) / analytic < 0.10
    assert summary["final_val_loss"] is not None
    assert dev["result"]["measured_wire_bytes"] == measured
    assert dev["stats"]["failures"] == 0
    assert dev["sent_bytes"] >= measured       # acks flow the other way
