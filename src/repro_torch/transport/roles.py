"""Two-process Ampere, as ``repro.transport.roles``: the device and the
server blocks as two processes joined by one TCP connection.

``python -m repro_torch.launch.run_experiment SPEC --role device`` runs
the federated device phase, then ships the converged device state and
the one-shot activation shards to ``--role server`` over the
checksummed stop-and-wait protocol of
:mod:`~repro_torch.transport.socket_transport`.  The server stores the
shards in an :class:`~repro_torch.data.activation_store.ActivationStore`,
trains the server phase, writes ``summary.json`` and answers with a
``result`` frame carrying that summary.

Both roles resolve the same setup from the same spec
(:func:`repro_torch.experiments.api.resolve_setup`: model, data, the
Dirichlet partition) and seed their init from ``run.seed`` as
``run_experiment`` does, so only what must cross the device/server
boundary goes over the wire: the state frame (the device state,
``runtime.checkpoint._flatten`` through ``np.savez``, with the
reference's keys), one frame per shard (``acts/{client}/{i}``: fp32
activations of batches of 64 and their labels, through ``np.savez``) and
a ``done`` frame with the device history.  The frames are the
reference's, byte for byte, for the same arrays.  ``setup=`` hands a role
an already-resolved ``(spec, model, clients, eval_data)`` instead (a
corpus ``resolve_setup`` cannot make); both roles must get the same one.

Wire accounting: the server reports ``measured_wire_bytes`` (every byte
it received: framing, the state, retries and duplicates included) beside
``analytic_transfer_bytes`` (the stored bytes the comm model prices for
the upload).  Faults (``spec.faults``) are injected on the device's side
of the socket, so the server runs its real CRC and dedup paths.

Each role runs on the card unless ``device="cpu"``.  torch and numpy are
imported inside the roles, so :mod:`repro_torch.transport` stays
standard library only.
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional

from repro_torch.transport.framing import Frame, encode_frame, read_frame
from repro_torch.transport.socket_transport import (FrameReceiver,
                                                    SocketTransport, connect,
                                                    listen_one)

ACT_BATCH_SIZE = 64          # AmpereTrainer.generate_activations' batch
ROLE_TIMEOUT_S = 600.0       # accept, receive and wait-for-result deadline


def _npz_bytes(arrays: dict) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(payload: bytes) -> dict:
    import numpy as np

    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def _json_safe(obj):
    """History records may hold numpy scalars; frame metadata is JSON."""
    import numpy as np

    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _validated(spec):
    problems = spec.validate()
    if problems:
        raise ValueError("invalid ExperimentSpec:\n  - "
                         + "\n  - ".join(problems))
    from repro_torch.experiments.spec import TransportSpec

    return spec, (spec.transport or TransportSpec())


def _trainer(spec, setup, echo, device):
    """The role's (spec, trainer) on the resolved setup, and the
    generator ``run_experiment`` seeds the init from."""
    import torch

    from repro_torch.core.uit import AmpereTrainer
    from repro_torch.experiments.api import resolve_setup

    spec, model, clients, eval_data = (setup if setup is not None
                                       else resolve_setup(spec))
    tr = AmpereTrainer(model, spec.run, clients, eval_data,
                       patience=spec.patience, log_echo=echo, device=device)
    return spec, tr, torch.Generator().manual_seed(spec.run.seed)


def _shards_of(model, clients, dev_state, split_point, device,
               batch_size: int = ACT_BATCH_SIZE):
    """Yield ``(client_id, shard_idx, shard)`` as
    :meth:`AmpereTrainer.generate_activations` makes them: the device
    forward of batches of ``batch_size`` on ``device``, fp32 on the host,
    with their labels."""
    import torch

    from repro_torch.core import splitting

    for client in clients:
        arrays = client.dataset.arrays
        for i, s in enumerate(range(0, len(client.dataset), batch_size)):
            with torch.no_grad():
                acts = splitting.device_forward(
                    model, dev_state["device"],
                    torch.as_tensor(arrays[model.input_key][s:s + batch_size],
                                    device=device), split_point)
            shard = {"acts": acts.float().cpu().numpy(),
                     model.label_key: arrays[model.label_key][
                         s:s + batch_size]}
            del acts
            yield client.client_id, i, shard


def _state_like(tree, template, device):
    """The received numpy tree as tensors on ``device``, each leaf in its
    template leaf's dtype (a bf16 leaf travels as its raw 16-bit
    pattern); a non-tensor template leaf gets a Python scalar."""
    import numpy as np
    import torch

    from repro_torch.interop import tree_map

    def leaf(a, t):
        if not isinstance(t, torch.Tensor):
            return type(t)(np.asarray(a).item())
        a = np.array(a, copy=True)
        if t.dtype == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return tree_map(leaf, tree, template)


# ---------------------------------------------------------------------------
# device role
# ---------------------------------------------------------------------------


def run_device_role(spec, host: Optional[str] = None,
                    port: Optional[int] = None, echo: bool = False, *,
                    device=None, setup=None) -> dict:
    """Run the federated device phase, then upload the state and the
    activations.  Returns the server's result summary with this side's
    wire statistics.  Faults (``spec.faults``) are injected here, before
    the bytes reach the wire."""
    from repro_torch.data.activation_store import ActivationStore
    from repro_torch.runtime import checkpoint
    from repro_torch.transport.faults import FaultPlan

    spec, tspec = _validated(spec)
    spec, tr, gen = _trainer(spec, setup, echo, device)
    dev, srv, aux = tr._init_states(gen)
    del srv     # the server block of the init is the server's
    dev_state = tr.run_device_phase({"device": dev, "aux": aux},
                                    spec.max_rounds)
    del dev, aux
    fault_plan = FaultPlan(spec.faults) if spec.faults is not None else None
    sock = connect(host or tspec.host,
                   tspec.port if port is None else int(port))
    transport = SocketTransport(sock, retry=tspec.retry_policy(),
                                fault_plan=fault_plan)
    flat, _, _ = checkpoint._flatten(dev_state)
    transport.send(Frame(kind="state", msg_id="device_state",
                         payload=_npz_bytes(flat)))
    del flat
    analytic = 0
    quantize = spec.run.split.quantize_activations
    for cid, i, shard in _shards_of(tr.model, tr.clients, dev_state,
                                    spec.run.split.split_point, tr.device):
        analytic += ActivationStore.shard_nbytes(shard, quantize)
        transport.send(Frame(kind="shard", msg_id=f"acts/{cid}/{i}",
                             payload=_npz_bytes(shard), sender=int(cid),
                             meta={"client_id": int(cid)}))
    transport.send(Frame(kind="done", msg_id="done",
                         meta={"history": _json_safe(tr.history),
                               "sent_bytes": transport.sent_bytes,
                               "analytic_bytes": int(analytic)}))
    # nothing of the device side is needed while the server trains
    del dev_state, tr
    sock.settimeout(ROLE_TIMEOUT_S)
    result = read_frame(sock)
    sock.close()
    return {"result": result.meta or {},
            "sent_bytes": transport.sent_bytes,
            "analytic_bytes": int(analytic),
            "stats": dict(transport.stats)}


# ---------------------------------------------------------------------------
# server role
# ---------------------------------------------------------------------------


def run_server_role(spec, host: Optional[str] = None,
                    port: Optional[int] = None, echo: bool = False,
                    results_dir: Optional[str] = None, *, device=None,
                    setup=None) -> dict:
    """Accept one device connection, store its shards, train the server
    phase.  Writes ``summary.json`` under the results directory and
    answers the device with a ``result`` frame carrying the summary."""
    from repro_torch.core import comm_model
    from repro_torch.data.activation_store import ActivationStore
    from repro_torch.experiments.api import _history_summary
    from repro_torch.runtime import checkpoint

    spec, tspec = _validated(spec)
    spec, tr, gen = _trainer(spec, setup, echo, device)
    sock, _bound = listen_one(host or tspec.host,
                              tspec.port if port is None else int(port),
                              timeout_s=ROLE_TIMEOUT_S)
    receiver = FrameReceiver(sock, timeout_s=ROLE_TIMEOUT_S)
    store = ActivationStore(
        quantize_int8=spec.run.split.quantize_activations,
        seed=spec.run.seed)
    received = None
    device_info: dict = {}
    while True:
        frame = receiver.recv()
        if frame.kind == "state":
            received = checkpoint._unflatten(_npz_load(frame.payload))
        elif frame.kind == "shard":
            store.add(int((frame.meta or {})["client_id"]),
                      _npz_load(frame.payload))
        elif frame.kind == "done":
            device_info = frame.meta or {}
            break
        else:
            raise ValueError(f"unexpected frame kind {frame.kind!r}")
    if received is None:
        raise ValueError("device closed without sending its state")

    # the device side's history, so the summary spans both phases
    dev_hist = device_info.get("history") or {}
    tr.history["device"] = list(dev_hist.get("device", []))
    tr.runner.account(
        comm_bytes=int(dev_hist.get("comm_bytes", 0)) + store.bytes_received,
        sim_time=(float(dev_hist.get("sim_time", 0.0))
                  + store.bytes_received / comm_model.BANDWIDTH_BPS))
    dev, srv, aux = tr._init_states(gen)
    dev_state = _state_like(received, {"device": dev, "aux": aux},
                            tr.device)
    del received, dev, aux
    tr.run_server_phase(dev_state, srv, store, spec.max_server_epochs)

    summary = {
        "system": "ampere", "mode": "socket",
        "measured_wire_bytes": receiver.received_bytes,
        "device_sent_bytes": int(device_info.get("sent_bytes", 0)),
        "analytic_transfer_bytes": int(store.bytes_received),
        "device_analytic_bytes": int(device_info.get("analytic_bytes", 0)),
        "frames": dict(receiver.stats),
        **_json_safe(_history_summary(tr.history)),
    }
    rd = results_dir or spec.results_dir or os.path.join("results",
                                                         spec.name)
    os.makedirs(rd, exist_ok=True)
    with open(os.path.join(rd, "summary.json"), "w") as f:
        json.dump({"spec": spec.to_dict(), "summary": summary}, f, indent=1)
    try:
        # the summary is already on disk: a device that died while it
        # waited must not fail the server role
        sock.sendall(encode_frame(Frame(kind="result", msg_id="result",
                                        meta=summary)))
    except OSError:
        pass
    sock.close()
    return {"summary": summary, "results_dir": rd}
