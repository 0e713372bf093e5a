"""Real TCP transport, as ``repro.transport.socket_transport``: the same
frames, an actual wire.

Stop-and-wait protocol: the sender writes one frame and blocks for an
``ack`` frame before sending the next.  The receiver acks with a status:

* ``ok``      — CRC verified, first delivery, consumed;
* ``dup``     — CRC verified but ``msg_id`` already consumed (the
  idempotency key absorbed a duplicate) — success for the sender;
* ``corrupt`` — the frame failed CRC / arrived torn; the sender retries
  under its :class:`~repro_torch.transport.retry.RetryPolicy`.

Fault injection happens on the *sender* side (flip a bit before the
bytes hit the socket, send the frame twice, or skip the send so the
receiver's deadline fires), so the receiver exercises its genuine
detection paths.  ``sent_bytes`` counts every byte written including
retries and duplicates: the bytes actually moved, which the two roles
(:mod:`repro_torch.transport.roles`) report beside the analytic ones.
Standard library only.
"""

from __future__ import annotations

import json
import socket
from typing import Optional

from repro_torch.transport.faults import FaultPlan
from repro_torch.transport.framing import (CorruptFrame, Frame,
                                           TruncatedFrame, encode_frame,
                                           flip_bit, read_frame)
from repro_torch.transport.retry import RetryExhaustedError, RetryPolicy


class CountingSocket:
    """Socket wrapper that tallies bytes in each direction."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self.bytes_in = 0
        self.bytes_out = 0

    def recv(self, n: int) -> bytes:
        chunk = self._sock.recv(n)
        self.bytes_in += len(chunk)
        return chunk

    def sendall(self, data: bytes) -> None:
        self._sock.sendall(data)
        self.bytes_out += len(data)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        self._sock.close()


def make_ack(msg_id: str, status: str) -> Frame:
    return Frame(kind="ack", msg_id=msg_id, meta={"status": status})


class SocketTransport:
    """Sender half of the stop-and-wait protocol over one TCP connection."""

    kind = "socket"

    def __init__(self, sock, retry: Optional[RetryPolicy] = None,
                 fault_plan: Optional[FaultPlan] = None, sender: int = -1):
        self.sock = sock if isinstance(sock, CountingSocket) \
            else CountingSocket(sock)
        self.retry = retry or RetryPolicy()
        self.fault_plan = fault_plan
        self.sender = sender
        self.stats = {"sends": 0, "delivered": 0, "retries": 0,
                      "corruptions": 0, "drops": 0, "duplicates": 0,
                      "failures": 0}

    @property
    def sent_bytes(self) -> int:
        return self.sock.bytes_out

    def send(self, frame: Frame) -> str:
        """Send one frame reliably; returns the final ack status
        (``ok`` or ``dup``).  Raises :class:`RetryExhaustedError` when
        every attempt fails."""
        self.stats["sends"] += 1
        encoded = encode_frame(frame)
        last: Optional[Exception] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            if attempt > 1:
                self.stats["retries"] += 1
            dev = frame.sender if frame.sender >= 0 else self.sender
            d = (self.fault_plan.decide(frame.msg_id, attempt, dev)
                 if self.fault_plan is not None else None)
            wire = encoded
            if d is not None and d.corrupt:
                wire = flip_bit(encoded, d.bit_index)
                self.stats["corruptions"] += 1
            try:
                self.sock.settimeout(self.retry.attempt_timeout_s)
                if d is not None and d.drop:
                    # the frame "vanishes": nothing is written, the ack
                    # deadline below fires and we retry
                    self.stats["drops"] += 1
                else:
                    self.sock.sendall(wire)
                    if d is not None and d.duplicate:
                        self.sock.sendall(wire)
                        self.stats["duplicates"] += 1
                ack = read_frame(self.sock)
                # a duplicated delivery makes the receiver emit an extra
                # ``dup`` ack nobody is waiting for; it must not be
                # credited to the *next* frame (which may itself have
                # been dropped or corrupted in flight).  Stale acks carry
                # an older msg_id — drain them.  Blank-id ``corrupt``
                # nacks pass through: they answer the in-flight frame.
                while ack.kind == "ack" and ack.msg_id and \
                        ack.msg_id != frame.msg_id:
                    ack = read_frame(self.sock)
            except (socket.timeout, TimeoutError, TruncatedFrame,
                    CorruptFrame, OSError) as err:
                last = err
                continue
            status = (ack.meta or {}).get("status", "")
            if ack.kind == "ack" and status in ("ok", "dup"):
                self.stats["delivered"] += 1
                return status
            last = CorruptFrame(
                f"receiver rejected {frame.msg_id!r}: {status or ack.kind}")
        self.stats["failures"] += 1
        raise RetryExhaustedError(
            f"send of {frame.msg_id!r} failed after "
            f"{self.retry.max_attempts} attempts: {last}",
            self.retry.max_attempts) from last


class FrameReceiver:
    """Receiver half: read frames, verify, dedupe, ack.

    Iterate with :meth:`recv`: it loops internally until a verified,
    first-delivery frame arrives (corrupt frames are nacked, duplicates
    are acked ``dup`` and absorbed) and returns it.  ``bytes_in`` on the
    wrapped socket measures bytes actually received, retries included.
    """

    def __init__(self, sock, timeout_s: float = 600.0):
        self.sock = sock if isinstance(sock, CountingSocket) \
            else CountingSocket(sock)
        self.sock.settimeout(timeout_s)
        self._seen: set = set()
        self.stats = {"frames": 0, "corrupt": 0, "dup": 0}

    @property
    def received_bytes(self) -> int:
        return self.sock.bytes_in

    def recv(self) -> Frame:
        while True:
            try:
                frame = read_frame(self.sock)
            except CorruptFrame:
                self.stats["corrupt"] += 1
                # we cannot trust the msg_id of a corrupt frame; a blank
                # id still unblocks the stop-and-wait sender
                self.sock.sendall(encode_frame(make_ack("", "corrupt")))
                continue
            self.stats["frames"] += 1
            if frame.msg_id in self._seen:
                self.stats["dup"] += 1
                self.sock.sendall(encode_frame(make_ack(frame.msg_id, "dup")))
                continue
            self._seen.add(frame.msg_id)
            self.sock.sendall(encode_frame(make_ack(frame.msg_id, "ok")))
            return frame


def connect(host: str, port: int, retry: Optional[RetryPolicy] = None,
            timeout_s: float = 30.0) -> CountingSocket:
    """Dial the server role, retrying while it starts up."""
    retry = retry or RetryPolicy(max_attempts=20, base_backoff_s=0.25,
                                 max_backoff_s=2.0, attempt_timeout_s=timeout_s)

    def _dial():
        return socket.create_connection((host, port), timeout=timeout_s)

    return CountingSocket(retry.call(_dial, retryable=(OSError,)))


def listen_one(host: str, port: int, timeout_s: float = 120.0):
    """Accept exactly one connection; returns (counting_sock, bound_port)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    bound = srv.getsockname()[1]
    srv.listen(1)
    srv.settimeout(timeout_s)
    try:
        conn, _ = srv.accept()
    finally:
        srv.close()
    return CountingSocket(conn), bound


def json_payload(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()
