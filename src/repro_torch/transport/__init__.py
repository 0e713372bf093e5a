"""Fault-injecting transport layer (checksummed framing, retry and
backoff, quorum-degraded rounds, a real TCP wire), as
``repro.transport``.  Its modules use the standard library only at
import time (the roles import torch and numpy inside their functions).

* :mod:`~repro_torch.transport.framing` — the frame codec and ``crc32``;
* :mod:`~repro_torch.transport.faults` — ``FaultSpec`` / ``FaultPlan``,
  every decision a pure function of (seed, key, attempt, device);
* :mod:`~repro_torch.transport.retry` — ``RetryPolicy``;
* :mod:`~repro_torch.transport.inprocess` — ``InProcessTransport`` and
  :func:`cohort_exchange`;
* :mod:`~repro_torch.transport.socket_transport` — ``SocketTransport``
  and ``FrameReceiver``, the stop-and-wait protocol over TCP;
* :mod:`~repro_torch.transport.roles` — ``run_device_role`` /
  ``run_server_role``, Ampere as two processes.
"""

from repro_torch.transport.faults import (FaultDecision, FaultPlan,
                                          FaultSpec, stable_hash)
from repro_torch.transport.framing import (CorruptFrame, Frame, FrameError,
                                           TruncatedFrame, crc32,
                                           decode_frame, encode_frame,
                                           flip_bit, frame_overhead,
                                           read_frame)
from repro_torch.transport.inprocess import (InProcessTransport,
                                             QuorumError, TransferResult,
                                             cohort_exchange,
                                             required_quorum)
from repro_torch.transport.retry import RetryExhaustedError, RetryPolicy
from repro_torch.transport.socket_transport import (CountingSocket,
                                                    FrameReceiver,
                                                    SocketTransport, connect,
                                                    listen_one)

__all__ = [
    "CorruptFrame", "CountingSocket", "FaultDecision", "FaultPlan",
    "FaultSpec", "Frame", "FrameError", "FrameReceiver",
    "InProcessTransport", "QuorumError", "RetryExhaustedError",
    "RetryPolicy", "SocketTransport", "TransferResult", "TruncatedFrame",
    "cohort_exchange", "connect", "crc32", "decode_frame", "encode_frame",
    "flip_bit", "frame_overhead", "listen_one", "read_frame",
    "required_quorum", "stable_hash",
]
