"""Fault-injecting transport layer (checksummed framing, retry and
backoff, quorum-degraded rounds), as ``repro.transport`` less its socket
mode.  Its modules use the standard library only (no torch, no numpy).

* :mod:`~repro_torch.transport.framing` — the frame codec and ``crc32``;
* :mod:`~repro_torch.transport.faults` — ``FaultSpec`` / ``FaultPlan``,
  every decision a pure function of (seed, key, attempt, device);
* :mod:`~repro_torch.transport.retry` — ``RetryPolicy``;
* :mod:`~repro_torch.transport.inprocess` — ``InProcessTransport`` and
  :func:`cohort_exchange`.

The socket transport and its two-process roles are queue A6b of
ROADMAP.md.
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

__all__ = [
    "CorruptFrame", "FaultDecision", "FaultPlan", "FaultSpec", "Frame",
    "FrameError", "InProcessTransport", "QuorumError", "RetryExhaustedError",
    "RetryPolicy", "TransferResult", "TruncatedFrame", "cohort_exchange",
    "crc32", "decode_frame", "encode_frame", "flip_bit", "frame_overhead",
    "read_frame", "required_quorum", "stable_hash",
]
