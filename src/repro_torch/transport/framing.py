"""Checksummed message framing, as ``repro.transport.framing``.

One frame carries one logical message.  Layout::

    magic(4) | version(1) | meta_len(4, BE) | payload_len(8, BE)
    | meta (UTF-8 JSON: msg_id, kind, sender, seq, ...)
    | payload bytes
    | crc32(4, BE)   — over EVERYTHING before it (magic through payload)

The trailing CRC covers header and payload, so a bit flip anywhere in the
frame (lengths, metadata or data) is detected at decode instead of
silently consumed.  ``msg_id`` is the idempotency key: receivers
deduplicate on it, so a duplicated delivery can never consolidate an
activation batch twice.  :func:`crc32` is the one CRC of the port: the
journal, the checkpoints, the span log and the fleet trace use it too.

Nothing here touches a device; :mod:`repro_torch.transport.inprocess`
runs injected corruptions through the codec.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Optional

MAGIC = b"AMPF"
VERSION = 1
_HEAD = struct.Struct(">4sBIQ")     # magic, version, meta_len, payload_len
_CRC = struct.Struct(">I")
# sanity bounds: a corrupted length field must not turn into a huge read
MAX_META = 1 << 20
MAX_PAYLOAD = 1 << 40


class FrameError(Exception):
    """Base class for framing failures."""


class CorruptFrame(FrameError):
    """CRC mismatch / bad magic — the bytes arrived but cannot be trusted."""


class TruncatedFrame(FrameError):
    """Fewer bytes than the header promises — a torn / reset transfer."""


@dataclasses.dataclass(frozen=True)
class Frame:
    """One decoded message."""

    kind: str                 # "data" | "state" | "shard" | "ack" | ...
    msg_id: str               # idempotency key (dedup on the receiver)
    payload: bytes = b""
    sender: int = -1          # device id (-1 = coordinator / unknown)
    seq: int = 0
    meta: Optional[dict] = None   # free-form extra metadata


def crc32(data: bytes, value: int = 0) -> int:
    """CRC-32 of ``data`` as an unsigned int."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def frame_overhead(frame: Frame) -> int:
    """Frame bytes beyond the payload (header + metadata + CRC)."""
    return len(encode_frame(frame)) - len(frame.payload)


def encode_frame(frame: Frame) -> bytes:
    meta = {"msg_id": frame.msg_id, "kind": frame.kind,
            "sender": frame.sender, "seq": frame.seq}
    if frame.meta:
        meta["meta"] = frame.meta
    mb = json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()
    head = _HEAD.pack(MAGIC, VERSION, len(mb), len(frame.payload))
    body = head + mb + frame.payload
    return body + _CRC.pack(crc32(body))


def decode_frame(buf: bytes, offset: int = 0) -> tuple:
    """Decode one frame from ``buf[offset:]``; returns ``(Frame, end)``.

    Raises :class:`TruncatedFrame` when the buffer ends before the frame
    does (torn write / reset mid-transfer) and :class:`CorruptFrame` on a
    bad magic, an implausible length, or a CRC mismatch.
    """
    if len(buf) - offset < _HEAD.size:
        raise TruncatedFrame(
            f"{len(buf) - offset} bytes < {_HEAD.size}-byte header")
    magic, version, meta_len, payload_len = _HEAD.unpack_from(buf, offset)
    if magic != MAGIC:
        raise CorruptFrame(f"bad magic {magic!r}")
    if version != VERSION:
        raise CorruptFrame(f"unknown frame version {version}")
    if meta_len > MAX_META or payload_len > MAX_PAYLOAD:
        raise CorruptFrame(
            f"implausible lengths meta={meta_len} payload={payload_len} "
            "(length field corrupted?)")
    end = offset + _HEAD.size + meta_len + payload_len + _CRC.size
    if len(buf) < end:
        raise TruncatedFrame(f"frame needs {end - offset} bytes, "
                             f"have {len(buf) - offset}")
    body_end = end - _CRC.size
    (declared,) = _CRC.unpack_from(buf, body_end)
    actual = crc32(bytes(buf[offset:body_end]))
    if declared != actual:
        raise CorruptFrame(
            f"checksum mismatch: frame says {declared:#010x}, "
            f"payload hashes to {actual:#010x}")
    mstart = offset + _HEAD.size
    try:
        meta = json.loads(bytes(buf[mstart:mstart + meta_len]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        # CRC passed but the metadata does not parse — possible only for
        # a frame that was *encoded* wrong, not corrupted in flight
        raise CorruptFrame(f"undecodable frame metadata: {err}") from err
    payload = bytes(buf[mstart + meta_len:body_end])
    return Frame(kind=meta.get("kind", "data"),
                 msg_id=meta.get("msg_id", ""),
                 payload=payload,
                 sender=int(meta.get("sender", -1)),
                 seq=int(meta.get("seq", 0)),
                 meta=meta.get("meta")), end


def read_frame(sock) -> Frame:
    """Read exactly one frame from a socket-like object (``recv``).

    Raises :class:`TruncatedFrame` if the peer closes mid-frame and
    :class:`CorruptFrame` on checksum failure.
    """
    head = _read_exact(sock, _HEAD.size)
    magic, version, meta_len, payload_len = _HEAD.unpack(head)
    if magic != MAGIC:
        raise CorruptFrame(f"bad magic {magic!r}")
    if meta_len > MAX_META or payload_len > MAX_PAYLOAD:
        raise CorruptFrame(
            f"implausible lengths meta={meta_len} payload={payload_len}")
    rest = _read_exact(sock, meta_len + payload_len + _CRC.size)
    frame, _ = decode_frame(head + rest)
    return frame


def _read_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise TruncatedFrame(f"peer closed after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def flip_bit(data: bytes, bit_index: int) -> bytes:
    """Return ``data`` with one bit flipped — the corruption injector."""
    i = (bit_index // 8) % max(len(data), 1)
    b = bytearray(data)
    b[i] ^= 1 << (bit_index % 8)
    return bytes(b)
