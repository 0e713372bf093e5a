"""The streaming layer, as ``repro.streaming``: for now only the
:class:`~repro_torch.streaming.versions.VersionRing` of FedBuff's
buffered aggregation (the CRC ring, the streaming store and the overlap
accountant are ROADMAP.md queue A6b)."""

from repro_torch.streaming.versions import VersionRing

__all__ = ["VersionRing"]
