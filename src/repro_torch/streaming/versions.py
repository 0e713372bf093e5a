"""Version ring: the buffered-aggregation boundary as a streaming object,
as ``repro.streaming.versions``.

FedBuff's loop-carried state is a ring of recent global-model versions:
still-in-flight devices trained from stale snapshots, so aggregating a
buffer needs every version any buffered update may reference.
:class:`VersionRing` owns those semantics: an aggregation *appends* a new
version, staleness is *read off* the ring (``current - version``), and
the ring prunes itself to the trace's maximum staleness bound.  Its
checkpoint tree is ``{str(version): state}`` (:meth:`state_dict` /
:meth:`from_state_dict`), the reference's format.
"""

from __future__ import annotations

from typing import Dict, List


class VersionRing:
    """Bounded map of recent global-model versions keyed by version."""

    def __init__(self, initial=None, *, version: int = 0, s_max: int = 0):
        if s_max < 0:
            raise ValueError(f"s_max={s_max} < 0")
        self.s_max = int(s_max)
        self._slots: Dict[int, object] = {}
        if initial is not None:
            self._slots[int(version)] = initial

    @classmethod
    def from_state_dict(cls, tree: dict, *, s_max: int) -> "VersionRing":
        """Rehydrate from the checkpointed ``{str(version): state}``."""
        ring = cls(s_max=s_max)
        for k, v in tree.items():
            ring._slots[int(k)] = v
        return ring

    def state_dict(self) -> dict:
        """The checkpoint tree: str keys, in version order."""
        return {str(v): self._slots[v] for v in sorted(self._slots)}

    def get(self, version: int):
        if int(version) not in self._slots:
            raise KeyError(
                f"version {version} not in ring {self.versions()} — "
                f"staleness exceeds the s_max={self.s_max} prune bound")
        return self._slots[int(version)]

    def snapshots(self, current: int, staleness: List[int]) -> list:
        """The stale states buffered updates trained from: one per
        buffered client, version ``current - s``."""
        return [self.get(int(current) - int(s)) for s in staleness]

    def append(self, version: int, state):
        """Commit a newly aggregated global version and prune every slot
        no in-flight update can still reference (``< version - s_max``)."""
        version = int(version)
        self._slots[version] = state
        for v in [v for v in self._slots if v < version - self.s_max]:
            del self._slots[v]

    def versions(self) -> List[int]:
        return sorted(self._slots)

    def latest_version(self) -> int:
        return max(self._slots)

    def latest(self):
        return self._slots[self.latest_version()]

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, version) -> bool:
        return int(version) in self._slots
