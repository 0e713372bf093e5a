"""The streaming layer, as ``repro.streaming``: device actors append
activation shards to a ring of CRC'd segments with watermark
backpressure (:mod:`~repro_torch.streaming.ring`); the server learner
drains them through a ring-backed
:class:`~repro_torch.streaming.store.StreamingActivationStore`, and its
epochs overlap the device round in the accounted ``sim_time``
(:mod:`~repro_torch.streaming.overlap`).  :class:`VersionRing` is
FedBuff's buffered-aggregation boundary on the same ring idiom."""

from repro_torch.streaming.overlap import (InterleaveSchedule,
                                           OverlapAccountant)
from repro_torch.streaming.ring import (ActivationRing, RingClosed,
                                        SegmentPrefetcher, TornSegment,
                                        decode_shard, encode_shard)
from repro_torch.streaming.store import StreamingActivationStore
from repro_torch.streaming.versions import VersionRing

__all__ = [
    "ActivationRing", "InterleaveSchedule", "OverlapAccountant",
    "RingClosed", "SegmentPrefetcher", "StreamingActivationStore",
    "TornSegment", "VersionRing", "decode_shard", "encode_shard",
]
