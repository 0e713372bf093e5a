"""Overlap accounting: server epochs pipelined against the device round,
as ``repro.streaming.overlap``.

The serialized accounting charges the one-shot upload ``t_up + extra``
and then every server epoch its whole analytic ``epoch_sim_time``.  A
streamed run computes exactly the same (the same pool bytes, the same
generator draws, the same epoch) but prices the server phase as a
pipeline against the arrival time the ring recorded for each shard:

* the ``k``-th batch of an epoch is *ready* once ``(k+1) * bs`` samples
  have landed (the learner consumes in arrival order; the epoch's
  permutation only relabels which landed samples fill which batch);
* the learner serves batches back to back at ``per_batch_s``
  (``epoch_sim_time / batches_per_epoch``): ``t = max(t, ready) +
  per_batch_s``;
* epoch ``e`` ends at ``T_e`` and is charged ``dt_e = max(0, T_e -
  C_{e-1})`` past the accounted frontier ``C_e = max(C_{e-1}, T_e)``,
  which starts at ``C_0 = t_up + extra`` (the upload's charge, already
  in the history);
* its *overlap* is ``epoch_sim_time - dt_e``: server seconds hidden
  behind the still-running device round.

The total is ``max(T_E, t_up + extra)``: never more than the serialized
total.  Arrivals are clamped to the upload's accounted end, so a
parallel upload's pricing (the slowest link) cannot push an arrival past
the frontier the history already charged.

:class:`InterleaveSchedule` is the determinism half: under backpressure
the single-process simulator draws how many segments the learner drains
before the producer retries, from a seeded generator, so occupancy and
stall statistics replay exactly.
"""

from __future__ import annotations

import numpy as np


class InterleaveSchedule:
    """Seeded producer/consumer interleaving for the simulator:
    :meth:`next_drain` draws how many segments the learner drains at the
    next backpressure stall, uniform in ``[1, 2 * drain_chunk]``."""

    def __init__(self, seed: int = 0, drain_chunk: int = 4):
        if drain_chunk < 1:
            raise ValueError(f"drain_chunk={drain_chunk} < 1")
        self.drain_chunk = int(drain_chunk)
        self._rng = np.random.default_rng(int(seed))

    def next_drain(self) -> int:
        return int(self._rng.integers(1, 2 * self.drain_chunk + 1))


class OverlapAccountant:
    """Pipelined simulated time of server epochs over streamed arrivals."""

    def __init__(self, sample_arrivals: np.ndarray, device_end: float,
                 per_batch_s: float):
        arr = np.sort(np.asarray(sample_arrivals, np.float64))
        # the upload already charged [0, device_end]; an arrival beyond it
        # would charge that time twice
        self.arrivals = np.minimum(arr, float(device_end)) if arr.size \
            else arr
        self.device_end = float(device_end)
        self.per_batch_s = float(per_batch_s)
        self._t = 0.0                        # learner cursor
        self._frontier = float(device_end)   # accounted frontier

    def epoch(self, idx: np.ndarray):
        """Serve one epoch of batches ``idx`` (nb, bs).  Returns ``(dt,
        overlapped)``: the simulated seconds to charge for the epoch and
        those of it hidden behind the device round (``dt + overlapped ==
        nb * per_batch_s``, up to a few ulp)."""
        idx = np.asarray(idx)
        nb = len(idx)
        bs = idx.shape[1] if idx.ndim == 2 else 1
        n = self.arrivals.size
        for k in range(nb):
            ready = 0.0
            if n:
                # batch k needs (k+1) * bs landed samples, at most all n
                ready = float(self.arrivals[min((k + 1) * bs, n) - 1])
            self._t = max(self._t, ready) + self.per_batch_s
        serialized = nb * self.per_batch_s
        dt = max(0.0, self._t - self._frontier)
        self._frontier = max(self._frontier, self._t)
        # float residue can leave serialized - dt a few ulp below zero
        return dt, max(0.0, serialized - dt)

    @property
    def total_s(self) -> float:
        """The accounted end: ``max(T_E, device_end)``."""
        return self._frontier
