"""Bounded retry with exponential backoff and full jitter, as
``repro.transport.retry``.

One policy serves two callers: the simulated path
(:class:`~repro_torch.transport.inprocess.InProcessTransport`) asks only
for :meth:`RetryPolicy.backoff_s` and accounts the delay into simulated
time (the jitter drawn from the
:class:`~repro_torch.transport.faults.FaultPlan`, so runs replay exactly;
nothing sleeps), and host-side work that can fail
(:func:`repro_torch.runtime.fault_tolerance.with_retries`) uses
:meth:`RetryPolicy.call`, which sleeps between attempts.
"""

from __future__ import annotations

import dataclasses
import random
import time


class RetryExhaustedError(Exception):
    """All attempts failed; ``__cause__`` is the last underlying error."""

    def __init__(self, msg, attempts):
        super().__init__(msg)
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4
    base_backoff_s: float = 0.1
    max_backoff_s: float = 5.0
    attempt_timeout_s: float = 30.0

    def validate(self) -> list:
        problems = []
        if self.max_attempts < 1:
            problems.append(
                f"transport.max_attempts={self.max_attempts} < 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            problems.append("transport backoff seconds must be >= 0")
        if self.attempt_timeout_s <= 0:
            problems.append(
                f"transport.attempt_timeout_s={self.attempt_timeout_s} <= 0")
        return problems

    def backoff_s(self, attempt: int, jitter_unit: float) -> float:
        """Full-jitter backoff before retry ``attempt`` (1-based): a draw
        over [0, min(max, base * 2^(attempt-1))], ``jitter_unit`` in
        [0, 1) supplying the randomness."""
        cap = min(self.max_backoff_s,
                  self.base_backoff_s * (2.0 ** max(attempt - 1, 0)))
        return cap * jitter_unit

    def call(self, fn, *args, retryable=(OSError, IOError), rng=None,
             **kwargs):
        """Run ``fn`` with real sleeps between attempts; never sleeps after
        the final failed attempt, and raises :class:`RetryExhaustedError`
        chained from the last error."""
        rng = rng or random
        last = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except retryable as err:
                last = err
                if attempt < self.max_attempts:
                    time.sleep(self.backoff_s(attempt, rng.random()))
        raise RetryExhaustedError(
            f"{getattr(fn, '__name__', fn)} failed after "
            f"{self.max_attempts} attempts: {last}", self.max_attempts,
        ) from last
