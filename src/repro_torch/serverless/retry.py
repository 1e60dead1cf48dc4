"""Retry policy for transient store errors (``repro.serverless.retry`` for
the port; dependency-free): the cloud adapter's ``CloudConfig`` carries it,
and the fault layer will retry with it."""
from __future__ import annotations

import zlib
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.  ``delay(attempt,
    token)`` is a pure function of the policy, the attempt number and the
    token (usually the store key), so a retried run charges the same
    backoff every time."""

    max_attempts: int = 5
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.25            # +- fraction of the backoff
    seed: int = 0

    def delay(self, attempt: int, token: str = "") -> float:
        d = min(self.base_delay_s * self.multiplier ** max(0, attempt - 1),
                self.max_delay_s)
        if self.jitter:
            h = zlib.crc32(f"{self.seed}:{token}:{attempt}".encode())
            u = 2.0 * (h / 0xFFFFFFFF) - 1.0          # [-1, 1], deterministic
            d *= 1.0 + self.jitter * u
        return d
