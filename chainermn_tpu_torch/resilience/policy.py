"""Deterministic bounded retry — the reusable "try again" half of recovery.

The reference had no retry layer at all: any transient failure (a slow peer
during MPI bootstrap, an NFS hiccup during a snapshot write) escalated
straight to ``MPI_Abort`` and a whole-job restart (SURVEY.md §2.8).  A
whole-job restart costs minutes; a retried socket dial costs milliseconds.
This module provides the policy object the rest of the resilience layer
shares: bounded attempts, exponential backoff, and — deliberately — **no
wall-clock randomness**.  Jittered backoff makes distributed failures
unreproducible; a deterministic schedule means a failing bootstrap replays
identically under ``CMN_FAULT`` injection in CI.

A copy of the JAX package's ``resilience/policy.py``.  Applied to the
checkpointer's save and restore I/O (``extensions/checkpoint.py``).
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple, Type


class RetryExhaustedError(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


class RetryPolicy:
    """Bounded deterministic exponential backoff.

    Attempt ``i`` (0-based) that fails waits ``min(base_delay_s *
    multiplier**i, max_delay_s)`` before attempt ``i+1``; after
    ``max_attempts`` failures the last exception is re-raised wrapped in
    :class:`RetryExhaustedError`.  The schedule is a pure function of the
    constructor arguments — no jitter, no wall-clock reads — so two ranks
    configured identically retry in lockstep.

    ``sleep`` is injectable for tests (defaults to :func:`time.sleep`).
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay_s: float = 0.1,
        multiplier: float = 2.0,
        max_delay_s: float = 5.0,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_delay_s < 0 or max_delay_s < 0 or multiplier <= 0:
            raise ValueError("delays must be >= 0 and multiplier > 0")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.retry_on = tuple(retry_on)
        self._sleep = sleep

    def delays(self) -> List[float]:
        """The full backoff schedule (``max_attempts - 1`` entries)."""
        return [
            min(self.base_delay_s * self.multiplier**i, self.max_delay_s)
            for i in range(self.max_attempts - 1)
        ]

    def call(self, fn: Callable, *args, on_retry: Callable = None, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying per the schedule.

        ``on_retry(attempt, exc)`` (if given) is invoked before each backoff
        sleep — the hook point for the launcher-style health lines.  Errors
        outside ``retry_on`` propagate immediately (a structure mismatch is
        not a transient)."""
        last: BaseException = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
                if attempt == self.max_attempts - 1:
                    break
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(self.delays()[attempt])
        raise RetryExhaustedError(
            f"{getattr(fn, '__name__', fn)!s} failed after "
            f"{self.max_attempts} attempt(s): {last!r}",
            self.max_attempts,
        ) from last

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form of :meth:`call`."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

    def __repr__(self):
        return (
            f"RetryPolicy(max_attempts={self.max_attempts}, "
            f"base_delay_s={self.base_delay_s}, "
            f"multiplier={self.multiplier}, max_delay_s={self.max_delay_s})"
        )
