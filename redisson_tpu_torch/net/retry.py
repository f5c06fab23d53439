"""Shared retry discipline: bounded exponential backoff + jitter + deadline.

The ad-hoc `retry_attempts=1` admin connections (migration coordinator,
replica wiring) used to sit OUTSIDE the retry/detector machinery data
traffic rides: one refused connect aborted a whole slot migration even
though the node was back 50ms later.  ``RetryPolicy`` is the one knob
object both planes share — ``NodeClient`` consumes it natively, so control
traffic (SETSLOT/MIGRATESLOTS/SETVIEW) now feeds the same
``net/detectors.py`` failure detectors and pool-discard paths as data
traffic, just with its own schedule.

Semantics:

  * ``max_attempts`` — total tries (first attempt included).
  * backoff for attempt ``k`` (0-based retry index) is
    ``min(base_delay * multiplier**k, max_delay)`` scaled by a jitter
    factor drawn uniformly from ``[1 - jitter, 1 + jitter]``.  The draw
    comes from ``random.Random(seed)`` so a seeded policy produces a
    byte-identical sleep program — the same determinism discipline as
    ``chaos.faults.FaultSchedule``.
  * ``deadline_s`` — optional overall budget for the WHOLE operation
    (attempts + sleeps).  ``start()`` arms it; ``remaining()`` propagates
    the budget into per-attempt timeouts so a retry loop can never
    overshoot its caller's deadline (deadline propagation, not per-try
    timeouts that silently multiply).

A copy of ``redisson_tpu/net/retry.py`` less its link profiles: the
replication link (``replica_link_kwargs``) has the one fixed policy of the
reference's default ``lan`` profile.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional


class DeadlineExceeded(TimeoutError):
    """The policy's overall deadline elapsed before the operation succeeded."""


@dataclass
class RetryPolicy:
    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.2          # +/- fraction of the computed delay
    deadline_s: Optional[float] = None
    seed: int = 0
    _rng: random.Random = field(default=None, repr=False, compare=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self._rng = random.Random(self.seed)

    # -- backoff -------------------------------------------------------------

    def backoff(self, attempt: int) -> float:
        """Sleep before retry `attempt` (0-based: the sleep between try 1
        and try 2 is backoff(0))."""
        delay = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, delay)

    # -- deadline propagation ------------------------------------------------

    def start(self) -> "RetryClock":
        """Arm the deadline for ONE operation; the policy itself is
        reusable (a clock per call, shared schedule)."""
        return RetryClock(self)


def call_with_retry(policy: RetryPolicy, fn, retryable=(Exception,)):
    """Run ``fn()`` under a policy's schedule: retry on ``retryable`` until
    the attempt budget or deadline runs out, then re-raise the LAST failure
    (a DeadlineExceeded mid-backoff chains it as ``__cause__``).  The one
    call shape control-plane loops need (supervisor view learning during a
    rolling restart, replica re-wiring) without hand-rolled sleep loops."""
    clock = policy.start()
    while True:
        clock.attempt += 1
        try:
            return fn()
        except retryable as e:  # noqa: PERF203 — retry loop by definition
            if not clock.more_attempts():
                raise
            try:
                clock.sleep()
            except DeadlineExceeded as dl:
                raise dl from e


class RetryClock:
    """One operation's view of a RetryPolicy: attempt budget + armed
    deadline.  ``sleep()`` truncates the backoff to the remaining budget
    and raises :class:`DeadlineExceeded` once it hits zero, so callers
    never sleep past their deadline just to fail on wake."""

    __slots__ = ("policy", "deadline", "attempt")

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.deadline = (
            time.monotonic() + policy.deadline_s
            if policy.deadline_s is not None else None
        )
        self.attempt = 0

    def remaining(self) -> Optional[float]:
        """Seconds left in the operation budget (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def attempt_timeout(self, default: Optional[float]) -> Optional[float]:
        """Per-attempt timeout clamped to the remaining budget — the
        propagation half: a 3s command timeout inside a 1s-left operation
        budget waits 1s, not 3."""
        rem = self.remaining()
        if rem is None:
            return default
        if default is None:
            return max(0.0, rem)
        return max(0.0, min(default, rem))

    def more_attempts(self) -> bool:
        if self.attempt >= self.policy.max_attempts:
            return False
        rem = self.remaining()
        return rem is None or rem > 0

    def sleep(self) -> None:
        """Back off before the next attempt; raises DeadlineExceeded when
        the budget can't cover even a truncated sleep."""
        delay = self.policy.backoff(self.attempt - 1 if self.attempt else 0)
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                raise DeadlineExceeded(
                    f"retry deadline ({self.policy.deadline_s}s) exceeded "
                    f"after {self.attempt} attempts"
                )
            delay = min(delay, rem)
        if delay > 0:
            time.sleep(delay)



def replica_link_kwargs() -> dict:
    """NodeClient kwargs for a replication data link (ReplicaHandle's push
    link, REPLICAOF's full-sync pull): the single-shot link of the
    reference's default profile.  The failure detectors own liveness and a
    dropped link is rebuilt by the shipper's next sweep, so per-call
    retries stay off."""
    return {"ping_interval": 0, "retry_attempts": 1}
