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

A copy of ``redisson_tpu/net/retry.py``, with its link profiles
(``LINK_PROFILES``, ``RTPU_RETRY_PROFILE``, the server's
``--retry-profile``): ``lan`` (the default) and ``wan``.
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


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



# -- link profiles -------------------------------------------------------------
#
# One switch tunes the cadence of EVERY cluster-internal link without code
# changes: ``RTPU_RETRY_PROFILE=wan`` (or ``tpu-server --retry-profile wan``)
# stretches backoff/deadlines for links that cross real networks, while the
# default ``lan`` profile is NUMERICALLY IDENTICAL to the policies the call
# sites hard-coded before profiles existed — so single-host fleets (and every
# deterministic fault-schedule test) see byte-identical retry behavior.
#
# Kinds:
#   * ``admin``   — migration coordinator control links (SETSLOT /
#     MIGRATESLOTS / SETVIEW; migration._admin_retry_policy historically)
#   * ``rejoin``  — supervisor view-learning / replica re-wiring during
#     restarts and promotions (supervisor._rejoin_retry_policy historically)
#   * ``replica`` — replication data links (ReplicaHandle, REPLICAOF
#     full-sync pulls).  ``None`` = the legacy single-shot discipline
#     (``retry_attempts=1``): on a LAN the failure detectors own liveness
#     and a dropped link is rebuilt by the shipper, so per-call retries stay
#     off; on a WAN the link itself retries with backoff so one flapped
#     packet doesn't force a full link teardown.

LINK_PROFILES: Dict[str, Dict[str, Optional[dict]]] = {
    "lan": {
        "admin": dict(max_attempts=4, base_delay=0.05, max_delay=1.0,
                      jitter=0.2, deadline_s=30.0),
        "rejoin": dict(max_attempts=5, base_delay=0.1, max_delay=1.0,
                       jitter=0.2, deadline_s=20.0),
        "replica": None,
    },
    "wan": {
        "admin": dict(max_attempts=8, base_delay=0.25, max_delay=8.0,
                      jitter=0.3, deadline_s=120.0),
        "rejoin": dict(max_attempts=8, base_delay=0.5, max_delay=8.0,
                       jitter=0.3, deadline_s=90.0),
        "replica": dict(max_attempts=5, base_delay=0.25, max_delay=5.0,
                        jitter=0.3, deadline_s=60.0),
    },
}

_active_profile: Optional[str] = None  # None = resolve from env on first use


def set_retry_profile(profile: Optional[str]) -> None:
    """Pin the process-wide link profile (``"lan"`` / ``"wan"``); ``None``
    un-pins it so the next lookup re-reads ``RTPU_RETRY_PROFILE``."""
    global _active_profile
    if profile is not None and profile not in LINK_PROFILES:
        raise ValueError(
            f"unknown retry profile {profile!r} "
            f"(have: {', '.join(sorted(LINK_PROFILES))})"
        )
    _active_profile = profile


def current_profile() -> str:
    """The active link profile: pinned value, else ``RTPU_RETRY_PROFILE``
    (unknown values fall back to ``lan`` rather than failing a server boot)."""
    if _active_profile is not None:
        return _active_profile
    env = os.environ.get("RTPU_RETRY_PROFILE", "lan").lower()
    return env if env in LINK_PROFILES else "lan"


def link_policy(kind: str, **overrides) -> RetryPolicy:
    """A fresh :class:`RetryPolicy` for one link kind under the active
    profile.  ``overrides`` patch individual fields (e.g. a caller-owned
    ``deadline_s``) without forking the profile table."""
    spec = LINK_PROFILES[current_profile()].get(kind)
    if spec is None:
        raise KeyError(f"link kind {kind!r} has no policy under "
                       f"profile {current_profile()!r}")
    return RetryPolicy(**{**spec, **overrides})


def replica_link_kwargs() -> dict:
    """NodeClient kwargs for a replication data link under the active
    profile.  ``lan`` reproduces the legacy single-shot link exactly
    (``ping_interval=0, retry_attempts=1`` — deterministic fault-schedule
    event counts depend on it); ``wan`` adds a per-call RetryPolicy so
    transient WAN flaps retry with backoff instead of killing the link."""
    spec = LINK_PROFILES[current_profile()].get("replica")
    kw: dict = {"ping_interval": 0, "retry_attempts": 1}
    if spec is not None:
        kw["retry_policy"] = RetryPolicy(**spec)
    return kw
