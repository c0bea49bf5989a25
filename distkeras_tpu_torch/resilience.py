"""Retry policy, a copy of ``RetryPolicy`` from
``distkeras_tpu/resilience.py`` (the class alone, kept in the port so that
it imports nothing of the JAX package).

``serving.py`` builds its ``DEFAULT_RELOAD_POLICY`` from it at import, as
the JAX package's does.  The rest of that module (``ShardJournal``,
``ShardSupervisor``, ``EngineSupervisor``) comes with the async host-PS
family and the wire front-end.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """One retry contract for every connect/reconnect path.

    ``attempts`` tries with exponential backoff (``backoff * 2**i`` capped at
    ``max_backoff``), each delay stretched by a uniform random factor in
    ``[1, 1+jitter]`` so a fleet of workers re-dialing a restarted shard
    doesn't arrive in lockstep.  ``attempts=None`` retries until ``deadline``
    (total wall-clock seconds) expires; at least one of the two bounds must
    be set.  ``seed`` pins the jitter stream for deterministic tests; the
    default ``None`` gives every instance its own stream — exactly what
    de-synchronizes the herd.
    """

    attempts: Optional[int] = 10
    backoff: float = 0.05
    max_backoff: float = 2.0
    jitter: float = 0.5
    deadline: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.attempts is None and self.deadline is None:
            raise ValueError(
                "RetryPolicy needs at least one bound: attempts or deadline")
        if self.attempts is not None and int(self.attempts) < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")

    def replace(self, **kw) -> "RetryPolicy":
        return dataclasses.replace(self, **kw)

    def delays(self) -> Iterator[float]:
        """The jittered backoff sequence (one delay per retry)."""
        rng = random.Random(self.seed)
        i = 0
        while self.attempts is None or i < int(self.attempts):
            d = min(self.backoff * (2.0 ** i), self.max_backoff)
            if self.jitter:
                d *= 1.0 + self.jitter * rng.random()
            yield d
            i += 1

    def call(self, fn: Callable[[], Any], retry_on: tuple) -> Any:
        """Run ``fn`` under this policy; re-raises the last exception once
        both bounds (attempts and deadline) are exhausted."""
        t0 = time.monotonic()
        last: Optional[BaseException] = None
        for d in self.delays():
            try:
                return fn()
            except retry_on as e:
                last = e
                if (self.deadline is not None
                        and time.monotonic() - t0 + d > self.deadline):
                    break
                time.sleep(d)
        raise last  # type: ignore[misc]

    def call_reconnecting(self, fn: Callable[[], Any],
                          reconnect: Callable[[], None],
                          retry_on: tuple,
                          reconnect_on: tuple = (ConnectionError,
                                                 OSError)) -> Any:
        """:meth:`call`, with a transport-repair step between attempts:
        when ``fn`` raises one of ``reconnect_on``, ``reconnect()`` runs
        best-effort (its own ``OSError`` is swallowed — the endpoint may
        still be down, and the policy's backoff covers the wait) before
        the failure re-enters the retry loop.  Idempotent only because
        serving requests are deterministic in their seed, so callers must
        not use it for non-seeded effects."""
        def attempt() -> Any:
            try:
                return fn()
            except reconnect_on:
                try:
                    reconnect()
                except OSError:
                    pass  # endpoint still down: keep backing off
                raise
        return self.call(attempt, retry_on=retry_on)
