"""Decorrelated-jitter backoff — the one retry-pacing policy for the stack.

Every retry loop that talks to something that can flake (the kube wire
client, the bind push, the watch resubscribe, the resilience ladder's bind
retry) shares THIS policy instead of growing its own fixed-sleep variant:

  sleep_n = min(cap, uniform(base, 3 * sleep_{n-1}))

— the "decorrelated jitter" scheme (AWS architecture blog): retries spread
out under contention (no thundering herd after an apiserver hiccup) while
the cap bounds the worst-case wait and `base` keeps the first retry fast.

Determinism contract: a Backoff seeded with the same `seed` yields the same
sleep sequence — chaos tests replay fault schedules bit-for-bit, so the
recovery timeline they assert on must be reproducible too. Callers that
want real entropy pass seed=None (system randomness).

Deadline awareness: `next_delay()` returns None once the (optional)
deadline would be exceeded — the caller stops retrying instead of sleeping
past its budget, and a sleep is clipped so the LAST retry still happens at
the deadline rather than overshooting it.

The port's copy of grove_tpu/utils/backoff.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import random
import time


class Backoff:
    """One retry episode's pacing state (not thread-safe; one per episode).

    >>> b = Backoff(base_s=0.1, cap_s=2.0, seed=7)
    >>> delay = b.next_delay()   # first retry: exactly base_s
    >>> delay = b.next_delay()   # then decorrelated jitter under cap_s
    """

    def __init__(
        self,
        base_s: float = 0.05,
        cap_s: float = 2.0,
        *,
        deadline_s: float | None = None,  # absolute, on `clock`'s axis
        seed: int | None = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ) -> None:
        if base_s <= 0:
            raise ValueError(f"base_s must be > 0, got {base_s}")
        if cap_s < base_s:
            raise ValueError(f"cap_s must be >= base_s, got {cap_s} < {base_s}")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.deadline_s = deadline_s
        self.clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._prev = 0.0  # last delay handed out (0 = none yet)
        self.attempts = 0  # delays handed out so far

    def next_delay(self) -> float | None:
        """The next sleep in seconds, or None when the deadline is spent.

        The first delay is exactly `base_s` (deterministic fast retry);
        subsequent delays are uniform in [base_s, 3 * previous], capped at
        `cap_s`. A delay that would overshoot the deadline is CLIPPED to
        land on it — the final retry fires at the deadline, not past it."""
        if self._prev == 0.0:
            delay = self.base_s
        else:
            delay = min(self.cap_s, self._rng.uniform(self.base_s, 3.0 * self._prev))
        if self.deadline_s is not None:
            remaining = self.deadline_s - self.clock()
            if remaining <= 0:
                return None
            delay = min(delay, remaining)
        self._prev = delay
        self.attempts += 1
        return delay

    def sleep(self) -> bool:
        """Sleep the next delay; False when the deadline is spent (caller
        should stop retrying)."""
        delay = self.next_delay()
        if delay is None:
            return False
        self._sleep(delay)
        return True

    def reset(self) -> None:
        """Back to the fast first retry (call after a success so the NEXT
        episode starts fresh — long-lived loops like the watch reuse one
        Backoff across episodes)."""
        self._prev = 0.0
        self.attempts = 0


def retry(
    fn,
    *,
    attempts: int = 3,
    base_s: float = 0.05,
    cap_s: float = 2.0,
    deadline_s: float | None = None,
    seed: int | None = None,
    retry_on: tuple = (Exception,),
    clock=time.monotonic,
    sleep=time.sleep,
):
    """Call `fn()` up to `attempts` times with decorrelated-jitter pacing.

    Returns fn's value; re-raises the last exception when attempts (or the
    deadline) run out. `deadline_s` here is RELATIVE (a budget from now)."""
    abs_deadline = clock() + deadline_s if deadline_s is not None else None
    b = Backoff(
        base_s, cap_s, deadline_s=abs_deadline, seed=seed, clock=clock, sleep=sleep
    )
    while True:
        try:
            return fn()
        except retry_on:
            if b.attempts + 1 >= attempts or not b.sleep():
                raise
