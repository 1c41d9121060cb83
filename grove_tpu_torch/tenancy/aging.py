"""Deterministic priority aging.

A pending gang's effective priority is its PriorityClass value plus an
aging boost that grows with time spent waiting. The boost follows a
half-life-doubling ladder: step k unlocks after the gang has waited
half_life * (2^k - 1) seconds, so every successive step takes twice as long
as the last —

    waited <  h        -> 0
    waited >= h        -> 1
    waited >= 3h       -> 2
    waited >= 7h       -> 3
    waited >= (2^k-1)h -> k   (capped at max_boost)

Early steps come fast enough that a low-weight tenant's in-quota demand
climbs past habitual borrowers within a few half-lives; the geometric
slow-down keeps an unschedulable gang from aging without bound and
inverting the whole priority space. The inputs are (waited, half_life,
max_boost) only — no wall clock, no randomness — so a boost computed during
a recorded run replays bitwise from the journaled inputs.

The port's copy of grove_tpu/tenancy/aging.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations


def aging_boost(waited_s: float, half_life_s: float, max_boost: int) -> int:
    """Completed doubling periods of `half_life_s` within `waited_s`."""
    if half_life_s <= 0.0 or max_boost <= 0 or waited_s < half_life_s:
        return 0
    boost = 0
    threshold = half_life_s
    while boost < max_boost and waited_s >= threshold:
        boost += 1
        # Next step unlocks at h*(2^(k+1)-1) = threshold*2 + h.
        threshold = threshold * 2.0 + half_life_s
    return boost
