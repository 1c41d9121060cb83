"""SLO-class semantics: the one place admission order, borrowing
eligibility, and eviction order are defined.

The three classes (api/constants.py SLO_CLASSES) form a strict tier order:

  rank 0  latency            admits first; in-quota only (never borrows, so
                             the queue reclaim verdict can never name it off
                             borrowed share); evicted last
  rank 1  standard           the default; may borrow over quota
  rank 2  batch-preemptible  admits last; may borrow; evicted FIRST when an
                             in-quota contender reclaims or a floor
                             rejection preempts

Rank is used ascending for admission (lower = earlier in the solve batch)
and descending for victim selection (higher = preferred victim), so the two
orders cannot drift apart.

The port's copy of grove_tpu/tenancy/slo.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from grove_tpu_torch.api.constants import (
    DEFAULT_SLO_CLASS,
    SLO_CLASS_LATENCY,
    SLO_CLASSES,
)

_RANK = {cls: i for i, cls in enumerate(SLO_CLASSES)}


def is_valid_slo_class(cls: str) -> bool:
    return cls in _RANK


def normalized_slo_class(cls: str | None) -> str:
    """Empty/unknown collapses to the default — the controller must never
    crash on a gang admitted before the field existed."""
    return cls if cls in _RANK else DEFAULT_SLO_CLASS


def slo_rank(cls: str | None) -> int:
    """Admission tier: 0 admits first. Unknown/legacy gangs rank standard."""
    return _RANK[normalized_slo_class(cls)]


def slo_borrow_eligible(cls: str | None) -> bool:
    """latency gangs are in-quota only: they never ride borrowed capacity,
    which is exactly what makes them unreclaimable (queues.py reclaim names
    borrowed usage first; a gang that cannot borrow cannot be the borrower
    an in-quota contender beats)."""
    return normalized_slo_class(cls) != SLO_CLASS_LATENCY


def revocation_victim_key(cls: str | None, priority: int, name: str) -> tuple:
    """Eviction order when a revocation deadline forces a node clear
    (controller._revocation_evict): batch-preemptible tiers go first
    (descending rank), then lowest effective priority, then name — the
    deterministic mirror of the admission order, so the journal shows
    low-SLO work absorbing the reclaim ahead of latency work."""
    return (-slo_rank(cls), priority, name)


def stream_order_key(priority_of=None):
    """Window-ordering key for solver.stream.drain_stream(order_key=...):
    tier first, then priority descending. The key depends only on
    template-level fields (sloClass, PriorityClass), so it is family-uniform
    and the stream driver's stable sort keeps base gangs ahead of their
    scaled siblings."""
    if priority_of is None:
        priority_of = lambda g: 0  # noqa: E731 - tier-only ordering

    def key(gang):
        return (slo_rank(getattr(gang, "slo_class", "")), -priority_of(gang))

    return key
