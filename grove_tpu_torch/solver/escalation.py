"""Futile-escalation damper, shared by both serving paths.

`solver.portfolioEscalation` retries a rejecting solve once at a wider
portfolio width. In a saturated steady state (valid gangs that genuinely
don't fit — the normal condition of a full cluster) that retry is a
guaranteed no-op every pass, so both serving paths (orchestrator controller
and backend sidecar) damp it: remember the fingerprint of the solver-input
state whose escalated solve still rejected, and skip re-escalating until
the state changes. This module single-sources the fingerprint definition
and the damper state machine so the two paths cannot drift (the fingerprint
must cover EVERY input that could flip an escalated outcome: the pending
work, the committed placements, and each node's full scheduling-relevant
state — a capacity bump via UpdateCluster with unchanged node names must
re-arm escalation).

The port's copy of grove_tpu/solver/escalation.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from typing import Hashable, Iterable


def node_state_digest(nodes: Iterable) -> frozenset:
    """Hashable digest of every node field the solver reads — the
    schedulable bit, capacity, labels, and taints are all mutable in place
    (cordon, UpdateCluster) without changing the node-name set, so a
    names-only digest would miss real state changes."""
    return frozenset(
        (
            n.name,
            n.schedulable,
            tuple(sorted(n.capacity.items())),
            tuple(sorted(n.labels.items())),
            tuple(sorted(repr(sorted(t.items())) for t in n.taints)),
            # Revocation state flips snapshot schedulability without touching
            # the fields above — a notice must re-arm escalation (and break
            # the solve-skip wave fingerprint) exactly like a cordon.
            bool(getattr(n, "revocable", False)),
            getattr(n, "revocation_deadline", None),
        )
        for n in nodes
    )


def escalation_fingerprint(
    pending_keys: Iterable[Hashable],
    bound_pairs: Iterable[Hashable],
    nodes: Iterable,
) -> tuple:
    """Hashable digest of the solver inputs an escalated solve depends on.

    `pending_keys` identifies the pending gang set (names or spec
    fingerprints), `bound_pairs` the committed placements (pod, node), and
    `nodes` the Node objects (see node_state_digest).
    """
    return (
        frozenset(pending_keys),
        frozenset(bound_pairs),
        node_state_digest(nodes),
    )


class EscalationDamper:
    """Per-serving-path damper state. `key` separates independent waves
    (the controller uses floors/extras; the backend uses a single key)."""

    def __init__(self) -> None:
        self._futile_fp: dict[Hashable, tuple] = {}

    def effective_width(
        self, key: Hashable, fp: tuple, portfolio: int, escalation: int
    ) -> int:
        """The escalation width to use this pass: damped back to the base
        portfolio width while the state matches the last futile attempt."""
        if escalation > portfolio and self._futile_fp.get(key) == fp:
            return portfolio
        return escalation

    def record(
        self,
        key: Hashable,
        fp: tuple,
        escalated: bool,
        any_valid_rejected: bool,
    ) -> None:
        """After a solve: arm the damper when an ESCALATED solve still left
        valid gangs rejected; clear it when nothing valid is rejected (the
        backlog drained, so the next rejection deserves a fresh attempt)."""
        if escalated and any_valid_rejected:
            self._futile_fp[key] = fp
        elif not any_valid_rejected:
            self._futile_fp.pop(key, None)
