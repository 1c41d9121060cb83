"""Deterministic control-plane partitioning: subtree seams -> cells.

The QueueTree already draws the boundaries: a ROOT queue can never borrow
(orchestrator/queues.py — no parent to borrow from), so each root's subtree
is a self-contained admission/borrow domain. A cell plan assigns whole root
subtrees to cells; every queue inherits its root's cell, so a gang pinned to
any queue resolves to exactly one cell and in-subtree borrowing never
crosses a cell boundary. Cross-subtree traffic (spanning gangs, borrowed
capacity, reclaim) is the coordinator's job by construction.

The fleet shards the same way along a topology level: domains (zones by
default) round-robin onto cells, so a cell's node slice is topologically
contiguous and its drain engine sees a coherent sub-snapshot.

Everything here is a PURE function of its inputs — sorted names,
round-robin in sorted order, no clocks, no randomness — so two processes
computing a plan from the same tree/fleet agree byte-for-byte
(tests/test_cells.py pins determinism and the exactly-one-cell invariant).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grove_tpu_torch.orchestrator.queues import QueueTree


def cell_names(count: int) -> tuple[str, ...]:
    """Canonical cell names: cell-0 .. cell-(n-1)."""
    return tuple(f"cell-{i}" for i in range(max(1, int(count))))


@dataclass(frozen=True)
class CellPlan:
    """The partition: which cell owns which queues and topology domains."""

    cells: tuple[str, ...]
    # every queue in the tree -> owning cell (root's assignment inherited)
    queue_cell: dict[str, str] = field(default_factory=dict)
    # root queue -> cell (the seam-level assignment queue_cell derives from)
    root_cell: dict[str, str] = field(default_factory=dict)
    # topology domain value (e.g. "z0") -> cell; empty when fleet sharding
    # was not requested
    domain_cell: dict[str, str] = field(default_factory=dict)

    def cell_of_queue(self, queue: str) -> str | None:
        """The owning cell, or None for an unknown/empty queue — those are
        unpinned and the coordinator places them."""
        return self.queue_cell.get(queue) if queue else None

    def queues_of(self, cell: str) -> list[str]:
        return sorted(q for q, c in self.queue_cell.items() if c == cell)

    def domains_of(self, cell: str) -> list[str]:
        return sorted(d for d, c in self.domain_cell.items() if c == cell)

    def to_doc(self) -> dict:
        return {
            "cells": list(self.cells),
            "rootCell": dict(sorted(self.root_cell.items())),
            "queueCell": dict(sorted(self.queue_cell.items())),
            "domainCell": dict(sorted(self.domain_cell.items())),
        }


def partition_tree(tree: QueueTree | None, count: int) -> CellPlan:
    """Assign each root subtree to a cell: roots sorted, round-robin over
    the cell list. Pure in (tree shape, count) — spec-dict insertion order,
    clocks, and process identity cannot change the answer. A None/empty
    tree yields a plan with cells but no queue pins (every gang is unpinned
    and the coordinator spreads families deterministically)."""
    cells = cell_names(count)
    if tree is None:
        return CellPlan(cells=cells)
    root_cell = {
        root: cells[i % len(cells)] for i, root in enumerate(tree.roots())
    }
    queue_cell = {
        name: root_cell[tree.root_of(name)] for name in sorted(tree.specs)
    }
    return CellPlan(cells=cells, queue_cell=queue_cell, root_cell=root_cell)


def partition_domains(domains, cells: tuple[str, ...]) -> dict[str, str]:
    """Topology domain values -> cells, sorted round-robin (pure)."""
    cells = tuple(cells) or ("cell-0",)
    return {d: cells[i % len(cells)] for i, d in enumerate(sorted(set(domains)))}


def with_fleet(plan: CellPlan, nodes, label_key: str) -> CellPlan:
    """Extend a plan with a fleet shard along `label_key` (e.g. the zone
    label): each domain's nodes land wholly in one cell. Nodes missing the
    label shard with the "" domain."""
    domain_cell = partition_domains(
        (n.labels.get(label_key, "") for n in nodes), plan.cells
    )
    return CellPlan(
        cells=plan.cells,
        queue_cell=dict(plan.queue_cell),
        root_cell=dict(plan.root_cell),
        domain_cell=domain_cell,
    )


def fleet_slices(plan: CellPlan, nodes, label_key: str) -> dict[str, list]:
    """The per-cell node slices a plan's domain map implies, preserving the
    fleet's node order within each slice (order is identity for snapshot
    indices). Every node lands in exactly one slice."""
    out: dict[str, list] = {c: [] for c in plan.cells}
    for n in nodes:
        cell = plan.domain_cell.get(n.labels.get(label_key, ""))
        if cell is None:
            cell = plan.cells[0]
        out[cell].append(n)
    return out
