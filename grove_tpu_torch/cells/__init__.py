"""Cellular control plane: sharded reconcile cells with journal-replay
crash recovery (docs/design.md "Cellular control plane").

The control plane partitions into cells along the seams the QueueTree
already draws — each root subtree is a self-contained borrow domain, so a
whole subtree (and a topology slice of the fleet) lands in exactly one cell
(partition.py). Each cell owns its slice outright: its own sub-snapshot,
its own drain/stream engine (solver/drain.py + solver/stream.py, reused
unchanged), its own warm-path cache handle, its own flight-recorder journal
and named lease (cell.py). A thin coordinator owns everything cross-cell:
routing, borrowed capacity, reclaim (coordinator.py).

Crash recovery is journal replay: every wave record carries its full encode
closure, so a restarting cell bitwise-replays its journal tail
(trace/replay.py), rebuilds allocated/decided/bindings from the recorded
verdicts, and resumes past its last engine epoch — zero lost gangs, zero
double-bound gangs, proven by `python -m grove_tpu_torch.bench --scenario
cells` and tests/test_torch_cells.py.

The port's copy of grove_tpu/cells: a Cell drains and `recover` replays on
`device` (the card unless the caller passes "cpu").
"""

from grove_tpu_torch.cells.cell import (
    Cell,
    CellCrash,
    CellStats,
    RecoveryReport,
    audit_journal,
    recover,
)
from grove_tpu_torch.cells.coordinator import CellCoordinator, CoordinatorStats
from grove_tpu_torch.cells.partition import (
    CellPlan,
    cell_names,
    fleet_slices,
    partition_domains,
    partition_tree,
    with_fleet,
)

__all__ = [
    "Cell",
    "CellCrash",
    "CellStats",
    "RecoveryReport",
    "audit_journal",
    "recover",
    "CellCoordinator",
    "CoordinatorStats",
    "CellPlan",
    "cell_names",
    "fleet_slices",
    "partition_domains",
    "partition_tree",
    "with_fleet",
]
