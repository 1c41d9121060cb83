"""The thin cross-cell layer: routing, borrowed capacity, reclaim.

Cells are deliberately ignorant of each other — a cell admits only gangs
pinned to its own queues (Cell.serve refuses the rest), so EVERY cross-cell
decision concentrates here:

  route    queue-pinned gangs go to their subtree's cell (the partition
           plan); unpinned gangs (no queue, or a queue the tree doesn't
           know) spread deterministically by gang family in first-appearance
           order. Families never split: a base and its scaled siblings
           always land on one cell (the engine requires it, and a gang
           spanning cells would otherwise double-admit).
  borrow   a gang its home cell rejected (slice full) may ride another
           cell's spare capacity. Contending borrowers are ordered by the
           SAME slo/priority order as tenancy admission (latency never
           borrows — tenancy/slo.py); target cells are tried in headroom
           order (most free first, name tie-break). Every borrow routes
           through Cell.admit_borrowed — the coordinator-only entry — and is
           registered for reclaim.
  reclaim  a home cell that needs its capacity back names its borrowed
           gangs in eviction order (batch-preemptible first, then lowest
           priority — tenancy.revocation_victim_key) and the coordinator
           releases them on the host cells.

The `cell.partition` fault site gates every cross-cell touch: a partitioned
cell is unreachable this pass — borrows and reclaims against it defer
(counted, journal-visible), never half-apply.
"""

from __future__ import annotations

from dataclasses import dataclass

from grove_tpu_torch import faults as faults_mod
from grove_tpu_torch.cells.cell import Cell, CellCrash
from grove_tpu_torch.cells.partition import CellPlan
from grove_tpu_torch.tenancy.slo import (
    revocation_victim_key,
    slo_borrow_eligible,
    slo_rank,
)


@dataclass
class CoordinatorStats:
    routed: int = 0  # gangs routed to their pinned/assigned cell
    unpinned: int = 0  # gangs spread by family (no queue pin)
    borrows: int = 0  # gangs admitted onto another cell's capacity
    borrow_denied: int = 0  # borrow candidates no cell could host
    partition_deferred: int = 0  # cross-cell touches deferred by cell.partition
    reclaims: int = 0  # borrowed gangs released back to their home cell

    def to_doc(self) -> dict:
        return {
            "routed": self.routed,
            "unpinned": self.unpinned,
            "borrows": self.borrows,
            "borrowDenied": self.borrow_denied,
            "partitionDeferred": self.partition_deferred,
            "reclaims": self.reclaims,
        }


class CellCoordinator:
    """Deterministic cross-cell routing over a partition plan."""

    def __init__(
        self,
        plan: CellPlan,
        cells: dict[str, Cell],
        *,
        faults=None,  # faults.FaultInjector; None = the process-installed one
    ) -> None:
        self.plan = plan
        self.cells = dict(cells)
        self.faults = faults
        self.stats = CoordinatorStats()
        # family key -> assigned cell, in first-appearance order (the
        # deterministic spread for unpinned traffic)
        self._family_cell: dict[str, str] = {}
        # borrowed gang -> (home cell, host cell), for reclaim
        self._borrowed: dict[str, tuple[str, str]] = {}

    # ---- routing -----------------------------------------------------------------

    def route(self, gang) -> str:
        """The cell this gang belongs on. Pure given the plan and the
        arrival order seen so far (the family spread counter is the only
        state, and it advances deterministically)."""
        family = gang.base_podgang_name or gang.name
        assigned = self._family_cell.get(family)
        if assigned is not None:
            return assigned
        pinned = self.plan.cell_of_queue(getattr(gang, "queue", ""))
        if pinned is not None:
            cell = pinned
            self.stats.routed += 1
        else:
            # Unpinned: round-robin by family in first-appearance order.
            cell = self.plan.cells[
                len(self._family_cell) % len(self.plan.cells)
            ]
            self.stats.unpinned += 1
        self._family_cell[family] = cell
        return cell

    def assign(self, arrivals: list) -> dict[str, list]:
        """Partition an arrival trace by cell (family-whole, order
        preserved within each cell's slice)."""
        out: dict[str, list] = {c: [] for c in self.plan.cells}
        for t, g in arrivals:
            out[self.route(g)].append((t, g))
        return out

    # ---- reachability (cell.partition) -------------------------------------------

    def reachable(self, cell: str) -> bool:
        """One cross-cell touch: False (and counted) when the partition
        fault fires for this cell this evaluation."""
        inj = self.faults if self.faults is not None else faults_mod.active()
        try:
            inj.maybe_raise("cell.partition", cell=cell)
        except faults_mod.InjectedFault:
            self.stats.partition_deferred += 1
            return False
        return True

    # ---- borrowed capacity -------------------------------------------------------

    def _headroom_order(self, exclude: str) -> list[str]:
        """Candidate host cells, most spare capacity first (deterministic:
        free sum descending, then name)."""
        scored = []
        for name, cell in self.cells.items():
            if name == exclude or not cell.alive:
                continue
            scored.append((-float(cell.snapshot.free.sum()), name))
        return [name for _, name in sorted(scored)]

    def borrow(self, arrivals: list, pods_by_name: dict, home: str) -> dict:
        """Try to place gangs their home cell rejected onto other cells'
        spare capacity; returns the bindings that landed ({gang: {pod:
        node}}). Families move whole; contenders go in tenancy admission
        order (slo tier, then original position); latency-class gangs never
        borrow (tenancy/slo.py — which is what keeps them unreclaimable)."""
        families: dict[str, list] = {}
        order: list[str] = []
        for pos, (t, g) in enumerate(arrivals):
            key = g.base_podgang_name or g.name
            if key not in families:
                families[key] = []
                order.append(key)
            families[key].append((t, g))
        ranked = sorted(
            order,
            key=lambda k: (
                min(slo_rank(getattr(g, "slo_class", "")) for _, g in families[k]),
                order.index(k),
            ),
        )
        bound: dict[str, dict[str, str]] = {}
        for key in ranked:
            fam = families[key]
            if not all(
                slo_borrow_eligible(getattr(g, "slo_class", "")) for _, g in fam
            ):
                self.stats.borrow_denied += len(fam)
                continue
            landed = False
            for target in self._headroom_order(exclude=home):
                if not self.reachable(target):
                    continue
                try:
                    got = self.cells[target].admit_borrowed(fam, pods_by_name)
                except CellCrash as e:
                    if not e.partial:
                        continue  # nothing landed on the dead cell: the
                        # next target is safe to try
                    # The cell died BETWEEN family chunks: the chunks it
                    # committed are journaled there and rebind on recovery,
                    # so retrying the family elsewhere would double-admit
                    # them. Register what landed (reclaim can undo it) and
                    # stop; the unlanded remainder re-offers once the cell
                    # recovers.
                    for gang in e.partial:
                        self._borrowed[gang] = (home, target)
                    self.stats.borrows += len(e.partial)
                    self.stats.borrow_denied += sum(
                        1 for _, g in fam if g.name not in e.partial
                    )
                    bound.update(e.partial)
                    landed = True
                    break
                if got:
                    for gang in got:
                        self._borrowed[gang] = (home, target)
                    self.stats.borrows += len(got)
                    bound.update(got)
                    landed = True
                    break
            if not landed:
                self.stats.borrow_denied += len(fam)
        return bound

    # ---- reclaim -----------------------------------------------------------------

    def borrowed_from(self, home: str) -> list[tuple[str, str]]:
        """(gang, host cell) pairs currently riding borrowed capacity on
        behalf of `home`, name-ordered (the registry only knows names;
        reclaim() re-sorts with tenancy.revocation_victim_key when the
        caller supplies gang objects)."""
        return sorted(
            (gang, host)
            for gang, (h, host) in self._borrowed.items()
            if h == home
        )

    def reclaim(
        self, home: str, pods_by_name: dict, gangs_by_name: dict | None = None
    ) -> list[str]:
        """Release `home`'s borrowed gangs on their host cells (the home
        cell needs its capacity back). With `gangs_by_name` the eviction
        order is the tenancy one (revocation_victim_key); without it,
        name order (still deterministic). Unreachable hosts defer — their
        gangs stay borrowed and a later pass retries."""
        rows = self.borrowed_from(home)
        if gangs_by_name:
            rows.sort(
                key=lambda row: revocation_victim_key(
                    getattr(gangs_by_name.get(row[0]), "slo_class", ""),
                    int(getattr(gangs_by_name.get(row[0]), "priority", 0) or 0),
                    row[0],
                )
            )
        released: list[str] = []
        for gang, host in rows:
            if not self.reachable(host):
                continue
            if self.cells[host].release_gang(gang, pods_by_name):
                del self._borrowed[gang]
                self.stats.reclaims += 1
                released.append(gang)
        return released

    def status(self) -> dict:
        return {
            "plan": self.plan.to_doc(),
            "borrowedInFlight": len(self._borrowed),
            **self.stats.to_doc(),
        }
