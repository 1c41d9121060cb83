"""The shared incremental re-solve discipline: pending sub-gangs, priority
order, replica-spread avoid sets (grove_tpu/solver/planner.py counterpart,
whole).

The placement paths re-solve partially scheduled gangs the same way:
encode only the unbound pods, shrink each group's floor by what is already
bound, keep only the group-constraint configs that still cover a pending
group, and order the batch by priority. The migration planner
(solver/defrag.py) builds its whole-gang re-placements with
`build_pending_subgang`; `sort_pending` and `build_spread_avoid` serve the
serving path.
"""

from __future__ import annotations

from typing import Callable, Optional

from grove_tpu_torch.api.podgang import NamespacedName, PodGang, PodGroup


def build_pending_subgang(
    gang: PodGang,
    unbound_refs: dict[str, list[NamespacedName]],
    bound_counts: dict[str, int],
) -> Optional[PodGang]:
    """Sub-gang over the unbound pods of `gang`; None if nothing is pending.

    `unbound_refs`: group name -> pod references still needing a node.
    `bound_counts`: group name -> pods already bound (shrinks the gang floor,
    PodGroup.MinReplicas semantics, scheduler podgang.go:80-84).
    """
    sub = PodGang(
        name=gang.name,
        namespace=gang.namespace,
        pcs_name=gang.pcs_name,
        pcs_replica_index=gang.pcs_replica_index,
        base_podgang_name=gang.base_podgang_name,
        scaled_index=gang.scaled_index,
        queue=gang.queue,
        slo_class=gang.slo_class,
    )
    sub.spec.priority_class_name = gang.spec.priority_class_name
    sub.spec.topology_constraint = gang.spec.topology_constraint
    sub.spec.spread_key = gang.spec.spread_key
    for grp in gang.spec.pod_groups:
        refs = unbound_refs.get(grp.name) or []
        if not refs:
            continue
        sub.spec.pod_groups.append(
            PodGroup(
                name=grp.name,
                pod_references=list(refs),
                min_replicas=max(0, grp.min_replicas - bound_counts.get(grp.name, 0)),
                topology_constraint=grp.topology_constraint,
            )
        )
    if not sub.spec.pod_groups:
        return None
    pending_groups = {g.name for g in sub.spec.pod_groups}
    sub.spec.topology_constraint_group_configs = [
        gc
        for gc in gang.spec.topology_constraint_group_configs
        if any(n in pending_groups for n in gc.pod_group_names)
    ]
    return sub


def sort_pending(
    gangs: list[PodGang],
    priority_of: Callable[[PodGang], int],
    tier_of: Optional[Callable[[PodGang], int]] = None,
) -> list[PodGang]:
    """Priority order = solver batch order: higher priority first, base gangs
    before their scaled gangs, then stable by scaled index and name.

    The ranking key is the FAMILY priority — the max priority over a base
    gang and every scaled gang that depends on it — not the gang's own.
    Encoding gates a scaled gang out of the batch unless its base appears at
    an earlier index (or is already scheduled), so sorting a high-priority
    scaled gang ahead of its lower-priority base would silently reject it
    for that solve; lifting the base to the family max preserves both the
    dependency invariant and the intent that the critical member gets
    scheduled early (scheduler/api/core/v1alpha1/podgang.go:51-72 priority +
    base-gang semantics).

    Only the BASE is lifted: a scaled sibling keeps its own priority (its
    base's lifted rank plus the is_scaled tiebreak already guarantee the
    base sorts earlier), so a low-priority scaled sibling cannot ride its
    family's lift past higher-priority unrelated gangs.

    `tier_of` (tenancy SLO rank, tenancy/slo.py) leads the key when given:
    tiers dominate priority, so a latency gang admits ahead of any
    standard/batch gang regardless of PriorityClass or aging boost. Every
    gang of a family shares one template and hence one tier, so the
    family-lift invariant is unaffected."""
    family_prio: dict[str, int] = {}
    for g in gangs:
        root = g.base_podgang_name or g.name
        p = priority_of(g)
        family_prio[root] = max(family_prio.get(root, p), p)

    def rank(g: PodGang) -> int:
        return priority_of(g) if g.is_scaled else family_prio[g.name]

    tier = tier_of if tier_of is not None else (lambda g: 0)
    return sorted(
        gangs,
        key=lambda g: (tier(g), -rank(g), g.is_scaled, g.scaled_index, g.name),
    )


def build_spread_avoid(
    spreading: list[PodGang],
    nodes_by_pcs_replica: dict[tuple[str, int], set],
) -> dict[str, set]:
    """Sibling avoid-sets for replica spread, shared by the placement paths.

    `spreading`: pending BASE gangs whose spec carries a spread_key.
    `nodes_by_pcs_replica`: (pcs_name, replica_index) -> nodes that replica's
    pods occupy right now (names or indices — the caller's currency).
    Returns gang name -> union of nodes every SIBLING replica occupies.
    Living here keeps the controller and the sidecar from drifting on what
    counts as a sibling (same PCS, different replica index)."""
    out: dict[str, set] = {}
    for gang in spreading:
        sib: set = set()
        for (pcs, replica), nodes in nodes_by_pcs_replica.items():
            if pcs == gang.pcs_name and replica != gang.pcs_replica_index:
                sib |= nodes
        if sib:
            out[gang.name] = sib
    return out
