"""Defragmentation: fragmentation scoring and the batched migration and
rescue planners (grove_tpu/solver/defrag.py counterpart).

Placement here is write-once: after churn, free capacity ends up scattered
across topology domains, and a large gang with a required pack constraint
fails admission even though TOTAL free capacity is ample.

1. **Fragmentation score** (`fragmentation_report`, host numpy): per
   topology level and resource, the free capacity of the BEST single domain
   against the ideal — total free capacity, capped by the largest domain's
   capacity: `stranded = 1 - best / ideal`. A freshly empty cluster scores
   0; a churned cluster whose free capacity is scattered in slivers scores
   toward 1. The headline score is the max stranded over (level, resource),
   and the pair attaining it is the migration plan's yardstick.
   `largest_placeable` answers the operational question: how many pods of a
   request vector fit in the best single domain.

2. **Migration planner** (`plan_migrations`): re-place a prefix of the
   movable gangs onto the cluster MINUS THEIR OWN USAGE — one batched solve
   per candidate prefix through `solve()` (on the card by default, one
   launch of the dense kernel through the warm path's launch cache, so a
   second plan of the same shapes prepares nothing), decoded with
   `decode_bindings`, encode rows reused through the warm path's row cache.
   Prefix sizes are 1, 2, 4, ... and the full (capped) prefix, each padded
   to its next power of two; the fleet pads to next_pow2(nodes) with
   unschedulable rows. The winner maximizes (capacity recovered at the
   yardstick / pods migrated) among candidates that strictly improve the
   score; a move is always a whole-gang re-placement from one verdict.

3. **Rescue planner** (`plan_rescue`): whole-gang re-placement without the
   fragmentation gate, for gangs whose capacity is going away (cordoned or
   revoked nodes are never targets).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from grove_tpu_torch.api.podgang import NamespacedName
from grove_tpu_torch.api.types import TopologyDomain
from grove_tpu_torch.solver.core import SolverParams, decode_bindings, solve
from grove_tpu_torch.solver.encode import encode_gangs, next_pow2
from grove_tpu_torch.solver.planner import build_pending_subgang
from grove_tpu_torch.state.cluster import ClusterSnapshot, build_snapshot, pod_request_vector

_EPS = 1e-9


# ---- fragmentation scoring ----------------------------------------------------


@dataclass
class LevelFragmentation:
    """Stranded-capacity view of one (topology level, resource) pair."""

    level: str  # TopologyDomain value, e.g. "rack"
    resource: str
    total_free: float  # free over schedulable nodes, cluster-wide
    best_domain_free: float  # free in the single best domain
    best_domain: str  # its name ("" when the level has no domains)
    ideal_free: float  # min(total_free, largest domain capacity)
    stranded: float  # 1 - best/ideal in [0, 1]


@dataclass
class FragmentationReport:
    """Snapshot-wide fragmentation: the headline score is the worst stranded
    fraction over every coarse (non-host) level and resource with capacity."""

    score: float
    binding_level: str  # level attaining the score ("" when score is 0-able)
    binding_resource: str
    entries: list[LevelFragmentation] = field(default_factory=list)

    def to_doc(self) -> dict:
        """JSON-able form (the JAX report's own; the tests compare the two)."""
        return {
            "score": round(self.score, 4),
            "bindingLevel": self.binding_level,
            "bindingResource": self.binding_resource,
            "levels": [
                {
                    "level": e.level,
                    "resource": e.resource,
                    "totalFree": e.total_free,
                    "bestDomainFree": e.best_domain_free,
                    "bestDomain": e.best_domain,
                    "idealFree": e.ideal_free,
                    "stranded": round(e.stranded, 4),
                }
                for e in self.entries
            ],
        }


def _domain_matrix(values: np.ndarray, dom: np.ndarray, n_domains: int) -> np.ndarray:
    """Sum per-node `values` [N] into per-domain totals [D] (dom < 0 dropped)."""
    out = np.zeros((n_domains,), dtype=np.float64)
    mask = dom >= 0
    np.add.at(out, dom[mask], values[mask])
    return out


def _coarse_levels(snapshot: ClusterSnapshot) -> list[int]:
    """Indices of the non-host levels (host-level 'domains' are single nodes;
    consolidation across hosts is what the coarse levels measure). A topology
    with ONLY the host level falls back to it so the report is never empty."""
    coarse = [
        li
        for li, dom in enumerate(snapshot.level_domains)
        if dom != TopologyDomain.HOST
    ]
    return coarse or list(range(len(snapshot.level_domains)))


def fragmentation_report(
    snapshot: ClusterSnapshot, resources: tuple[str, ...] | None = None
) -> FragmentationReport:
    """Score `snapshot`'s stranded capacity (numpy-only — cheap enough for a
    periodic background loop at fleet scale; no device traffic)."""
    free = np.asarray(snapshot.free, dtype=np.float64)
    cap = np.asarray(snapshot.capacity, dtype=np.float64)
    sched = np.asarray(snapshot.schedulable, dtype=bool)
    free = np.where(sched[:, None], np.maximum(free, 0.0), 0.0)
    cap = np.where(sched[:, None], cap, 0.0)

    names = snapshot.resource_names
    res_idx = [
        j
        for j, rname in enumerate(names)
        if (resources is None or rname in resources) and cap[:, j].sum() > _EPS
    ]
    entries: list[LevelFragmentation] = []
    score, b_level, b_resource = 0.0, "", ""
    for li in _coarse_levels(snapshot):
        dom = np.asarray(snapshot.node_domain_id[li])
        n_domains = int(snapshot.num_domains[li])
        level_name = snapshot.level_domains[li].value
        if n_domains <= 0:
            continue
        for j in res_idx:
            dom_free = _domain_matrix(free[:, j], dom, n_domains)
            dom_cap = _domain_matrix(cap[:, j], dom, n_domains)
            total_free = float(free[:, j].sum())
            best_i = int(dom_free.argmax())
            best = float(dom_free[best_i])
            ideal = float(min(total_free, dom_cap.max(initial=0.0)))
            stranded = 0.0 if ideal <= _EPS else max(0.0, 1.0 - best / ideal)
            entry = LevelFragmentation(
                level=level_name,
                resource=names[j],
                total_free=total_free,
                best_domain_free=best,
                best_domain=(
                    snapshot.domain_names[li][best_i]
                    if best_i < len(snapshot.domain_names[li])
                    else ""
                ),
                ideal_free=ideal,
                stranded=stranded,
            )
            entries.append(entry)
            if stranded > score:
                score, b_level, b_resource = stranded, level_name, names[j]
    return FragmentationReport(
        score=score,
        binding_level=b_level,
        binding_resource=b_resource,
        entries=entries,
    )


def _level_index(snapshot: ClusterSnapshot, level: TopologyDomain) -> int | None:
    return snapshot.level_domains.index(level) if level in snapshot.level_domains else None


def largest_placeable(
    snapshot: ClusterSnapshot, request: dict[str, float], level: TopologyDomain
) -> int:
    """How many pods of `request` fit in the BEST single domain at `level`,
    packing per node — the largest gang a required pack constraint at that
    level could admit right now."""
    req = np.array([request.get(rname, 0.0) for rname in snapshot.resource_names],
                   dtype=np.float64)
    if not (req > 0).any():
        return 0
    free = np.asarray(snapshot.free, dtype=np.float64)
    free = np.where(np.asarray(snapshot.schedulable, dtype=bool)[:, None],
                    np.maximum(free, 0.0), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(req[None, :] > 0, free / np.maximum(req[None, :], _EPS), np.inf)
    slots = np.floor(ratio.min(axis=1) + 1e-6)  # [N]
    li = _level_index(snapshot, level)
    if li is None:
        return 0
    n_domains = int(snapshot.num_domains[li])
    if n_domains <= 0:
        return 0
    dom_slots = _domain_matrix(slots, np.asarray(snapshot.node_domain_id[li]), n_domains)
    return int(dom_slots.max(initial=0.0))


# ---- migration planning -------------------------------------------------------


@dataclass
class GangMove:
    """One gang's whole-gang re-placement (all changed pods rebind together,
    or the move does not execute)."""

    gang: str
    bindings: dict[str, str]  # pod -> TARGET node, changed pods only
    pods_total: int  # gang size (context for the disruption budget)


@dataclass
class MigrationPlan:
    moves: list[GangMove]
    gangs_considered: int
    candidates_evaluated: int
    pods_migrated: int  # total changed bindings across moves
    capacity_recovered: float  # best-domain free gained at the yardstick
    binding_level: str  # the yardstick (level, resource) the score bound on
    binding_resource: str
    score_before: float
    score_after: float  # projected fragmentation after executing every move
    efficiency: float  # capacity_recovered / pods_migrated
    solve_s: float  # wall seconds spent in candidate solves
    lowerings: int  # launch-cache entries prepared planning (0 on warm shapes)
    # Host-stage split of the planning loop: encode vs binding decode.
    encode_s: float = 0.0
    decode_s: float = 0.0

    def to_doc(self) -> dict:
        return {
            "moves": len(self.moves),
            "gangsConsidered": self.gangs_considered,
            "candidatesEvaluated": self.candidates_evaluated,
            "podsMigrated": self.pods_migrated,
            "capacityRecovered": self.capacity_recovered,
            "bindingLevel": self.binding_level,
            "bindingResource": self.binding_resource,
            "scoreBefore": round(self.score_before, 4),
            "scoreAfter": round(self.score_after, 4),
            "efficiency": round(self.efficiency, 4),
            "planSolveSeconds": round(self.solve_s, 4),
            "planEncodeSeconds": round(self.encode_s, 6),
            "planDecodeSeconds": round(self.decode_s, 6),
            "lowerings": self.lowerings,
        }


def _whole_subgang(gang, pods_by_name: dict):
    """The gang as a fully unbound re-placement candidate: every active pod
    encoded, floors intact (build_pending_subgang with nothing bound)."""
    unbound: dict[str, list] = {}
    for grp in gang.spec.pod_groups:
        refs = [r for r in grp.pod_references
                if (p := pods_by_name.get(r.name)) is not None and p.is_active]
        if refs:
            unbound[grp.name] = [NamespacedName(r.namespace, r.name) for r in refs]
    return build_pending_subgang(gang, unbound, {})


def candidate_ladder(n: int, cap: int) -> list[int]:
    """Prefix sizes to evaluate: powers of two below min(n, cap), then the
    full (capped) prefix — small fixes are preferred when they suffice and
    the big consolidation is still on the table."""
    top = min(n, max(1, cap))
    sizes = []
    k = 1
    while k < top:
        sizes.append(k)
        k *= 2
    sizes.append(top)
    return sizes


def _solve_bindings(snap, subs, pods_by_name, params, warm, pruning, device,
                    scheduled_gangs=None):
    """Encode `subs` (rows reused through the warm path's row cache), solve
    them in one batch through solve(), decode: ({gang: {pod: node}},
    encode seconds, decode seconds)."""
    row_keys = row_cache = None
    if warm is not None:
        from grove_tpu_torch.solver.warm import gang_row_digest

        epoch = snap.encode_epoch()
        row_cache = warm.encode_rows
        row_keys = [(gang_row_digest(s, pods_by_name), epoch) for s in subs]
    t_enc = time.perf_counter()
    batch, decode = encode_gangs(subs, pods_by_name, snap, pad_gangs_to=next_pow2(len(subs)),
                                 row_cache=row_cache, row_keys=row_keys,
                                 scheduled_gangs=scheduled_gangs)
    t_solve = time.perf_counter()
    result = solve(snap, batch, params, warm=warm, pruning=pruning, device=device)
    t_dec = time.perf_counter()
    out = decode_bindings(result.ok.cpu().numpy(), result.assigned.cpu().numpy(), decode, snap)
    return out, t_solve - t_enc, time.perf_counter() - t_dec


def plan_migrations(
    nodes: list,
    topology,
    movable: list,
    pods_by_name: dict,
    *,
    params: SolverParams = SolverParams(),
    warm=None,
    max_moves: int = 8,
    min_efficiency: float = 0.0,
    candidate_sizes: list[int] | None = None,
    resource_names: tuple[str, ...] | None = None,
    pruning=None,
    device=None,
) -> Optional[MigrationPlan]:
    """Plan migrations for `movable` gangs (caller-ordered: cheapest/lowest
    priority first) against `nodes`. `pods_by_name` holds EVERY pod — the
    movable gangs' (found through their pod references) and the fixed rest,
    whose bindings stay untouched.

    Each candidate re-places a PREFIX of `movable` onto the cluster minus
    that prefix's own usage, in one batched solve through `warm` (a
    solver.warm.WarmPath; its launch cache makes a repeat of the same shapes
    prepare nothing). The winner maximizes (capacity recovered / pods
    migrated) among candidates that strictly improve the fragmentation
    score; None when no candidate qualifies. `device` None means the card;
    "cpu" runs the plain PyTorch versions."""
    if not movable or not nodes:
        return None
    kwargs = {} if resource_names is None else {"resource_names": resource_names}
    pad = next_pow2(len(nodes))
    all_bound = [p for p in pods_by_name.values() if p.is_scheduled and p.is_active]
    snap_now = build_snapshot(nodes, topology, bound_pods=all_bound, pad_nodes_to=pad, **kwargs)
    before = fragmentation_report(snap_now)
    if not before.binding_level:
        return None
    li = _level_index(snap_now, TopologyDomain(before.binding_level))
    rj = snap_now.resource_names.index(before.binding_resource)

    def _yardstick(snapshot: ClusterSnapshot) -> float:
        """Best-domain free at the pre-plan yardstick (level, resource)."""
        free = np.asarray(snapshot.free, dtype=np.float64)
        free = np.where(np.asarray(snapshot.schedulable, dtype=bool), free[:, rj], 0.0)
        dom = np.asarray(snapshot.node_domain_id[li])
        return float(_domain_matrix(free, dom, int(snapshot.num_domains[li])).max(initial=0.0))

    best_before = _yardstick(snap_now)
    sizes = candidate_sizes or candidate_ladder(len(movable), max_moves)
    best_plan: Optional[MigrationPlan] = None
    solve_s = encode_s = decode_s = 0.0
    lowerings0 = warm.executables.lowerings if warm is not None else 0
    evaluated = 0
    for k in sizes:
        prefix = movable[:k]
        moving_pods = {r.name for g in prefix for grp in g.spec.pod_groups
                       for r in grp.pod_references}
        bound = [p for p in all_bound if p.name not in moving_pods]
        # The cluster minus the prefix's own usage: the solver sees their
        # capacity as free and may consolidate onto or across it.
        snap_k = build_snapshot(nodes, topology, bound_pods=bound, pad_nodes_to=pad, **kwargs)
        subs = [s for g in prefix if (s := _whole_subgang(g, pods_by_name))]
        if not subs:
            continue
        t0 = time.perf_counter()
        new_bindings, enc_s, dec_s = _solve_bindings(snap_k, subs, pods_by_name, params, warm,
                                                     pruning, device)
        solve_s += time.perf_counter() - t0 - enc_s
        encode_s += enc_s
        decode_s += dec_s
        evaluated += 1

        moves: list[GangMove] = []
        adj = np.array(snap_now.allocated, dtype=np.float32, copy=True)
        for g in prefix:
            plan_b = new_bindings.get(g.name)
            if not plan_b:
                continue  # the solver rejected the re-placement: the gang stays
            changed: dict[str, str] = {}
            total = 0
            for pod_name, node_name in plan_b.items():
                pod = pods_by_name.get(pod_name)
                if pod is None:
                    continue
                total += 1
                if pod.node_name != node_name:
                    changed[pod_name] = node_name
                    req = pod_request_vector(pod, snap_now.resource_names)
                    if pod.node_name in snap_now.node_index_map:
                        adj[snap_now.node_index(pod.node_name)] -= req
                    adj[snap_now.node_index(node_name)] += req
            if changed:
                moves.append(GangMove(gang=g.name, bindings=changed, pods_total=total))
        if not moves:
            continue
        snap_after = replace(snap_now, allocated=np.maximum(adj, 0.0), _tainted_idx=None,
                             _encode_epoch=None)
        after = fragmentation_report(snap_after)
        if after.score >= before.score - 1e-6:
            continue  # no strict improvement: not worth any disruption
        pods_migrated = sum(len(m.bindings) for m in moves)
        recovered = _yardstick(snap_after) - best_before
        efficiency = recovered / pods_migrated if pods_migrated else 0.0
        if efficiency < min_efficiency:
            continue
        cand = MigrationPlan(
            moves=moves, gangs_considered=len(movable), candidates_evaluated=evaluated,
            pods_migrated=pods_migrated, capacity_recovered=recovered,
            binding_level=before.binding_level, binding_resource=before.binding_resource,
            score_before=before.score, score_after=after.score, efficiency=efficiency,
            solve_s=solve_s, lowerings=0,
        )
        if best_plan is None or (cand.efficiency, -cand.pods_migrated) > (
                best_plan.efficiency, -best_plan.pods_migrated):
            best_plan = cand
    if best_plan is not None:
        best_plan.candidates_evaluated = evaluated
        best_plan.solve_s = solve_s
        best_plan.encode_s = encode_s
        best_plan.decode_s = decode_s
        best_plan.lowerings = warm.executables.lowerings - lowerings0 if warm is not None else 0
    return best_plan


def plan_rescue(
    nodes: list,
    topology,
    gangs: list,
    pods_by_name: dict,
    *,
    params: SolverParams = SolverParams(),
    warm=None,
    resource_names: tuple[str, ...] | None = None,
    pruning=None,
    hold_usage: bool = False,
    device=None,
) -> list[GangMove]:
    """Whole-gang re-placement WITHOUT plan_migrations' fragmentation and
    efficiency gates: the lifeboat for gangs that must move because their
    capacity is going away, or that must land on genuinely free capacity
    while their current placement still holds its slots.

    `hold_usage=True` keeps EVERY bound pod accounted, so the plan only lands
    on capacity free while the old placement still holds (what a
    make-before-break commit needs). `hold_usage=False` releases the rescue
    gangs' own usage first (a displaced gang may reuse its surviving slots):
    only safe when the old slots are already gone. Nodes build_snapshot
    masks (cordoned) are never targets. A rescue candidate is a running
    gang, so a scaled gang's base counts as scheduled even when absent from
    the batch. Returns one GangMove per gang the solver admitted and moved."""
    if not gangs or not nodes:
        return []
    kwargs = {} if resource_names is None else {"resource_names": resource_names}
    pad = next_pow2(len(nodes))
    all_bound = [p for p in pods_by_name.values() if p.is_scheduled and p.is_active]
    if hold_usage:
        bound = all_bound
    else:
        own = {r.name for g in gangs for grp in g.spec.pod_groups for r in grp.pod_references}
        bound = [p for p in all_bound if p.name not in own]
    snap = build_snapshot(nodes, topology, bound_pods=bound, pad_nodes_to=pad, **kwargs)
    subs = [s for g in gangs if (s := _whole_subgang(g, pods_by_name))]
    if not subs:
        return []
    new_bindings, _, _ = _solve_bindings(
        snap, subs, pods_by_name, params, warm, pruning, device,
        scheduled_gangs={g.base_podgang_name for g in gangs if g.base_podgang_name is not None},
    )
    moves: list[GangMove] = []
    for g in gangs:
        plan_b = new_bindings.get(g.name)
        if not plan_b:
            continue
        changed: dict[str, str] = {}
        total = 0
        for pod_name, node_name in plan_b.items():
            pod = pods_by_name.get(pod_name)
            if pod is None:
                continue
            total += 1
            if pod.node_name != node_name:
                changed[pod_name] = node_name
        if changed:
            moves.append(GangMove(gang=g.name, bindings=changed, pods_total=total))
    return moves
