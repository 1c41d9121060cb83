"""Exact reference solver: branch-and-bound gang packing on small instances
(grove_tpu/quality/exact.py counterpart, host-only numpy and Python).

The production solve is a greedy-in-batch heuristic; this is its optimality
bound on instances small enough to enumerate (<= MAX_GANGS gangs, <=
MAX_NODES nodes): an exhaustive memoized search over admission subsets and
placements that maximizes

    1. the admitted gang count (gangs are all-or-nothing on their floors),
    2. the sum of gang placement scores (0.5 + 0.5 * the mean preferred-
       domain fraction per pack-set, the best achievable per set).

Two admissible bounds prune work, never answers: an admitted-count fathom
(admitting gang i is worth at most 1 + the schedulable suffix) and a
capacity pre-check (a gang whose floor demand exceeds the remaining total
free is not enumerated).

The gang model is the production encode: every gang runs through the
port's `encode_gangs` alone, and the search reads the same dense rows
(group requests, floors, pack-set members and levels, node eligibility).
Only the floor (min_replicas per group) is placed. The enumeration order,
the state counting against `max_states` and the tie rules are the JAX
package's line for line, so an instance gives the same optimum, the same
per-gang scores and the same budget overrun; none of it runs on the card.

Out of scope, as in the JAX package: base-gang dependency chains and
replica-spread soft constraints. Exceeding the caps or the budget raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.solver.encode import encode_gangs

MAX_GANGS = 20
MAX_NODES = 32
_EPS = 1e-6


class ExactBudgetExceeded(RuntimeError):
    """The search visited more states than the budget allows — the instance
    is too large for an exact answer; shrink it rather than trust a
    truncated search."""


@dataclass
class _GangModel:
    """One gang's dense rows, host-side (from a single-gang encode)."""

    name: str
    # per group: (request vector f64 [R], floor, eligible bool [N], pod names
    # in rank order — floor-many get bound)
    groups: list
    # per pack-set: (member group indices, req_level, pref_level)
    sets: list
    schedulable: bool  # encode-level verdict (unresolvable REQUIRED key etc.)


@dataclass
class ExactResult:
    """The optimum packing of the instance."""

    admitted: tuple  # gang names, in input order
    assignments: dict  # gang -> {pod name: node name} (floor pods only)
    scores: dict  # gang -> placement score (0.5 + 0.5 * mean pref fraction)
    admitted_count: int
    mean_score: float  # over admitted gangs (0.0 when none)
    states_explored: int
    solutions: int = field(default=0)  # complete placements evaluated


def _gang_model(gang, pods_by_name, snapshot) -> _GangModel:
    """Encode one gang alone and lift its rows to plain host structures."""
    b, decode = encode_gangs([gang], pods_by_name, snapshot)
    n = snapshot.capacity.shape[0]
    mg = b.group_valid.shape[1]
    groups = []
    for k in range(mg):
        if not b.group_valid[0, k]:
            continue
        eligible = np.ones((n,), dtype=bool)
        if b.group_node_ok is not None:
            eligible = b.group_node_ok[0, k].copy()
        pod_names = [
            decode.pod_names[0][s]
            for s in range(b.pod_group.shape[1])
            if b.pod_group[0, s] == k and decode.pod_names[0][s]
        ]
        groups.append(
            (
                np.asarray(b.group_req[0, k], dtype=np.float64),
                int(b.group_required[0, k]),
                eligible,
                pod_names,
            )
        )
    sets = []
    ms = b.set_valid.shape[1]
    # encode emits groups in spec order and b.set_member indexes them the
    # same way; remap to the compacted `groups` list (invalid groups never
    # appear there — their set membership is vacuous, they place nothing).
    remap = {}
    for k in range(mg):
        if b.group_valid[0, k]:
            remap[k] = len(remap)
    for si in range(ms):
        if not b.set_valid[0, si]:
            continue
        members = [remap[k] for k in range(mg) if b.set_member[0, si, k] and k in remap]
        sets.append((members, int(b.set_req_level[0, si]), int(b.set_pref_level[0, si])))
    return _GangModel(
        name=gang.name,
        groups=groups,
        sets=sets,
        schedulable=bool(b.gang_valid[0]),
    )


def _slots(free_node: np.ndarray, req: np.ndarray) -> int:
    """Pods of `req` this node's free vector can host (identical-template
    group => slot counting is exact)."""
    pos = req > 0
    if not pos.any():
        return 1 << 20
    return int(np.floor((free_node[pos] + _EPS) / req[pos]).min())


def _enumerate_allocations(free, groups, masks, budget_box):
    """Yield complete floor allocations: per group, an i32 count vector [N].

    DFS over groups (fixed order) x nodes (index order); prunes a branch as
    soon as the remaining nodes cannot host the remaining floor.
    """
    n = free.shape[0]
    counts = [np.zeros((n,), dtype=np.int64) for _ in groups]

    def per_node_slots(gi: int, f) -> list[int]:
        req = groups[gi][0]
        return [
            _slots(f[j], req) if masks[gi][j] else 0 for j in range(n)
        ]

    def alloc_group(gi: int, f):
        if gi == len(groups):
            yield f
            return
        req, floor, _, _ = groups[gi]
        slots = per_node_slots(gi, f)
        suffix = np.cumsum(slots[::-1])[::-1]  # slots available from node j on

        def place(j: int, remaining: int, f2):
            budget_box[0] += 1
            if budget_box[0] > budget_box[1]:
                raise ExactBudgetExceeded(
                    f"exact search exceeded {budget_box[1]} states"
                )
            if remaining == 0:
                yield from alloc_group(gi + 1, f2)
                return
            if j >= n or suffix[j] < remaining:
                return  # the tail cannot host the rest of the floor
            cap = min(_slots(f2[j], req), remaining) if masks[gi][j] else 0
            for c in range(cap, -1, -1):
                counts[gi][j] = c
                f3 = f2 if c == 0 else f2.copy()
                if c:
                    f3[j] = f3[j] - c * req
                yield from place(j + 1, remaining - c, f3)
            counts[gi][j] = 0

        yield from place(0, floor, f)

    for f_done in alloc_group(0, free):
        yield [c.copy() for c in counts], f_done


def _placement_score(model: _GangModel, counts, node_domain_id) -> float:
    """podgang.go placement-score formula with the best-achievable preferred
    domain per set (>= what any committed-domain policy scores)."""
    fracs = []
    for members, _req_l, pref_l in model.sets:
        if pref_l < 0:
            continue
        if not members or not counts:
            fracs.append(1.0)  # no placeable members: vacuously local
            continue
        member_counts = np.zeros_like(counts[0])
        for gi in members:
            member_counts = member_counts + counts[gi]
        total = int(member_counts.sum())
        if total == 0:
            fracs.append(1.0)
            continue
        dom = node_domain_id[pref_l]
        best = 0
        for d in np.unique(dom[dom >= 0]):
            best = max(best, int(member_counts[dom == d].sum()))
        fracs.append(best / total)
    mean_frac = float(np.mean(fracs)) if fracs else 1.0
    return 0.5 + 0.5 * mean_frac


def exact_pack(
    gangs,
    pods_by_name,
    snapshot,
    *,
    max_states: int = 2_000_000,
) -> ExactResult:
    """Optimal (admitted count, then summed placement score) packing.

    Memoized DFS over (gang index, free-state) — distinct placement paths
    that strand identical free capacity collapse into one subproblem, which
    is what keeps <=10x16 instances tractable. Raises ValueError on
    oversized instances and ExactBudgetExceeded past `max_states`.
    """
    if len(gangs) > MAX_GANGS:
        raise ValueError(
            f"exact_pack: {len(gangs)} gangs > {MAX_GANGS} (instance too large)"
        )
    if snapshot.capacity.shape[0] > MAX_NODES:
        raise ValueError(
            f"exact_pack: {snapshot.capacity.shape[0]} nodes > {MAX_NODES} "
            "(instance too large)"
        )
    for g in gangs:
        if g.base_podgang_name is not None:
            raise ValueError(
                "exact_pack: base-gang dependency chains are out of scope"
            )

    models = [_gang_model(g, pods_by_name, snapshot) for g in gangs]
    node_domain_id = np.asarray(snapshot.node_domain_id)
    levels = node_domain_id.shape[0]
    schedulable = np.asarray(snapshot.schedulable, dtype=bool)
    free0 = np.asarray(snapshot.free, dtype=np.float64)
    free0 = np.where(schedulable[:, None], free0, 0.0)
    budget_box = [0, max_states]  # [explored, cap]
    solutions = [0]

    def placements(model: _GangModel, free):
        """Yield (counts per group, new free, score) for every distinct
        floor placement honoring required pack-sets."""
        req_sets = [s for s in model.sets if s[1] >= 0]

        def domain_choices(si: int, chosen: list):
            if si == len(req_sets):
                # Node mask per group: AND of the chosen domains of every
                # required set containing it.
                masks = []
                for gi, (_req, _floor, eligible, _names) in enumerate(model.groups):
                    mask = schedulable & eligible
                    for (members, lvl, _p), d in zip(req_sets, chosen):
                        if gi in members:
                            mask = mask & (
                                node_domain_id[min(lvl, levels - 1)] == d
                            )
                    masks.append(mask)
                for counts, f_done in _enumerate_allocations(
                    free, model.groups, masks, budget_box
                ):
                    solutions[0] += 1
                    yield counts, f_done, _placement_score(
                        model, counts, node_domain_id
                    )
                return
            members, lvl, _pref = req_sets[si]
            dom = node_domain_id[min(lvl, levels - 1)]
            for d in np.unique(dom[(dom >= 0) & schedulable]):
                yield from domain_choices(si + 1, chosen + [int(d)])

        yield from domain_choices(0, [])

    memo: dict = {}
    # Admitted-count fathom inputs: how many gangs from i on COULD still be
    # admitted (schedulable ones), and each gang's summed floor demand (the
    # capacity pre-check). Scores are <= 1.0 per gang, so the value of any
    # branch that admits gang i is bounded by (1 + suffix, 1.0 * (1 +
    # suffix)) — admissible, prunes work never answers.
    sched_suffix = [0] * (len(models) + 1)
    for i in range(len(models) - 1, -1, -1):
        sched_suffix[i] = sched_suffix[i + 1] + (1 if models[i].schedulable else 0)
    floor_demand = []
    for model in models:
        dem = np.zeros((free0.shape[1],), dtype=np.float64)
        for req, floor, _eligible, _names in model.groups:
            dem += req * floor
        floor_demand.append(dem)

    def best_from(i: int, free) -> tuple:
        """((admitted, score_sum), choice) for gangs[i:] against `free`.
        choice is None (skip gang i) or (counts, score)."""
        if i == len(models):
            return (0, 0.0), None
        key = (i, free.tobytes())
        hit = memo.get(key)
        if hit is not None:
            return hit
        # Branch A: reject gang i.
        best_v, best_c = best_from(i + 1, free)[0], None
        model = models[i]
        feasible = model.schedulable and bool(
            (free.sum(axis=0) + _EPS >= floor_demand[i]).all()
        )
        if feasible:
            ub_count = 1 + sched_suffix[i + 1]
            ub = (ub_count, float(ub_count))
            for counts, f_done, score in placements(model, free):
                sub_v, _ = best_from(i + 1, f_done)
                v = (sub_v[0] + 1, sub_v[1] + score)
                if v > best_v:
                    best_v, best_c = v, ([c.copy() for c in counts], score)
                if best_v >= ub:
                    break  # fathomed: no remaining placement can beat this
        memo[key] = (best_v, best_c)
        return memo[key]

    (admitted_count, score_sum), _ = best_from(0, free0)

    # Reconstruct the winning path from the memo.
    admitted: list = []
    assignments: dict = {}
    scores: dict = {}
    free = free0
    for i, model in enumerate(models):
        _v, choice = memo[(i, free.tobytes())]
        if choice is None:
            continue
        counts, score = choice
        admitted.append(model.name)
        scores[model.name] = score
        bindings: dict = {}
        for gi, (req, _floor, _eligible, pod_names) in enumerate(model.groups):
            rank = 0
            for j in range(free.shape[0]):
                for _ in range(int(counts[gi][j])):
                    if rank < len(pod_names):
                        bindings[pod_names[rank]] = snapshot.node_names[j]
                    rank += 1
            free = free.copy()
            free[:] = free - counts[gi][:, None].astype(np.float64) * req[None, :]
        assignments[model.name] = bindings
    return ExactResult(
        admitted=tuple(admitted),
        assignments=assignments,
        scores=scores,
        admitted_count=admitted_count,
        mean_score=(score_sum / admitted_count) if admitted_count else 0.0,
        states_explored=budget_box[0],
        solutions=solutions[0],
    )
