"""Candidate-node pruning: solve on the sub-fleet that could matter
(grove_tpu/solver/pruning.py counterpart).

1. `plan_candidates` (host numpy) cuts one wave's candidate axis: a node is a
   candidate iff it is schedulable, can host at least one pod of some valid
   group, and sits in a domain that could serve some gang's broadest
   required pack-set. The list is clipped to `max_candidates` and padded to
   a bucket (a power of two from `min_pad`, or the config's pad ladder,
   rounded up to a multiple of the mesh's node axis); the first pad row carries the full fleet's
   per-resource capacity maxima (the cap anchor), so score normalisation
   matches the dense solve.
2. `CandidatePlan` holds the gathered static node tensors, the domain ids
   remapped to compact per-level ordinals, and the batch gather
   (`gather_batch`). On the card the carry gather, the scatter back and the
   remap of `assigned` to fleet ordinals (B3) run inside the place_wave
   launch; their plain versions are in solver/reference.py.
   `stack_plans` stacks a scan chunk's plans on a leading [W] axis for
   the pruned scan (B4).
3. Each gang carries a lossy witness: True iff some excluded schedulable
   node had free capacity in a resource the gang demands. A rejected gang
   whose witness is set must be re-solved dense before the rejection stands
   (`lossy_rejections`; the drain escalates).

Plans are cut against a free state that is >= every state they are solved
against (the drain cuts against the initial snapshot: free only shrinks
while draining).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from grove_tpu_torch.parallel.mesh import mesh_divisible_pad
from grove_tpu_torch.solver.encode import GangBatch, next_pow2, stack_batches

_EPS = 1e-6


def _level_domain_free(sched_free: np.ndarray, node_domain_id: np.ndarray, lvl: int) -> np.ndarray:
    """f64 [D, R] aggregate schedulable free per domain ordinal at `lvl`
    (np.bincount per resource column, in node order)."""
    dom = node_domain_id[lvl]
    d = int(dom.max(initial=-1)) + 1
    r = sched_free.shape[1]
    acc = np.zeros((d, r), dtype=np.float64)
    if d > 0:
        valid = dom >= 0
        dv = dom[valid]
        sf = sched_free[valid]
        for j in range(r):
            acc[:, j] = np.bincount(dv, weights=sf[:, j], minlength=d)[:d]
    return acc


@dataclass
class PruneStats:
    """Pruning counters a WarmPath carries (grove_tpu/solver/pruning.py
    `PruneStats`): pruned solves, the escalation ledger and the last
    candidate axis, under the JAX package's stats() names."""

    pruned_solves: int = 0
    dense_fallbacks: int = 0  # pruning requested but not worthwhile
    escalations: int = 0  # lossy rejection -> dense re-solve
    escalations_adopted: int = 0  # dense re-solve changed a verdict
    last_candidate_nodes: int = 0
    last_candidate_pad: int = 0
    last_fleet_nodes: int = 0

    def stats(self) -> dict:
        return {
            "pruneSolves": self.pruned_solves,
            "pruneDenseFallbacks": self.dense_fallbacks,
            "pruneEscalations": self.escalations,
            "pruneEscalationsAdopted": self.escalations_adopted,
            "pruneCandidateNodes": self.last_candidate_nodes,
            "pruneCandidatePad": self.last_candidate_pad,
            "pruneFleetNodes": self.last_fleet_nodes,
        }


@dataclass(frozen=True)
class PruningConfig:
    """The `solver.pruning` config block."""

    enabled: bool = False
    # Candidate budget; the rest are clipped (clipping marks the affected
    # gangs lossy). 8191 candidates + the cap-anchor row fill the 8192 bucket.
    max_candidates: int = 8191
    # The candidate buckets; () = every power of two from `min_pad` up.
    pad_ladder: tuple = ()
    # Smallest candidate bucket without a ladder.
    min_pad: int = 64
    # Fleets below this many nodes never prune.
    min_fleet: int = 256


class PlanTensors(NamedTuple):
    """A plan's static node tensors on one device."""

    cand_idx: torch.Tensor  # i32 [pad] fleet row per candidate; pad rows = fleet size
    capacity: torch.Tensor  # f32 [pad, R]
    schedulable: torch.Tensor  # bool [pad]
    node_domain_id: torch.Tensor  # i32 [L, pad]
    domains: object  # kernels.place_wave.DomainIndex on the card, else None


@dataclass
class CandidatePlan:
    """One batch's candidate axis: gather map, remapped topology, pruned
    static node tensors, and the per-gang lossy witness."""

    idx: np.ndarray  # i32 [count] fleet ordinals of the candidates
    count: int
    pad: int  # candidate bucket (> count; one row is the cap anchor)
    fleet_pad: int  # the dense node axis this plan was cut from
    clipped: bool  # candidate budget truncated the eligible set
    gang_lossy: np.ndarray  # bool [G] prune could have cost this gang
    capacity: np.ndarray  # f32 [pad, R] gathered + cap-anchor pad row
    schedulable: np.ndarray  # bool [pad]
    node_domain_id: np.ndarray  # i32 [L, pad] remapped compact ordinals
    num_domains: np.ndarray  # i32 [L] domain count per level on the sub-fleet
    # per level: original ordinal -> remapped ordinal (pin translation)
    _remap: list = field(default_factory=list)
    _tensors: dict = field(default_factory=dict, repr=False, compare=False)

    def padded_idx(self) -> np.ndarray:
        """[pad] gather/scatter map; pad rows point past the fleet axis so
        gathers read 0 and scatters drop."""
        out = np.full((self.pad,), self.fleet_pad, dtype=np.int32)
        out[: self.count] = self.idx
        return out

    def tensors(self, device) -> PlanTensors:
        """The static node tensors on `device`, uploaded once per plan and
        without blocking (with the domain index the kernel sums over, on the
        card)."""
        from grove_tpu_torch.solver.core import to_device

        device = torch.device(device)
        key = str(device)
        if key not in self._tensors:
            domains = None
            if device.type == "cuda":
                from grove_tpu_torch.kernels.place_wave import domain_index

                domains = domain_index(self.node_domain_id, device)
            self._tensors[key] = PlanTensors(
                *(to_device(x, device) for x in (
                    self.padded_idx(), self.capacity, self.schedulable, self.node_domain_id
                )),
                domains,
            )
        return self._tensors[key]

    def gather_free(self, free: np.ndarray) -> np.ndarray:
        """Fleet free [N, R] -> candidate free [pad, R] on the host (pad rows
        zero): the sweep's gathered stacked solve."""
        out = np.zeros((self.pad, free.shape[1]), dtype=np.float32)
        out[: self.count] = free[self.idx]
        return out

    def remap_assigned(self, assigned: np.ndarray) -> np.ndarray:
        """Candidate ordinals -> fleet ordinals on the host (-1 stays)."""
        safe = np.clip(assigned, 0, self.count - 1)
        return np.where(assigned >= 0, self.idx[safe], -1)

    def gather_batch(self, batch: GangBatch) -> GangBatch:
        """Gather the batch's node-axis fields onto the candidate axis and
        translate pack-set pins to the remapped domain ordinals."""
        reuse = batch.reuse_nodes
        node_ok = batch.group_node_ok
        avoid = batch.spread_avoid
        if reuse is not None:
            reuse = self._gather_bool_axis(np.asarray(reuse))
        if node_ok is not None:
            node_ok = self._gather_bool_axis(np.asarray(node_ok))
        if avoid is not None:
            avoid = self._gather_bool_axis(np.asarray(avoid))
        pinned = np.asarray(batch.set_pinned)
        if (pinned >= 0).any():
            pinned = self._remap_pins(pinned, np.asarray(batch.set_req_level))
        return batch._replace(
            reuse_nodes=reuse, group_node_ok=node_ok, spread_avoid=avoid, set_pinned=pinned
        )

    def _gather_bool_axis(self, arr: np.ndarray) -> np.ndarray:
        out = np.zeros(arr.shape[:-1] + (self.pad,), dtype=bool)
        out[..., : self.count] = arr[..., self.idx]
        return out

    def _remap_pins(self, pinned: np.ndarray, req_level: np.ndarray) -> np.ndarray:
        """Fleet domain ordinals -> candidate ordinals; a pinned domain with
        no candidate node maps to `count` (matches nothing: the pin fails
        closed, and the gang is already lossy)."""
        out = np.array(pinned, copy=True)
        for gi, si in zip(*np.nonzero(pinned >= 0)):
            lvl = int(req_level[gi, si])
            if 0 <= lvl < len(self._remap):
                out[gi, si] = self._remap[lvl].get(int(pinned[gi, si]), self.count)
        return out


class StackedPlans(NamedTuple):
    """A scan chunk's plans on a leading [W] axis, on one device."""

    cand_idx: torch.Tensor  # i32 [W, pad] each plan's padded_idx
    capacity: torch.Tensor  # f32 [W, pad, R]
    schedulable: torch.Tensor  # bool [W, pad]
    node_domain_id: torch.Tensor  # i32 [W, L, pad]
    batch: GangBatch  # each wave's batch gathered onto its candidate axis, [W, ...]
    domains: object  # kernels.place_wave.DomainIndex with [W, ...] fields on the card, else None


def stack_plan_arrays(plans: list, batches: list, pad_to: int | None = None) -> tuple:
    """A scan chunk's plans (same pad, same fleet) and their gathered
    batches stacked on a leading [W] axis in host memory: (cand_idx,
    capacity, schedulable, node_domain_id, batch). `pad_to` appends null
    waves up to that many steps (drain.py `_solve_scan_chunk`): every
    gather-map slot past the fleet (gathers read 0, scatters drop), zero
    node tensors and an all-zero batch, so the step admits nothing and the
    carry passes through."""
    idx = [p.padded_idx() for p in plans]
    cap = [np.asarray(p.capacity, np.float32) for p in plans]
    sched = [np.asarray(p.schedulable, bool) for p in plans]
    ndid = [np.asarray(p.node_domain_id, np.int32) for p in plans]
    gathered = [p.gather_batch(b) for p, b in zip(plans, batches)]
    extra = 0 if pad_to is None else max(0, pad_to - len(plans))
    if extra:
        idx += [np.full_like(idx[0], plans[0].fleet_pad)] * extra
        cap += [np.zeros_like(cap[0])] * extra
        sched += [np.zeros_like(sched[0])] * extra
        ndid += [np.zeros_like(ndid[0])] * extra
    return (np.stack(idx), np.stack(cap), np.stack(sched), np.stack(ndid),
            stack_batches(gathered, pad_to=pad_to))


def stack_plans(plans: list, batches: list, device, pad_to: int | None = None) -> StackedPlans:
    """stack_plan_arrays, each array uploaded once without blocking; on the
    card the stacked DomainIndex comes along."""
    from grove_tpu_torch.solver.core import batch_to, to_device

    device = torch.device(device)
    *host, gathered = stack_plan_arrays(plans, batches, pad_to)
    domains = None
    if device.type == "cuda":
        from grove_tpu_torch.kernels.place_wave import domain_index_stacked

        domains = domain_index_stacked(host[3], device)
    return StackedPlans(*(to_device(x, device) for x in host), batch_to(gathered, device),
                        domains)


def candidate_pad(count: int, cfg: PruningConfig, mesh_axis: int = 1) -> Optional[int]:
    """Smallest bucket holding `count` candidates plus the cap-anchor row:
    the first fitting entry of the pad ladder (None when none fits), or
    without a ladder the power of two >= min_pad; rounded up to a multiple
    of `mesh_axis`, a sharded solve's node-axis device count."""
    need = count + 1
    if cfg.pad_ladder:
        for v in sorted(int(x) for x in cfg.pad_ladder):
            if v >= need:
                return mesh_divisible_pad(v, mesh_axis)
        return None
    return mesh_divisible_pad(next_pow2(max(need, cfg.min_pad)), mesh_axis)


def _eligible_nodes(free, schedulable, batch: GangBatch) -> tuple[np.ndarray, bool]:
    """(eligible mask [N], any_zero_request): a node is eligible iff it can
    host >= 1 pod of some valid group. A valid group with no positive
    request can land anywhere, which disables the capacity prune."""
    gv = np.asarray(batch.gang_valid)[:, None] & np.asarray(batch.group_valid)
    reqs = np.asarray(batch.group_req)[gv]  # [K, R]
    if reqs.size == 0:
        return np.asarray(schedulable, bool).copy(), False
    reqs = np.unique(reqs, axis=0)
    if (reqs <= 0).all(axis=1).any():
        return np.asarray(schedulable, bool).copy(), True
    fits = ((free[None, :, :] + _EPS >= reqs[:, None, :]) | (reqs[:, None, :] <= 0)).all(axis=-1)
    return np.asarray(schedulable, bool) & fits.any(axis=0), False


def _domain_useful(free, schedulable, node_domain_id, batch: GangBatch) -> np.ndarray:
    """Useful-by-domain mask [N]: a node passes iff
    some valid gang's broadest required pack-set could be served by the
    node's domain at that set's level (aggregate schedulable free >= the
    set's member floor demand; a pinned set only accepts its pinned domain).
    A valid gang with no resolvable required set disables the filter."""
    g, _ = np.asarray(batch.set_valid).shape
    n = free.shape[0]
    gang_valid = np.asarray(batch.gang_valid)
    set_valid = np.asarray(batch.set_valid)
    set_req = np.asarray(batch.set_req_level)
    set_pin = np.asarray(batch.set_pinned)
    set_member = np.asarray(batch.set_member)
    group_req = np.asarray(batch.group_req)
    group_required = np.asarray(batch.group_required)
    group_valid = np.asarray(batch.group_valid)
    levels = node_domain_id.shape[0]

    resolvable = set_valid & (set_req >= 0) & (set_req < levels)  # [G, MS]
    has_req = resolvable.any(axis=1)
    if bool((gang_valid & ~has_req).any()):
        return np.ones((n,), dtype=bool)
    active = gang_valid & has_req
    if not bool(active.any()):
        return np.ones((n,), dtype=bool)

    # Broadest required set per gang: the first set of the lowest level.
    rows = np.arange(g)
    keyed = np.where(resolvable, set_req, levels + 1)
    si_sel = np.argmin(keyed, axis=1)
    lvl_sel = keyed[rows, si_sel]
    members = set_member[rows, si_sel] & group_valid  # [G, MG]
    weights = (group_required * members).astype(np.float64)
    demand = (group_req * weights[:, :, None]).sum(axis=1)  # [G, R] f64
    pins = set_pin[rows, si_sel]

    sched_free = np.where(schedulable[:, None], np.maximum(free, 0.0), 0.0)
    useful = np.zeros((n,), dtype=bool)
    for lvl in np.unique(lvl_sel[active]).tolist():
        lvl = int(lvl)
        df = _level_domain_free(sched_free, node_domain_id, lvl)  # [D, R]
        d = df.shape[0]
        sel = active & (lvl_sel == lvl)
        uniq_dem, inv = np.unique(demand[sel], axis=0, return_inverse=True)
        ok_ud = (df[None, :, :] + _EPS >= uniq_dem[:, None, :]).all(axis=-1)  # [K, D]
        ok_gd = ok_ud[inv.reshape(-1)]  # [G_l, D]
        p = pins[sel]
        pinned = p >= 0
        if bool(pinned.any()):
            cols = np.arange(d)
            ok_gd = np.where(pinned[:, None], ok_gd & (cols[None, :] == p[:, None]), ok_gd)
        dom_ok = ok_gd.any(axis=0)
        dom = node_domain_id[lvl]
        valid = dom >= 0
        hit = np.zeros((n,), dtype=bool)
        hit[valid] = dom_ok[np.clip(dom[valid], 0, max(d - 1, 0))]
        useful |= hit
    return useful


def plan_candidates(snapshot, batch: GangBatch, cfg: PruningConfig,
                    mesh_axis: int = 1) -> Optional[CandidatePlan]:
    """Cut the candidate axis for one batch against `snapshot`'s free state;
    `mesh_axis` as candidate_pad.

    None when pruning is not worthwhile: fleet below `min_fleet`, no valid
    gang, no candidate, no ladder entry that fits, or a bucket not smaller
    than the fleet axis."""
    free = np.asarray(snapshot.free, dtype=np.float32)
    schedulable = np.asarray(snapshot.schedulable, dtype=bool)
    node_domain_id = np.asarray(snapshot.node_domain_id)
    n = free.shape[0]
    if n < cfg.min_fleet:
        return None
    gang_valid = np.asarray(batch.gang_valid)
    if not gang_valid.any():
        return None

    eligible, zero_req = _eligible_nodes(free, schedulable, batch)
    dom_useful = _domain_useful(free, schedulable, node_domain_id, batch)
    cand = np.flatnonzero(eligible & dom_useful)
    clipped = False
    budget = max(1, int(cfg.max_candidates))
    if cand.shape[0] > budget:
        cand = cand[:budget]
        clipped = True
    count = int(cand.shape[0])
    if count == 0:
        return None
    pad = candidate_pad(count, cfg, mesh_axis)
    if pad is None or pad >= n:
        return None

    # Lossy witness: an excluded schedulable node with free capacity in a
    # resource the gang demands could have changed the dense solve.
    kept = np.zeros((n,), dtype=bool)
    kept[cand] = True
    excluded = schedulable & ~kept
    lossy_by_res = ((free > _EPS) & excluded[:, None]).any(axis=0)  # [R]
    gv = gang_valid[:, None] & np.asarray(batch.group_valid)  # [G, MG]
    gang_demands = ((np.asarray(batch.group_req) > 0) & gv[:, :, None]).any(axis=1)  # [G, R]
    gang_lossy = (gang_demands & lossy_by_res[None, :]).any(axis=-1)
    if zero_req and excluded.any():
        gang_lossy = gang_lossy | gv.any(axis=1)
    gang_lossy = gang_lossy & gang_valid
    return _assemble_plan(snapshot, cand, pad, clipped, gang_lossy)


def _assemble_plan(snapshot, cand: np.ndarray, pad: int, clipped: bool, gang_lossy) -> CandidatePlan:
    """The gathered static tensors and the compact domain remap for a fixed
    candidate list. The host level (last) keeps ordinal == row index."""
    node_domain_id = np.asarray(snapshot.node_domain_id)
    schedulable = np.asarray(snapshot.schedulable, dtype=bool)
    n = int(np.asarray(snapshot.capacity).shape[0])
    count = int(cand.shape[0])
    levels = node_domain_id.shape[0]
    ndid_p = np.full((levels, pad), -1, dtype=np.int32)
    num_domains = np.zeros((levels,), dtype=np.int32)
    remap: list[dict] = []
    for li in range(levels):
        ids = node_domain_id[li, cand]
        if li == levels - 1:
            rows = np.arange(count, dtype=np.int32)
            ndid_p[li, :count] = np.where(ids >= 0, rows, -1)
            num_domains[li] = int((ids >= 0).sum())
            remap.append({})
            continue
        uniq = np.unique(ids[ids >= 0])
        table = {int(v): i for i, v in enumerate(uniq.tolist())}
        ndid_p[li, :count] = np.where(ids >= 0, np.searchsorted(uniq, np.clip(ids, 0, None)), -1)
        num_domains[li] = len(table)
        remap.append(table)

    cap = np.asarray(snapshot.capacity, dtype=np.float32)
    cap_p = np.zeros((pad, cap.shape[1]), dtype=np.float32)
    cap_p[:count] = cap[cand]
    cap_p[count] = cap.max(axis=0)  # cap anchor: unschedulable, zero free
    sched_p = np.zeros((pad,), dtype=bool)
    sched_p[:count] = schedulable[cand]
    return CandidatePlan(
        idx=cand.astype(np.int32),
        count=count,
        pad=pad,
        fleet_pad=n,
        clipped=clipped,
        gang_lossy=gang_lossy,
        capacity=cap_p,
        schedulable=sched_p,
        node_domain_id=ndid_p,
        num_domains=num_domains,
        _remap=remap,
    )


def plan_from_indices(snapshot, indices, cfg: PruningConfig, n_gangs: int,
                      mesh_axis: int = 1) -> CandidatePlan:
    """Rebuild a plan from a journaled candidate list (trace/replay.py): a
    live plan is cut against a free state the wave record does not carry,
    so replay gathers the recorded list. The lossy witness is all-False (the
    recorded verdicts already absorbed any escalation). `mesh_axis` is the
    recorded mesh's node axis, so the pad equals the recorded solve's."""
    cand = np.asarray(indices, dtype=np.int32)
    pad = candidate_pad(int(cand.shape[0]), cfg, mesh_axis)
    if pad is None:
        raise ValueError(
            f"recorded candidate list ({cand.shape[0]} nodes) does not fit "
            f"the recorded pad ladder {cfg.pad_ladder!r}"
        )
    return _assemble_plan(snapshot, cand, pad, False, np.zeros((n_gangs,), dtype=bool))


def lossy_rejections(plan: CandidatePlan, gang_valid, ok) -> np.ndarray:
    """bool [G]: gangs whose pruned rejection requires a dense re-solve."""
    return np.asarray(gang_valid, bool) & ~np.asarray(ok, bool) & plan.gang_lossy
