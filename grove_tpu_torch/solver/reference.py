"""Plain PyTorch versions of the per-wave gang solve (B1), the cross-wave
verdict gating (B2) and the candidate-axis gather/scatter/remap around a
pruned solve (B3).

They compute what `grove_tpu/solver/core.py` computes — `_place_gang`,
`solve_batch_impl`, `_apply_global_deps`, `_scatter_global_ok` — over the
same inputs and layout, op for op:

  - each `lax.scan` is a Python loop, with no data-dependent Python control
    flow (every branch is a `torch.where`);
  - `segment_sum` is `index_add_` over the node axis, made on the host, where
    it adds each domain's nodes one after another in node order (CUDA's
    index_add_ adds with atomics in no fixed order). On the card that costs
    a round trip per domain sum: this is the yardstick, not the main path;
  - `lax.top_k` is a stable sort of the negated score (lower index first on
    ties, as `lax.top_k` orders them);
  - short reductions over the resource and pack-set axes are summed in index
    order, as the CUDA kernel sums them;
  - B3 (grove_tpu/solver/pruning.py `CandidatePlan.gather_free` /
    `scatter_free` / `remap_assigned`) is torch index ops around the solve;
  - B5 (core.py `stacked_solve_batch_impl`, parallel/portfolio.py
    `_objective` / `portfolio_solve_batch`) is a loop over the weight rows,
    and the winner's quality sum adds in XLA's CPU order (`xla_sum_ref`);
  - B4 (core.py `scan_solve_fn` / `scan_pruned_solve_fn`) is a loop over
    the leading wave axis that threads (free, ok_global) from step to step.
  - B6 (core.py `stacked_scan_solve_fn`) is a loop over the leading wave
    axis of B5, each step from its own recorded free, with no carry.
  - B7 (core.py `sharded_solve_fn` under a parallel/mesh.py SolveLayout) is
    B1 over row spans (`sharded_solve_ref`): every domain sum is the
    shards' partials, each in node order, added in shard order, and stage
    2's top-k merges the shards' own best candidates by (score desc, node
    asc) — the order kernel B7 adds and merges in.

The CPU tests hold these against the JAX package, and `chip_smoke.py` holds
the CUDA kernel (`grove_tpu_torch/kernels/place_wave.py`) against them on the
card. Nothing on the main path calls them when a card is present.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from grove_tpu_torch.solver.encode import GangBatch

SLOT_CAP = 1 << 20  # slots for a zero-request group (effectively unbounded)
_EPS = 1e-6
_F32 = torch.float32


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (a fixed order, not a tree)."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _domain_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-domain sums of `values` [N, C], each domain's nodes added in node
    order; unlabeled nodes (seg == n) spill into a dropped padding row. Rows
    >= the level's domain count stay 0."""
    out = torch.zeros((n + 1, values.shape[1]), dtype=values.dtype)
    out.index_add_(0, seg.cpu(), values.cpu())
    return out[:n].to(values.device)


def _domain_sum_sharded(values: torch.Tensor, seg: torch.Tensor, n: int, spans) -> torch.Tensor:
    """_domain_sum over a node axis split into row `spans` (B7): each shard
    sums its own rows per domain in node order into a partial, then the
    partials are added in shard order, as every shard of kernel B7 adds the
    exchanged partials. Equal to _domain_sum where the partial sums are
    exact in f32."""
    # One index_add_ on the host for every shard: shard s's rows land in its
    # own block of n + 1 rows (the last its unlabeled spill), each node added
    # in node order, as _domain_sum adds them.
    shard = torch.zeros(seg.shape[0], dtype=torch.long)
    for s, (lo, hi) in enumerate(spans):
        shard[lo:hi] = s
    out = torch.zeros((len(spans) * (n + 1), values.shape[1]), dtype=values.dtype)
    out.index_add_(0, seg.cpu() + shard * (n + 1), values.cpu())
    parts = out.view(len(spans), n + 1, values.shape[1])[:, :n]
    total = parts[0]
    for s in range(1, len(spans)):
        total = total + parts[s]
    return total.to(values.device)


def _top_k_merged(masked_score: torch.Tensor, k: int, spans):
    """(order, score) of the k best nodes by (score desc, node asc): each
    shard's own best k, then the shards' lists merged under the same key
    (B7's stage-2 exchange). Equal to one stable sort of the whole axis."""
    scores, order = [], []
    for lo, hi in spans:
        neg, idx = torch.sort(-masked_score[lo:hi], stable=True)
        kk = min(hi - lo, k)
        scores.append(-neg[:kk])
        order.append(idx[:kk] + lo)
    cand_s, cand_i = torch.cat(scores), torch.cat(order)
    # Lists concatenated in shard order: a stable sort keeps the lower node
    # first among equal scores.
    neg, pick = torch.sort(-cand_s, stable=True)
    return cand_i[pick[:k]], -neg[:k]


def group_slots_ref(free: torch.Tensor, group_req: torch.Tensor) -> torch.Tensor:
    """Per-node pod capacity for each group's request vector.

    free [N,R], group_req [MG,R] -> i32 [MG,N] (core.py `_group_slots`)."""
    dev = free.device
    eps = torch.tensor(_EPS, dtype=_F32, device=dev)
    tiny = torch.tensor(1e-9, dtype=_F32, device=dev)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    pos = group_req > 0
    ratio = torch.floor((free[None, :, :] + eps) / torch.maximum(group_req[:, None, :], tiny))
    ratio = torch.where(pos[:, None, :], ratio, inf)
    slots = ratio.amin(dim=-1)
    slots = torch.where(torch.isinf(slots), torch.tensor(float(SLOT_CAP), device=dev), slots)
    return slots.clamp(0, SLOT_CAP).to(torch.int32)


def place_gang_ref(
    free,
    used_carry,
    gang: dict,
    *,
    schedulable,
    node_domain_id,
    cap_scale,
    params,
    spread_avoid=None,
    spans=None,
):
    """Place one gang against `free` (core.py `_place_gang`). `spans` (row
    spans of a SolveLayout) sums the domains and merges the stage-2 top-k
    shard by shard, as kernel B7 does.

    Returns (free_out [N,R], assigned i32 [MP], gang_ok bool [], score f32 [])."""
    dev = free.device
    n, r = free.shape
    levels = node_domain_id.shape[0]
    eps = torch.tensor(_EPS, dtype=_F32, device=dev)
    inf = torch.tensor(float("inf"), dtype=_F32, device=dev)
    ninf = -inf
    zero = torch.zeros((), dtype=_F32, device=dev)
    one = torch.ones((), dtype=_F32, device=dev)
    w_tight, w_pref, w_reuse, w_reserve, w_spread = (
        torch.tensor(float(getattr(params, k)), dtype=_F32, device=dev)
        for k in ("w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread")
    )
    group_req = gang["group_req"]  # [MG, R]
    group_total = gang["group_total"]  # [MG]
    group_required = gang["group_required"]  # [MG]
    group_valid = gang["group_valid"]  # [MG]
    set_member = gang["set_member"]  # [MS, MG]
    set_req_level = gang["set_req_level"]  # [MS]
    set_pref_level = gang["set_pref_level"]  # [MS]
    set_valid = gang["set_valid"]  # [MS]
    set_pinned = gang["set_pinned"]  # [MS]
    mg = group_req.shape[0]
    ms = set_member.shape[0]
    mp_bound = gang["pod_group"].shape[0]

    dom_all = node_domain_id  # [L, N]
    seg_all = torch.where(dom_all >= 0, dom_all, n).long()  # [L, N]

    def lvl_clip(level):
        return level.clamp(0, levels - 1).long()

    def agg(vals, level):
        if spans is not None:
            return _domain_sum_sharded(vals, seg_all[lvl_clip(level)], n, spans)
        return _domain_sum(vals, seg_all[lvl_clip(level)], n)

    slots_all = group_slots_ref(free, group_req)  # [MG, N]
    eligible = gang.get("group_node_ok")  # bool [MG, N] or None
    if eligible is not None:
        slots_all = torch.where(eligible, slots_all, 0)
    feat = torch.cat(
        [free, slots_all.T.to(_F32), torch.ones((n, 1), dtype=_F32, device=dev)], dim=1
    )

    def joint_slots_ok(dom_slots, members):
        membersf = members.to(_F32)
        any_member = members.any()
        req_lo = torch.where(members[:, None], group_req, inf).amin(dim=0)
        req_hi = torch.where(members[:, None], group_req, ninf).amax(dim=0)
        homogeneous = any_member & ((req_hi - req_lo) <= eps).all()
        joint_need = _seq_sum(group_required.to(_F32) * membersf)
        min_slots = torch.where(members[None, :], dom_slots, inf).amin(dim=-1)
        return torch.where(homogeneous, min_slots >= joint_need, True)

    def dom_tables(ok_nodes, level):
        table = agg(torch.where(ok_nodes[:, None], feat, zero), level)
        return table[:, :r], table[:, r : r + mg], table[:, r + mg]

    def demand_of(members):
        # [R]: summed over groups in index order.
        return _seq_sum((group_req * (group_required * members).to(_F32)[:, None]).T)

    tables_l = torch.stack(
        [
            agg(torch.where(schedulable[:, None], feat, zero), torch.tensor(lv, device=dev))
            for lv in range(levels)
        ]
    )  # [L, N, C]

    spread_pen = None
    if spread_avoid is not None:
        s_lvl = gang["spread_level"]
        lvl_c = lvl_clip(s_lvl)
        used_cnt = agg(spread_avoid[:, None].to(_F32), lvl_c)[:, 0]
        s_dom = dom_all[lvl_c]
        spread_pen = torch.where(
            (s_lvl >= 0) & (s_dom >= 0),
            used_cnt[s_dom.clamp(0, n - 1).long()] > 0.5,
            False,
        ).to(_F32)

    def set_dom_feasible(s2):
        member2 = set_member[s2] & group_valid
        demand2 = demand_of(member2)
        t2 = tables_l[lvl_clip(set_req_level[s2])]
        return (
            (t2[:, :r] >= demand2[None, :] - eps).all(dim=-1)
            & ((t2[:, r : r + mg] >= group_required[None, :]) | ~member2[None, :]).all(dim=-1)
            & joint_slots_ok(t2[:, r : r + mg], member2)
        )

    feas2_all = torch.stack([set_dom_feasible(s2) for s2 in range(ms)])  # [MS, N]
    dom_req_all = dom_all[lvl_clip(set_req_level)]  # [MS, N]
    dom_pref_all = dom_all[lvl_clip(set_pref_level)]  # [MS, N]
    node_feas2_all = torch.where(
        dom_req_all >= 0,
        torch.gather(feas2_all, 1, dom_req_all.clamp(0, n - 1).long()),
        False,
    )  # [MS, N]

    # ---- Stage 1: commit a domain per pack-set, broadest first --------------
    committed_req = torch.full((ms,), -1, dtype=torch.int32, device=dev)
    committed_pref = torch.full((ms,), -1, dtype=torch.int32, device=dev)
    set_fail = torch.zeros((), dtype=torch.bool, device=dev)
    for s in range(ms):
        member = set_member[s]
        req_level = set_req_level[s]
        pref_level = set_pref_level[s]
        active = set_valid[s]
        overlap = (set_member & member[None, :]).any(dim=-1)  # [MS]
        masks = torch.where(
            ((committed_req >= 0) & overlap)[:, None],
            dom_req_all == committed_req[:, None],
            True,
        )
        node_ok = schedulable & masks.all(dim=0)
        memberf = member & group_valid
        demand = demand_of(memberf)
        taken_node = (
            (set_valid & ~overlap & (committed_req >= 0))[:, None]
            & (dom_req_all == committed_req[:, None])
        ).any(dim=0)  # [N]

        def nested_feasible(level, ok_nodes):
            active2 = set_valid & (set_req_level > level) & overlap
            witness = (node_feas2_all & ok_nodes[None, :]).to(_F32)
            nested_cnt = agg(witness.T.contiguous(), level)  # [N_dom, MS]
            return ((nested_cnt > 0.5) | ~active2[None, :]).all(dim=-1)

        def pick_domain(level, extra_node_mask, check_nested=False):
            ok_nodes = node_ok & extra_node_mask
            dom_free, dom_slots, dom_count = dom_tables(ok_nodes, level)
            feas_cap = (dom_free >= demand[None, :] - eps).all(dim=-1)
            feas_slots = ((dom_slots >= group_required[None, :]) | ~memberf[None, :]).all(dim=-1)
            feasible = feas_cap & feas_slots & joint_slots_ok(dom_slots, memberf) & (dom_count > 0)
            if check_nested:
                feasible = feasible & nested_feasible(level, ok_nodes)
            taken_frac = agg(
                torch.where(ok_nodes & taken_node, one, zero)[:, None], level
            )[:, 0] / torch.clamp_min(dom_count, 1.0)
            norm_free = _seq_sum(dom_free / cap_scale[None, :])
            score = torch.where(feasible, -norm_free - w_reserve * taken_frac, ninf)
            if spread_pen is not None:
                touched = agg(torch.where(ok_nodes, spread_pen, zero)[:, None], level)[:, 0] > 0.5
                big = float(n * r) + w_reserve + 2.0
                score = score - torch.where(w_spread > 0, big, zero) * touched.to(_F32)
            return torch.argmax(score).to(torch.int32), feasible.any()

        req_dom = dom_all[lvl_clip(req_level)]
        pinned = set_pinned[s]
        pin_mask = torch.where(pinned >= 0, req_dom == pinned, True)
        has_req = active & (req_level >= 0)
        req_choice, req_any = pick_domain(req_level, pin_mask, check_nested=True)
        new_req = torch.where(has_req & req_any, req_choice, -1).to(torch.int32)
        set_fail = set_fail | (has_req & ~req_any)
        inside_req = torch.where(new_req >= 0, req_dom == new_req, True)
        has_pref = active & (pref_level >= 0)
        pref_choice, pref_any = pick_domain(pref_level, inside_req)
        new_pref = torch.where(has_pref & pref_any, pref_choice, -1).to(torch.int32)
        committed_req = committed_req.clone()
        committed_req[s] = new_req
        committed_pref = committed_pref.clone()
        committed_pref[s] = new_pref

    # ---- Stage 2: allocate counts per group, floors first, then extras -----
    order = gang["group_order"].long()  # [MG]
    free_g = free
    used = used_carry
    groups_ok = torch.ones((), dtype=torch.bool, device=dev)
    k = min(n, mp_bound)
    phase_counts = []
    for t in range(2 * mg):
        g = order[t % mg]
        phase = t // mg
        valid = group_valid[g]
        req = group_req[g]
        if phase == 0:
            total = group_required[g]
            required = group_required[g]
        else:
            total = group_total[g] - group_required[g]
            required = torch.zeros((), dtype=torch.int32, device=dev)
        member_g = set_member[:, g]  # [MS]
        masks = torch.where(
            (member_g & (committed_req >= 0))[:, None],
            dom_req_all == committed_req[:, None],
            True,
        )
        node_ok = schedulable & masks.all(dim=0)
        if eligible is not None:
            node_ok = node_ok & eligible[g]
        slots = group_slots_ref(free_g, req[None, :])[0]
        slots = torch.where(node_ok, torch.minimum(slots, total), 0)
        pref_bonus = (
            ((member_g & (committed_pref >= 0))[:, None] & (dom_pref_all == committed_pref[:, None]))
            .to(_F32)
            .sum(dim=0)
        )
        reserved = (
            ((~member_g & (committed_req >= 0))[:, None] & (dom_req_all == committed_req[:, None]))
            .to(_F32)
            .sum(dim=0)
        )
        norm_free = _seq_sum(free_g / cap_scale[None, :]) / float(r)
        score = (
            w_pref * pref_bonus
            + w_reuse * used.to(_F32)
            - w_tight * norm_free
            - w_reserve * reserved
        )
        if spread_pen is not None:
            score = score - w_spread * spread_pen
        masked_score = torch.where(slots > 0, score, ninf)
        if spans is not None:
            top_order, top_score = _top_k_merged(masked_score, k, spans)
        else:
            neg_sorted, idx = torch.sort(-masked_score, stable=True)
            top_order = idx[:k]
            top_score = -neg_sorted[:k]
        slots_top = torch.where(torch.isfinite(top_score), slots[top_order], 0)
        csum = torch.cumsum(slots_top, dim=0, dtype=torch.int32)
        take_top = torch.minimum(torch.clamp_min(total - (csum - slots_top), 0), slots_top)
        counts = torch.zeros((n,), dtype=torch.int32, device=dev).scatter(0, top_order, take_top)
        counts = torch.where(valid, counts, 0)
        placed = counts.sum()
        groups_ok = groups_ok & ((placed >= required) | ~valid)
        free_g = free_g - counts.to(_F32)[:, None] * req[None, :]
        used = used | (counts > 0)
        phase_counts.append(counts)

    counts = torch.zeros((mg, n), dtype=torch.int32, device=dev)
    counts = counts.index_copy(0, order, torch.stack(phase_counts[:mg]))
    counts = counts.index_add(0, order, torch.stack(phase_counts[mg:]))

    gang_ok = gang["gang_valid"] & groups_ok & ~set_fail

    # ---- Stage 3: counts -> per-pod node assignment --------------------------
    ccum = torch.cumsum(counts, dim=1)  # [MG, N] (int64)
    placed_per_group = counts.sum(dim=1)  # [MG]
    pod_group = gang["pod_group"]
    pod_rank = gang["pod_rank"]
    gidx = pod_group.clamp(0, mg - 1).long()
    idx = torch.searchsorted(ccum[gidx], pod_rank.long()[:, None], right=True)[:, 0]
    live = (pod_group >= 0) & (pod_rank < placed_per_group[gidx]) & gang_ok
    assigned = torch.where(live, idx, -1).to(torch.int32)

    # ---- Stage 4: placement quality (1.0 = optimal) --------------------------
    in_dom = (dom_pref_all == committed_pref[:, None]).to(_F32)  # [MS, N]
    memb = set_member.to(_F32)  # [MS, MG]
    cnt = counts.to(_F32)[None, :, :] * memb[:, :, None]  # [MS, MG, N]
    tot = cnt.sum(dim=(1, 2))
    hits = (cnt * in_dom[:, None, :]).sum(dim=(1, 2))
    frac = torch.where(tot > 0, hits / torch.clamp_min(tot, 1.0), one)
    active = set_pref_level >= 0
    fracs = torch.where(active & (committed_pref >= 0), frac, torch.where(active, zero, one))
    has_pref = set_valid & active
    mean_frac = torch.where(
        has_pref.any(),
        _seq_sum(torch.where(has_pref, fracs, zero)) / torch.clamp_min(has_pref.sum(), 1),
        one,
    )
    placement_score = torch.where(gang_ok, 0.5 + 0.5 * mean_frac, zero)

    free_out = torch.where(gang_ok, free_g, free)
    return free_out, assigned, gang_ok, placement_score


def apply_global_deps_ref(batch: GangBatch, ok_global):
    """gang_valid with cross-batch base-gang verdicts folded in (B2)."""
    if ok_global is None:
        return batch.gang_valid
    t = ok_global.shape[0]
    dg = batch.depends_global
    ext_ok = torch.where(dg >= 0, ok_global[dg.clamp(0, t - 1).long()], True)
    return batch.gang_valid & ext_ok


def scatter_global_ok_ref(batch: GangBatch, ok, ok_global):
    """Write this batch's verdicts into the global bitmap at global_index
    (scatter-max, B2)."""
    if ok_global is None:
        return None
    t = ok_global.shape[0]
    gidx = batch.global_index
    src = (ok & (gidx >= 0)).to(torch.uint8)
    out = ok_global.to(torch.uint8).scatter_reduce(
        0, gidx.clamp(0, t - 1).long(), src, reduce="amax"
    )
    return out.to(torch.bool)


def solve_batch_ref(
    free0, capacity, schedulable, node_domain_id, batch: GangBatch, params, ok_global=None,
    spans=None,
):
    """Sequentially commit every gang of the batch (core.py
    `solve_batch_impl`); `batch` holds tensors on free0's device. `spans`
    solves it node-sharded (sharded_solve_ref).

    Returns (assigned i32 [G, MP], ok bool [G], score f32 [G],
    free_after f32 [N, R], ok_global bool [T] or None)."""
    dev = free0.device
    n = free0.shape[0]
    g = batch.gang_valid.shape[0]
    cap_scale = torch.clamp_min(capacity.amax(dim=0), 1e-9)
    gang_valid0 = apply_global_deps_ref(batch, ok_global)
    has_spread = batch.spread_level is not None
    reuse = (
        batch.reuse_nodes
        if batch.reuse_nodes is not None
        else torch.zeros((g, n), dtype=torch.bool, device=dev)
    )
    fields = (
        "group_req", "group_total", "group_required", "group_valid", "set_member",
        "set_req_level", "set_pref_level", "set_valid", "set_pinned", "pod_group",
        "pod_rank", "group_order",
    )
    free = free0
    ok_vec = torch.zeros((g,), dtype=torch.bool, device=dev)
    family_used = torch.zeros((g, n) if has_spread else (1, 1), dtype=torch.bool, device=dev)
    assigned_rows, ok_rows, score_rows = [], [], []
    for gi in range(g):
        gang = {f: getattr(batch, f)[gi] for f in fields}
        dep = batch.depends_on[gi]
        dep_ok = torch.where(dep >= 0, ok_vec[dep.clamp(0, g - 1).long()], True)
        gang["gang_valid"] = gang_valid0[gi] & dep_ok
        if batch.group_node_ok is not None:
            gang["group_node_ok"] = batch.group_node_ok[gi]
        avoid = None
        if has_spread:
            gang["spread_level"] = batch.spread_level[gi]
            fam = batch.spread_family[gi]
            ridx = fam.clamp(0, g - 1).long()
            avoid = batch.spread_avoid[gi] | (family_used[ridx] & (fam >= 0))
        free, assigned, ok, score = place_gang_ref(
            free,
            reuse[gi],
            gang,
            schedulable=schedulable,
            node_domain_id=node_domain_id,
            cap_scale=cap_scale,
            params=params,
            spread_avoid=avoid,
            spans=spans,
        )
        ok_vec = ok_vec.clone()
        ok_vec[gi] = ok
        if has_spread:
            placed_mask = (
                torch.zeros((n,), dtype=torch.uint8, device=dev)
                .scatter_reduce(
                    0,
                    assigned.clamp(0, n - 1).long(),
                    ((assigned >= 0) & ok).to(torch.uint8),
                    reduce="amax",
                )
                .to(torch.bool)
            )
            family_used = family_used.clone()
            family_used[ridx] = torch.where(
                fam >= 0, family_used[ridx] | placed_mask, family_used[ridx]
            )
        assigned_rows.append(assigned)
        ok_rows.append(ok)
        score_rows.append(score)
    ok = torch.stack(ok_rows)
    return (
        torch.stack(assigned_rows),
        ok,
        torch.stack(score_rows),
        free,
        scatter_global_ok_ref(batch, ok, ok_global),
    )


def gather_free_ref(free, cand_idx):
    """Fleet free [NF, R] -> candidate free [pad, R]; rows whose index lies
    outside the fleet read 0 (pruning.py `gather_free`, mode="fill")."""
    nf = free.shape[0]
    valid = (cand_idx >= 0) & (cand_idx < nf)
    rows = free[cand_idx.clamp(0, nf - 1).long()]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=free.dtype, device=free.device))


def scatter_free_ref(fleet_free, cand_free, cand_idx):
    """Candidate rows back into a copy of the fleet free; rows whose index
    lies outside the fleet drop (pruning.py `scatter_free`, unique indices)."""
    valid = (cand_idx >= 0) & (cand_idx < fleet_free.shape[0])
    out = fleet_free.clone()
    out[cand_idx[valid].long()] = cand_free[valid]
    return out


def remap_assigned_ref(assigned, cand_idx, count: int):
    """Candidate ordinals -> fleet ordinals, -1 stays -1 (pruning.py
    `remap_assigned`)."""
    safe = assigned.clamp(0, count - 1).long()
    return torch.where(assigned >= 0, cand_idx[safe], -1).to(torch.int32)


def solve_pruned_ref(
    free, capacity, schedulable, node_domain_id, batch: GangBatch, params, ok_global,
    cand_idx, count: int,
):
    """A wave solved on a candidate axis: gather the fleet carry `free`
    [NF, R], solve on the plan's `capacity`/`schedulable`/`node_domain_id`
    with the gathered `batch`, scatter back and remap.

    Returns (assigned in fleet ordinals, ok, score, fleet free_after,
    ok_global), as solve_batch_ref."""
    assigned, ok, score, free_after, okg = solve_batch_ref(
        gather_free_ref(free, cand_idx), capacity, schedulable, node_domain_id, batch, params,
        ok_global,
    )
    return (
        remap_assigned_ref(assigned, cand_idx, count),
        ok,
        score,
        scatter_free_ref(free, free_after, cand_idx),
        okg,
    )


def sharded_solve_ref(free, capacity, schedulable, node_domain_id, batch: GangBatch, params,
                      ok_global, spans, cand_idx=None, count=None):
    """The node-sharded solve (B7: core.py `sharded_solve_fn` under a
    parallel/mesh.py SolveLayout) over row `spans` of the solve's node axis:
    every domain sum is the shards' partials (each in node order) added in
    shard order, and stage 2's top-k merges each shard's best candidates by
    (score desc, node asc). With `cand_idx`/`count` the spans split the
    candidate axis: the fleet carry `free` is gathered span by span, solved,
    scattered back and `assigned` remapped, as solve_pruned_ref does.

    Returns what solve_batch_ref returns (assigned in fleet ordinals)."""
    if cand_idx is None:
        return solve_batch_ref(free, capacity, schedulable, node_domain_id, batch, params,
                               ok_global, spans)
    gathered = torch.cat([gather_free_ref(free, cand_idx[lo:hi]) for lo, hi in spans])
    assigned, ok, score, free_after, okg = solve_batch_ref(
        gathered, capacity, schedulable, node_domain_id, batch, params, ok_global, spans)
    out = free
    for lo, hi in spans:
        out = scatter_free_ref(out, free_after[lo:hi], cand_idx[lo:hi])
    return remap_assigned_ref(assigned, cand_idx, count), ok, score, out, okg


# ---- B5: the same wave under K weight rows, and the portfolio's winner ------

WEIGHT_FIELDS = ("w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread")


def params_row(row):
    """Row k of a weight stack [K, 5] (f32) -> what the solve reads as its
    params: the five weights by name, as Python floats of the same f32
    values."""
    return SimpleNamespace(**dict(zip(WEIGHT_FIELDS, (float(x) for x in row.tolist()))))


def stacked_solve_ref(
    free0, capacity, schedulable, node_domain_id, batch: GangBatch, params_stack, ok_global=None
):
    """Solve the same wave under every row of `params_stack` (f32 [K, 5])
    (core.py `stacked_solve_batch_impl`): row k is `solve_batch_ref` under
    row k's weights. Every row solves from `free0` and judges its
    cross-wave dependencies against the same `ok_global`, which no row
    changes.

    Returns (assigned i32 [K, G, MP], ok bool [K, G], score f32 [K, G],
    free_after f32 [K, N, R])."""
    rows = [
        solve_batch_ref(free0, capacity, schedulable, node_domain_id, batch,
                        params_row(params_stack[k]), ok_global)
        for k in range(params_stack.shape[0])
    ]
    return tuple(torch.stack([row[i] for row in rows]) for i in range(4))


def xla_sum_ref(values) -> torch.Tensor:
    """The f32 sum of `values` [n] in the order XLA's CPU backend reduces
    them (its tree-reduction rewrite, as the JAX package's `_objective`
    sums the admitted gangs' scores): while n >= 32 the values are padded
    with zeros to a multiple of 32 — half the padding, rounded down, in
    front, the rest behind — and each window of 32 is summed in index order
    into one value; the fewer than 32 values left are summed in index
    order."""
    x = [np.float32(v) for v in values.tolist()]
    while len(x) >= 32:
        pad = -len(x) % 32
        x = [np.float32(0)] * (pad // 2) + x + [np.float32(0)] * (pad - pad // 2)
        x = [_index_order_sum(x[j : j + 32]) for j in range(0, len(x), 32)]
    return torch.tensor(_index_order_sum(x), dtype=_F32)


def _index_order_sum(xs) -> np.float32:
    acc = np.float32(0)
    for v in xs:
        acc = np.float32(acc + v)
    return acc


def objective_ref(ok, score) -> tuple[torch.Tensor, torch.Tensor]:
    """(gangs admitted i32, total placement quality f32) of one solve
    (portfolio.py `_objective`), compared lexicographically."""
    admitted = ok.sum(dtype=torch.int32)
    return admitted, xla_sum_ref(torch.where(ok, score, 0.0).cpu()).to(score.device)


def portfolio_select_ref(assigned, ok, score, free_after, batch: GangBatch, ok_global=None):
    """The portfolio's winner among K stacked rows (portfolio.py
    `portfolio_solve_batch`): the most admitted gangs, then the highest
    quality, then the lowest index. Returns the winner's (assigned, ok,
    score, free_after, ok_global with its verdicts scattered in (None
    without one), winner i32 [], objectives f32 [K] = admitted * 1e6 +
    quality)."""
    rows = [objective_ref(ok[k], score[k]) for k in range(ok.shape[0])]
    admitted = torch.stack([a for a, _ in rows])
    quality = torch.stack([q for _, q in rows])
    best = torch.where(admitted == admitted.max(), quality, float("-inf"))
    w = int(torch.argmax(best))  # the first maximum
    objectives = admitted.to(_F32) * 1e6 + quality
    return (
        assigned[w], ok[w], score[w], free_after[w],
        scatter_global_ok_ref(batch, ok[w], ok_global),
        torch.tensor(w, dtype=torch.int32, device=ok.device), objectives,
    )


# ---- B4: W waves in one program, the carry threaded from step to step -------


def _step(stacked_batch: GangBatch, w: int) -> GangBatch:
    return GangBatch(*(None if x is None else x[w] for x in stacked_batch))


def _scan_out(rows, free_in, okg_in, free, okg, retain):
    """(assigned [W, G, MP], ok [W, G], score [W, G], free_in [W, N, R] or
    None, okg_in [W, T] or None, free_after, ok_global)."""
    assigned, ok, score = (torch.stack([r[i] for r in rows]) for i in range(3))
    return (
        assigned, ok, score,
        torch.stack(free_in) if retain else None,
        torch.stack(okg_in) if retain and okg is not None else None,
        free, okg,
    )


def scan_solve_ref(free0, capacity, schedulable, node_domain_id, stacked_batch: GangBatch,
                   params, ok_global=None, retain=False):
    """W waves solved one after another, each from the carry the previous
    one left (core.py `scan_solve_fn`): step w is `solve_batch_ref` on wave
    w of `stacked_batch` (every field with a leading [W] axis) from the
    (free, ok_global) that step w - 1 returned. With `retain` each step's
    entering free and ok_global are kept.

    Returns (assigned i32 [W, G, MP], ok bool [W, G], score f32 [W, G],
    free_in f32 [W, N, R] or None, okg_in bool [W, T] or None, free_after,
    ok_global)."""
    free, okg = free0, ok_global
    rows, free_in, okg_in = [], [], []
    for w in range(stacked_batch.gang_valid.shape[0]):
        free_in.append(free)
        okg_in.append(okg)
        assigned, ok, score, free, okg = solve_batch_ref(
            free, capacity, schedulable, node_domain_id, _step(stacked_batch, w), params, okg
        )
        rows.append((assigned, ok, score))
    return _scan_out(rows, free_in, okg_in, free, okg, retain)


def scan_pruned_solve_ref(free0, cand_idx, capacity_p, schedulable_p, node_domain_id_p,
                          stacked_batch: GangBatch, params, ok_global=None, retain=False):
    """The candidate-pruned scan (core.py `scan_pruned_solve_fn`): step w is
    `solve_pruned_ref` on wave w's candidate axis — `cand_idx[w]` (pad rows
    point past the fleet, so they gather 0 and scatter nowhere),
    `capacity_p[w]`, `schedulable_p[w]`, `node_domain_id_p[w]` and the
    candidate-axis wave w of `stacked_batch` — from the fleet carry step
    w - 1 left. Its candidates are the rows of `cand_idx[w]` inside the
    fleet, which come first. The retained `free_in` is fleet-shaped.

    Returns what scan_solve_ref returns, `assigned` in fleet ordinals."""
    nf = free0.shape[0]
    free, okg = free0, ok_global
    rows, free_in, okg_in = [], [], []
    for w in range(stacked_batch.gang_valid.shape[0]):
        free_in.append(free)
        okg_in.append(okg)
        count = int((cand_idx[w] < nf).sum())
        assigned, ok, score, free, okg = solve_pruned_ref(
            free, capacity_p[w], schedulable_p[w], node_domain_id_p[w], _step(stacked_batch, w),
            params, okg, cand_idx[w], count,
        )
        rows.append((assigned, ok, score))
    return _scan_out(rows, free_in, okg_in, free, okg, retain)


def stacked_scan_solve_ref(free_stack, capacity, schedulable, node_domain_id,
                           stacked_batch: GangBatch, params_stack):
    """W journaled waves under every row of `params_stack` (core.py
    `stacked_scan_solve_fn`): step w is `stacked_solve_ref` on wave w of
    `stacked_batch` from `free_stack[w]`, with no ok_global and no carry
    between the steps.

    Returns (assigned i32 [W, K, G, MP], ok bool [W, K, G], score f32
    [W, K, G])."""
    rows = [
        stacked_solve_ref(free_stack[w], capacity, schedulable, node_domain_id,
                          _step(stacked_batch, w), params_stack)[:3]
        for w in range(free_stack.shape[0])
    ]
    return tuple(torch.stack([row[i] for row in rows]) for i in range(3))
