"""Greedy per-pod baseline scheduler — the quality yardstick
(grove_tpu/solver/greedy.py counterpart, host numpy; no kernel).

Mirrors the reference scheduling path's shape: KAI processes each pod through
a Filter -> Score -> Permit cycle, binding one pod at a time, with gang
admission checked against PodGroup.MinReplicas and topology handled by
committing subgroup domains (assertion semantics in
operator/e2e/utils/kai_topology.go:187-313; PodGang contract in
scheduler/api/core/v1alpha1/podgang.go:75-117). BASELINE.md's bar — placement
quality >= the Go/KAI path — is only falsifiable against an implementation of
that per-pod cycle, which this module provides in plain numpy (host-side,
sequential, one pod at a time — deliberately NOT the batched solver).

Semantics parity with the JAX solver (so comparisons are apples-to-apples):
  - all-or-nothing: a gang commits only if every valid group reaches its
    min_replicas floor and every required pack-set found a single domain
  - base-gang gating: scaled gangs only try after their base gang admitted
  - scoring ingredients: bin-pack tightness + preferred-domain bonus, the
    same two terms the solver's Score stage uses
  - placement score: same formula (0.5 + 0.5 x mean preferred-fraction)

The difference under measure: per-pod greedy commitment (the reference cycle)
vs whole-gang batched commitment (ours).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.solver.core import SolverParams
from grove_tpu_torch.solver.encode import encode_gangs

_EPS = 1e-6


def _default_weights() -> tuple[float, float]:
    """(w_pref, w_tight) from SolverParams so the yardstick scores with the
    same weights the solver's Score stage uses."""
    p = SolverParams()
    return float(p.w_pref), float(p.w_tight)


@dataclass
class GreedyStats:
    admitted: int = 0
    rejected: int = 0
    pods_bound: int = 0
    scores: list[float] = field(default_factory=list)
    elapsed_s: float = 0.0
    bindings: dict[str, dict[str, str]] = field(default_factory=dict)

    @property
    def mean_score(self) -> float:
        return float(np.mean(self.scores)) if self.scores else 0.0


def _commit_domains(free, snapshot, b, schedulable):
    """Greedy domain commitment per pack-set, broad->narrow.

    Returns (committed_req [MS], committed_pref [MS], ok). Best-fit choice:
    least normalized free capacity among feasible domains (bin-pack, the KAI
    default strategy).
    """
    ms = b.set_valid.shape[1]
    mg = b.group_valid.shape[1]
    n = free.shape[0]
    cap_scale = np.maximum(snapshot.capacity.max(axis=0), 1e-9)
    committed_req = np.full(ms, -1, dtype=np.int64)
    committed_pref = np.full(ms, -1, dtype=np.int64)

    def node_mask_for(si):
        """Nodes consistent with previously committed overlapping sets."""
        mask = schedulable.copy()
        member = b.set_member[0, si]
        for sj in range(ms):
            if committed_req[sj] >= 0 and (b.set_member[0, sj] & member).any():
                lvl = int(b.set_req_level[0, sj])
                mask &= snapshot.node_domain_id[lvl] == committed_req[sj]
        return mask

    def pick(level, node_mask, demand, per_group_floor):
        dom_ids = snapshot.node_domain_id[level]
        best, best_fill = -1, None
        for d in np.unique(dom_ids[dom_ids >= 0]):
            sel = node_mask & (dom_ids == d)
            if not sel.any():
                continue
            dom_free = free[sel].sum(axis=0)
            if (dom_free + _EPS < demand).any():
                continue
            feasible = True
            for k, floor in per_group_floor:
                # Per-group eligibility (nodeSelector/tolerations) gates the
                # floor check too: a domain whose eligible subset can't host
                # the floor must not be committed, or the later per-pod mask
                # empties and the gang is falsely rejected (the solver masks
                # slots before domain selection; the baseline must match).
                ksel = sel
                if b.group_node_ok is not None:
                    ksel = sel & b.group_node_ok[0, k]
                req = b.group_req[0, k]
                pos = req > 0
                if pos.any():
                    slots = np.floor((free[ksel][:, pos] + _EPS) / req[pos]).min(axis=1)
                else:
                    slots = np.full(ksel.sum(), 1 << 20)
                if slots.sum() < floor:
                    feasible = False
                    break
            if not feasible:
                continue
            fill = (dom_free / cap_scale).sum()
            if best_fill is None or fill < best_fill:
                best, best_fill = int(d), fill
        return best

    for si in range(ms):
        if not b.set_valid[0, si]:
            continue
        member = b.set_member[0, si] & b.group_valid[0]
        floors = [
            (k, int(b.group_required[0, k])) for k in range(mg) if member[k]
        ]
        demand = sum(
            b.group_req[0, k] * flo for k, flo in floors
        ) if floors else np.zeros(free.shape[1])
        req_level = int(b.set_req_level[0, si])
        if req_level >= 0:
            mask = node_mask_for(si)
            if int(b.set_pinned[0, si]) >= 0:
                mask = mask & (
                    snapshot.node_domain_id[req_level] == int(b.set_pinned[0, si])
                )
            d = pick(req_level, mask, demand, floors)
            if d < 0:
                return committed_req, committed_pref, False
            committed_req[si] = d
        pref_level = int(b.set_pref_level[0, si])
        if pref_level >= 0:
            mask = node_mask_for(si)
            if committed_req[si] >= 0:
                mask &= snapshot.node_domain_id[req_level] == committed_req[si]
            d = pick(pref_level, mask, demand, floors)
            committed_pref[si] = d
    return committed_req, committed_pref, True


def greedy_place_gang(
    free, snapshot, gang, pods_by_name, schedulable=None, scheduled_gangs=None
):
    """Place one gang pod-by-pod. Returns (ok, bindings, score, new_free).

    `scheduled_gangs`: names of already-admitted gangs, so encode's base-gang
    gate recognizes a base admitted in an earlier greedy step (the gang is
    encoded alone here, so its base is never in-batch).
    """
    if schedulable is None:
        schedulable = snapshot.schedulable
    b, decode = encode_gangs(
        [gang], pods_by_name, snapshot, scheduled_gangs=scheduled_gangs
    )
    if not b.gang_valid[0]:
        # encode deemed the gang unschedulable (e.g. unresolvable REQUIRED
        # topology key) — the baseline must reject it too, not waive the
        # constraint, or the quality comparison penalizes correct rejections.
        return False, {}, 0.0, free
    mg = b.group_valid.shape[1]
    ms = b.set_valid.shape[1]
    cap_scale = np.maximum(snapshot.capacity.max(axis=0), 1e-9)

    committed_req, committed_pref, ok = _commit_domains(free, snapshot, b, schedulable)
    if not ok:
        return False, {}, 0.0, free

    w_pref, w_tight = _default_weights()
    trial = free.copy()
    placed = np.zeros(mg, dtype=np.int64)
    pod_nodes: list[tuple[str, int, int]] = []  # (pod name, node idx, group)
    # Floors first (the gang guarantee), then best-effort extras — matching
    # the solver's two-phase allocation so neither starves the other.
    slots = list(range(b.pod_group.shape[1]))
    floor_slots = [
        s
        for s in slots
        if b.pod_group[0, s] >= 0
        and b.pod_rank[0, s] < b.group_required[0, b.pod_group[0, s]]
    ]
    extra_slots = [
        s
        for s in slots
        if b.pod_group[0, s] >= 0
        and b.pod_rank[0, s] >= b.group_required[0, b.pod_group[0, s]]
    ]
    for s in floor_slots + extra_slots:
        k = int(b.pod_group[0, s])
        req = b.group_req[0, k]
        mask = schedulable & (trial + _EPS >= req).all(axis=1)
        if b.group_node_ok is not None:
            # nodeSelector: the baseline enforces the same constraint as the
            # solver — waiving it would let greedy "admit" placements the
            # solver correctly rejects and poison the quality comparison.
            mask &= b.group_node_ok[0, k]
        pref_bonus = np.zeros(free.shape[0])
        for si in range(ms):
            if not b.set_valid[0, si] or not b.set_member[0, si, k]:
                continue
            if committed_req[si] >= 0:
                lvl = int(b.set_req_level[0, si])
                mask &= snapshot.node_domain_id[lvl] == committed_req[si]
            if committed_pref[si] >= 0:
                lvl = int(b.set_pref_level[0, si])
                pref_bonus += snapshot.node_domain_id[lvl] == committed_pref[si]
        if not mask.any():
            if int(b.pod_rank[0, s]) < int(b.group_required[0, k]):
                return False, {}, 0.0, free  # floor unmet -> reject whole gang
            continue  # best-effort extra may fail
        norm_free = (trial / cap_scale[None, :]).mean(axis=1)
        score = np.where(mask, w_pref * pref_bonus - w_tight * norm_free, -np.inf)
        node = int(np.argmax(score))
        trial[node] -= req
        placed[k] += 1
        pod_nodes.append((decode.pod_names[0][s], node, k))

    for k in range(mg):
        if b.group_valid[0, k] and placed[k] < int(b.group_required[0, k]):
            return False, {}, 0.0, free

    # Placement score: same formula as the solver (podgang.go:176-178 analog).
    fracs = []
    for si in range(ms):
        if not b.set_valid[0, si] or int(b.set_pref_level[0, si]) < 0:
            continue
        lvl = int(b.set_pref_level[0, si])
        members = {k for k in range(mg) if b.set_member[0, si, k]}
        pods_in = [(n_, k) for (_, n_, k) in pod_nodes if k in members]
        if not pods_in:
            fracs.append(1.0)
            continue
        if committed_pref[si] < 0:
            fracs.append(0.0)
            continue
        hits = sum(
            1
            for (n_, _) in pods_in
            if snapshot.node_domain_id[lvl, n_] == committed_pref[si]
        )
        fracs.append(hits / len(pods_in))
    mean_frac = float(np.mean(fracs)) if fracs else 1.0
    score = 0.5 + 0.5 * mean_frac

    bindings = {
        name: snapshot.node_names[node] for (name, node, _) in pod_nodes
    }
    return True, bindings, score, trial


def greedy_drain(gangs, pods_by_name, snapshot) -> GreedyStats:
    """Drain a gang backlog with the per-pod greedy cycle; returns stats."""
    stats = GreedyStats()
    free = snapshot.free.copy()
    admitted_names: set[str] = set()
    t0 = time.perf_counter()
    for gang in gangs:
        if (
            gang.base_podgang_name is not None
            and gang.base_podgang_name not in admitted_names
        ):
            stats.rejected += 1
            continue
        ok, bindings, score, free = greedy_place_gang(
            free, snapshot, gang, pods_by_name, scheduled_gangs=admitted_names
        )
        if ok:
            stats.admitted += 1
            stats.pods_bound += len(bindings)
            stats.scores.append(score)
            stats.bindings[gang.name] = bindings
            admitted_names.add(gang.name)
        else:
            stats.rejected += 1
    stats.elapsed_s = time.perf_counter() - t0
    return stats
