"""Score any (snapshot, plan) pair — the placement-quality report
(grove_tpu/quality/report.py counterpart).

Given the gangs, the pods, the pre-placement snapshot, and a plan ({gang:
{pod: node}} — the shape `decode_bindings` and `greedy_drain` emit), it
computes

  - admitted ratio            admitted gangs / schedulable gangs
  - preferred-domain fraction mean over admitted gangs' preferred pack-sets
                              of the fraction of member pods landing in the
                              set's most-used domain (the committed-domain
                              view of podgang.go:176-178)
  - placement score           0.5 + 0.5 * mean preferred fraction per gang —
                              the same formula the solver, the greedy
                              baseline, and the exact packer score with
  - stranding delta           fragmentation score (solver/defrag.py) after
                              the plan minus before it: how much the plan
                              fragments the fleet it leaves behind

Host-side numpy only: cheap enough to run per bench scenario.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from grove_tpu_torch.solver.defrag import fragmentation_report
from grove_tpu_torch.solver.encode import encode_gangs
from grove_tpu_torch.state.cluster import pod_request_vector


@dataclass
class PlacementQualityReport:
    """One plan's quality, in the units the acceptance gates use."""

    gangs: int  # schedulable gangs evaluated
    admitted: int
    pods: int  # pods referenced by evaluated gangs
    pods_bound: int
    admitted_ratio: float
    preferred_sets: int  # pack-sets with a preferred level, admitted gangs
    preferred_fraction: float  # mean most-used-domain fraction over them
    mean_placement_score: float  # over admitted gangs (0.0 when none)
    stranded_before: float  # fragmentation score pre-plan
    stranded_after: float  # fragmentation score post-plan
    stranding_delta: float  # after - before (what the plan cost the fleet)
    scores: dict = field(default_factory=dict)  # gang -> placement score

    def to_doc(self) -> dict:
        """JSON-able form for bench lines, /statusz, and the CLI."""
        return {
            "gangs": self.gangs,
            "admitted": self.admitted,
            "pods": self.pods,
            "podsBound": self.pods_bound,
            "admittedRatio": round(self.admitted_ratio, 4),
            "preferredSets": self.preferred_sets,
            "preferredFraction": round(self.preferred_fraction, 4),
            "meanPlacementScore": round(self.mean_placement_score, 4),
            "strandedBefore": round(self.stranded_before, 4),
            "strandedAfter": round(self.stranded_after, 4),
            "strandingDelta": round(self.stranding_delta, 4),
        }


def _gang_score(batch, decode, bound_nodes: dict, node_domain_id) -> tuple:
    """(placement score, per-set fractions) of ONE admitted gang from its
    single-gang encode and its {pod: node index} bindings."""
    mg = batch.group_valid.shape[1]
    ms = batch.set_valid.shape[1]
    # Group of each bound pod (slot order mirrors decode.pod_names).
    group_nodes: dict = {k: [] for k in range(mg)}
    for slot, pod_name in enumerate(decode.pod_names[0]):
        if not pod_name or pod_name not in bound_nodes:
            continue
        group_nodes[int(batch.pod_group[0, slot])].append(bound_nodes[pod_name])
    fracs = []
    levels = node_domain_id.shape[0]
    for si in range(ms):
        if not batch.set_valid[0, si] or int(batch.set_pref_level[0, si]) < 0:
            continue
        lvl = min(int(batch.set_pref_level[0, si]), levels - 1)
        nodes = [
            n
            for k in range(mg)
            if batch.set_member[0, si, k]
            for n in group_nodes.get(k, [])
        ]
        if not nodes:
            fracs.append(1.0)  # no member pods placed: vacuously local
            continue
        doms = node_domain_id[lvl, nodes]
        doms = doms[doms >= 0]
        if doms.size == 0:
            fracs.append(0.0)  # members landed outside any labeled domain
            continue
        _vals, counts = np.unique(doms, return_counts=True)
        fracs.append(int(counts.max()) / len(nodes))
    mean_frac = float(np.mean(fracs)) if fracs else 1.0
    return 0.5 + 0.5 * mean_frac, fracs


def evaluate_placement(
    gangs,
    pods_by_name: dict,
    snapshot,
    bindings: dict,
) -> PlacementQualityReport:
    """Score `bindings` ({gang: {pod: node name}}) against `snapshot`.

    Gangs the encode itself rules out (unresolvable REQUIRED keys) are
    excluded from the denominator — no plan can admit them, so counting
    them would punish every policy equally and discriminate nothing.
    """
    node_domain_id = np.asarray(snapshot.node_domain_id)
    n_gangs = 0
    n_pods = 0
    admitted = 0
    pods_bound = 0
    scores: dict = {}
    all_fracs: list = []
    placed_requests = np.zeros_like(np.asarray(snapshot.allocated))
    for gang in gangs:
        batch, decode = encode_gangs([gang], pods_by_name, snapshot)
        if not batch.gang_valid[0]:
            continue
        n_gangs += 1
        n_pods += gang.total_pods()
        gang_bindings = bindings.get(gang.name) or {}
        if not gang_bindings:
            continue
        admitted += 1
        pods_bound += len(gang_bindings)
        bound_nodes = {
            pod: snapshot.node_index_map[node]
            for pod, node in gang_bindings.items()
            if node in snapshot.node_index_map
        }
        score, fracs = _gang_score(batch, decode, bound_nodes, node_domain_id)
        scores[gang.name] = score
        all_fracs.extend(fracs)
        for pod_name, node_idx in bound_nodes.items():
            pod = pods_by_name.get(pod_name)
            if pod is not None:
                placed_requests[node_idx] += pod_request_vector(
                    pod, snapshot.resource_names
                )

    before = fragmentation_report(snapshot).score
    shadow = replace(snapshot, allocated=np.asarray(snapshot.allocated) + placed_requests)
    after = fragmentation_report(shadow).score
    return PlacementQualityReport(
        gangs=n_gangs,
        admitted=admitted,
        pods=n_pods,
        pods_bound=pods_bound,
        admitted_ratio=(admitted / n_gangs) if n_gangs else 0.0,
        preferred_sets=len(all_fracs),
        preferred_fraction=float(np.mean(all_fracs)) if all_fracs else 1.0,
        mean_placement_score=(
            float(np.mean(list(scores.values()))) if scores else 0.0
        ),
        stranded_before=before,
        stranded_after=after,
        stranding_delta=after - before,
        scores=scores,
    )
