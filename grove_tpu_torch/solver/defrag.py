"""Fragmentation scoring (grove_tpu/solver/defrag.py counterpart, cut to
`fragmentation_report`; host numpy, no device traffic).

Placement here is write-once: after churn, free capacity ends up scattered
across topology domains, and a large gang with a required pack constraint
fails admission even though TOTAL free capacity is ample. The fragmentation
score compares, per topology level and resource, the free capacity of the
BEST single domain against the ideal — total free capacity, capped by the
largest domain's capacity (consolidation cannot exceed one domain's size):
`stranded = 1 - best / ideal`. A freshly empty cluster scores 0; a churned
cluster whose free capacity is scattered in slivers scores toward 1. The
headline score is the max stranded over (level, resource).

`largest_placeable` and the migration planner (`plan_migrations`,
`plan_rescue`) are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.api.types import TopologyDomain
from grove_tpu_torch.state.cluster import ClusterSnapshot

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
