"""Scheduler IR: the PodGang contract between orchestrator and placement
(grove_tpu/api/podgang.py counterpart, cut to what the encoder reads).

Semantic parity with the reference scheduler API (scheduler/api/core/v1alpha1/podgang.go):
  - PodGangSpec{PodGroups, TopologyConstraint, TopologyConstraintGroupConfigs}
    (podgang.go:51-72)
  - PodGroup{PodReferences, MinReplicas, TopologyConstraint} (podgang.go:75-89)
  - TopologyPackConstraint{Required, Preferred} holding *node-label keys*
    (translated from workload-level domain names) (podgang.go:101-117)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class NamespacedName:
    namespace: str
    name: str


@dataclass
class TopologyPackConstraint:
    """Hard/soft packing constraint as node-label keys (podgang.go:101-117)."""

    required: Optional[str] = None  # e.g. "topology.kubernetes.io/rack"
    preferred: Optional[str] = None  # e.g. "kubernetes.io/hostname"


@dataclass
class IRTopologyConstraint:
    """IR-level constraint wrapper (podgang.go:94-99)."""

    pack_constraint: Optional[TopologyPackConstraint] = None


@dataclass
class PodGroup:
    """Pods sharing one template within a gang (podgang.go:75-89). The gang
    is all-or-nothing for MinReplicas of each group; pods beyond it are
    best-effort."""

    name: str
    pod_references: list[NamespacedName] = field(default_factory=list)
    min_replicas: int = 0
    topology_constraint: Optional[IRTopologyConstraint] = None


@dataclass
class TopologyConstraintGroupConfig:
    """Constraint over a strict subset of PodGroups (podgang.go:120-128): all
    pods of one PCSG replica pack into one domain."""

    name: str
    pod_group_names: list[str] = field(default_factory=list)
    topology_constraint: Optional[IRTopologyConstraint] = None


@dataclass
class PodGangSpec:
    pod_groups: list[PodGroup] = field(default_factory=list)
    topology_constraint: Optional[IRTopologyConstraint] = None
    topology_constraint_group_configs: list[TopologyConstraintGroupConfig] = field(default_factory=list)
    # Replica spread (PCS topologySpreadDomain as a node-label key): base
    # gangs of sibling PCS replicas prefer domains no sibling occupies.
    spread_key: Optional[str] = None


@dataclass
class PodGang:
    """The gang handed to the placement solver."""

    name: str
    spec: PodGangSpec = field(default_factory=PodGangSpec)
    pcs_name: str = ""
    # SLO tier of the set's template (every gang of a set shares it); ""
    # ranks as "standard". The streaming drain's tenancy order_key reads it.
    slo_class: str = ""
    pcs_replica_index: int = 0
    # For scaled gangs: the base gang that must schedule first
    # (grove.io/base-podgang label; podclique/components/pod/syncflow.go:347-387).
    base_podgang_name: Optional[str] = None
    # 0-based scaled-gang index (pcsg_replica - minAvailable); -1 for base gangs.
    scaled_index: int = -1

    @property
    def is_scaled(self) -> bool:
        return self.base_podgang_name is not None

    def total_pods(self) -> int:
        return sum(len(g.pod_references) for g in self.spec.pod_groups)
