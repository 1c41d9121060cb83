"""Scheduler IR: the PodGang contract between orchestrator and placement backend.

Semantic parity with the reference scheduler API (scheduler/api/core/v1alpha1/podgang.go):
  - PodGangSpec{PodGroups, TopologyConstraint, TopologyConstraintGroupConfigs,
    PriorityClassName, ReuseReservationRef} (podgang.go:51-72)
  - PodGroup{PodReferences, MinReplicas, TopologyConstraint} (podgang.go:75-89)
  - TopologyPackConstraint{Required, Preferred} holding *node-label keys*
    (translated from workload-level domain names) (podgang.go:101-117)
  - Phases Pending/Starting/Running (podgang.go:143-150)
  - Conditions Scheduled/Ready/Unhealthy/DisruptionTarget (podgang.go:155-168)
  - PlacementScore (0,1] with 1.0 = optimal (podgang.go:170-179)

This is the tensorizable boundary: everything below this IR is dense-tensor
work in grove_tpu/state + grove_tpu/solver.

The port's copy of grove_tpu/api/podgang.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from grove_tpu_torch.api.types import Condition


@dataclass(frozen=True)
class NamespacedName:
    namespace: str
    name: str

    def __str__(self) -> str:
        return f"{self.namespace}/{self.name}"


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
    """Pods sharing one template within a gang (podgang.go:75-89).

    MinReplicas is the gang floor: scheduling of the gang is all-or-nothing for
    MinReplicas of each group; pods beyond it are best-effort.
    """

    name: str
    pod_references: list[NamespacedName] = field(default_factory=list)
    min_replicas: int = 0
    topology_constraint: Optional[IRTopologyConstraint] = None


@dataclass
class TopologyConstraintGroupConfig:
    """Constraint over a strict subset of PodGroups (podgang.go:120-128).

    Used for PCSG-level packing: all pods of one PCSG replica (spanning its
    member-clique PodGroups) must pack into one domain.
    """

    name: str
    pod_group_names: list[str] = field(default_factory=list)
    topology_constraint: Optional[IRTopologyConstraint] = None


class PodGangPhase(str, enum.Enum):
    PENDING = "Pending"
    STARTING = "Starting"
    RUNNING = "Running"
    FAILED = "Failed"
    SUCCEEDED = "Succeeded"


@dataclass
class PodGangSpec:
    pod_groups: list[PodGroup] = field(default_factory=list)
    topology_constraint: Optional[IRTopologyConstraint] = None
    topology_constraint_group_configs: list[TopologyConstraintGroupConfig] = field(default_factory=list)
    priority_class_name: str = ""
    reuse_reservation_ref: Optional[NamespacedName] = None
    # Replica spread (PCS topologySpreadDomain translated to a node-label
    # key, like pack constraints): base gangs of sibling PCS replicas prefer
    # domains at this level that no sibling occupies (soft; w_spread).
    spread_key: Optional[str] = None


@dataclass
class PodGangStatus:
    phase: PodGangPhase = PodGangPhase.PENDING
    conditions: list[Condition] = field(default_factory=list)
    # Fraction of scheduled placement quality, (0,1], 1.0 = optimal
    # (podgang.go:176-178).
    placement_score: Optional[float] = None
    # Per-group count of pods bound to nodes (used by gate-removal logic:
    # podclique/components/pod/syncflow.go:303-345 checks
    # ScheduledReplicas >= MinReplicas for every group of the base gang).
    scheduled_replicas: dict[str, int] = field(default_factory=dict)
    # Latch: the gang achieved Scheduled at least once. Distinguishes a gang
    # that LOST its placement (Unhealthy, podgang.go:155-168) from one that
    # never had any (merely Pending) — the live Scheduled condition flips back
    # to False in both cases.
    ever_scheduled: bool = False


@dataclass
class PodGang:
    """The gang CR handed to the placement backend."""

    name: str
    namespace: str = "default"
    spec: PodGangSpec = field(default_factory=PodGangSpec)
    status: PodGangStatus = field(default_factory=PodGangStatus)
    # Bookkeeping mirrored from labels in the reference:
    pcs_name: str = ""
    # Capacity queue (grove.io/queue annotation; "" = unquoted). The KAI
    # Queue analog — quota enforcement is the controller's pre-solve
    # admission filter (orchestrator/controller.py _solve_wave).
    queue: str = ""
    # SLO tier (spec.template.sloClass, api/constants.py SLO_CLASSES):
    # admission order, borrowing eligibility, preemptibility. "" ranks as
    # "standard" for gangs admitted before the field existed.
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

    def total_min_replicas(self) -> int:
        return sum(g.min_replicas for g in self.spec.pod_groups)

    def total_pods(self) -> int:
        return sum(len(g.pod_references) for g in self.spec.pod_groups)

    def is_base_gang_scheduled(self) -> bool:
        """All groups have ScheduledReplicas >= MinReplicas (syncflow.go:303-345)."""
        return all(
            self.status.scheduled_replicas.get(g.name, 0) >= g.min_replicas
            for g in self.spec.pod_groups
        )
