"""Lightweight Pod object — the unit the orchestrator creates and the solver places.

The reference uses corev1.Pod built by the PodClique pod component
(operator/internal/controller/podclique/components/pod/pod.go:68,135-172,232-269):
scheduling gate `grove.io/podgang-pending-creation`, GROVE_* env vars, stable
hostname `<pclq>-<idx>` + subdomain, startup-ordering init container. We keep the
same observable fields plus a dense resource-request vector filled in by
grove_tpu/state when snapshotting.

The port's copy of grove_tpu/api/pod.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from grove_tpu_torch.api.types import Condition, PodSpec


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    spec: PodSpec = field(default_factory=PodSpec)
    # Grove bookkeeping (labels in the reference; first-class here):
    pclq_fqn: str = ""
    podgang_name: str = ""
    base_podgang_name: Optional[str] = None  # set for pods of scaled gangs
    pod_index: int = 0  # stable hostname index (internal/index/tracker.go)
    pod_template_hash: str = ""
    env: dict[str, str] = field(default_factory=dict)
    # Lifecycle:
    phase: PodPhase = PodPhase.PENDING
    conditions: list[Condition] = field(default_factory=list)
    node_name: Optional[str] = None
    scheduling_gates: list[str] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    started_at: Optional[float] = None
    ready: bool = False
    # Container terminated erroneously and keeps restarting: the pod stays
    # bound and active (restartPolicy Always) but is neither ready nor
    # "starting" (utils/kubernetes/pod.go:95-112 HasPodTerminatedErroneously).
    crashlooping: bool = False

    @property
    def is_gated(self) -> bool:
        return bool(self.scheduling_gates)

    @property
    def is_scheduled(self) -> bool:
        return self.node_name is not None

    @property
    def is_active(self) -> bool:
        """Not terminal and not being deleted — counts toward replica math."""
        return (
            self.deletion_timestamp is None
            and self.phase not in (PodPhase.SUCCEEDED, PodPhase.FAILED)
        )

    @property
    def hostname(self) -> str:
        return f"{self.pclq_fqn}-{self.pod_index}"
