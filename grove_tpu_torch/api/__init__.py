"""Workload API surface: core types, scheduler IR, naming, defaulting, validation."""

from grove_tpu_torch.api.types import (  # noqa: F401
    AutoScalingConfig,
    CliqueStartupType,
    ClusterTopology,
    Condition,
    Container,
    DEFAULT_CLUSTER_TOPOLOGY,
    HeadlessServiceConfig,
    ObjectMeta,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueScalingGroupConfig,
    PodCliqueScalingGroupSpec,
    PodCliqueScalingGroupStatus,
    PodCliqueSet,
    PodCliqueSetSpec,
    PodCliqueSetStatus,
    PodCliqueSetTemplateSpec,
    PodCliqueSpec,
    PodCliqueStatus,
    PodCliqueTemplateSpec,
    PodSpec,
    TopologyConstraint,
    TopologyDomain,
    TopologyLevel,
    TOPOLOGY_DOMAIN_ORDER,
    get_condition,
    is_domain_narrower,
    set_condition,
)
from grove_tpu_torch.api.pod import Pod, PodPhase  # noqa: F401
from grove_tpu_torch.api.podgang import (  # noqa: F401
    IRTopologyConstraint,
    NamespacedName,
    PodGang,
    PodGangPhase,
    PodGangSpec,
    PodGangStatus,
    PodGroup,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from grove_tpu_torch.api.defaulting import default_podcliqueset  # noqa: F401
from grove_tpu_torch.api.validation import ValidationError, validate_podcliqueset, validate_update  # noqa: F401
