"""Workload API surface: core types, scheduler IR, naming, defaulting."""

from grove_tpu_torch.api.types import (  # noqa: F401
    ClusterTopology,
    Container,
    ObjectMeta,
    PodCliqueScalingGroupConfig,
    PodCliqueSet,
    PodCliqueSetSpec,
    PodCliqueSetTemplateSpec,
    PodCliqueSpec,
    PodCliqueTemplateSpec,
    PodSpec,
    TopologyConstraint,
    TopologyDomain,
    TopologyLevel,
)
from grove_tpu_torch.api.pod import Pod  # noqa: F401
from grove_tpu_torch.api.podgang import (  # noqa: F401
    IRTopologyConstraint,
    NamespacedName,
    PodGang,
    PodGangSpec,
    PodGroup,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from grove_tpu_torch.api.defaulting import default_podcliqueset  # noqa: F401
