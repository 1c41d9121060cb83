"""Core workload API: PodCliqueSet and ClusterTopology (grove_tpu/api/types.py
counterpart, cut to the fields expansion, the snapshot and the encoder read).

Semantic parity with the reference core API (operator/api/core/v1alpha1/):
  - PodCliqueSetSpec / TemplateSpec with cliques and scaling-group configs
    (podcliqueset.go:52-58,126-159)
  - PodCliqueSpec with Replicas, MinAvailable (podclique.go:54-79)
  - PodCliqueScalingGroupConfig with dual-purpose MinAvailable (podcliqueset.go:216-227)
  - TopologyConstraint{PackDomain, PreferredDomain} (podcliqueset.go:188-197)
  - TopologyDomain 7-level hierarchy with ordering (clustertopology.go:92-136)

`from_dict` reads the reference's YAML shapes and ignores the keys placement
does not use (startup order, autoscaling, termination delay, ...).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from grove_tpu_torch.api.quantity import parse_quantity


class TopologyDomain(str, enum.Enum):
    """Seven-level topology hierarchy, broadest → narrowest."""

    REGION = "region"
    ZONE = "zone"
    DATACENTER = "datacenter"
    BLOCK = "block"
    RACK = "rack"
    HOST = "host"
    NUMA = "numa"


# Lower value = broader scope (clustertopology.go:124-136).
TOPOLOGY_DOMAIN_ORDER: dict[TopologyDomain, int] = {d: i for i, d in enumerate(TopologyDomain)}


@dataclass
class TopologyLevel:
    """One level of the ClusterTopology: a domain bound to a node-label key."""

    domain: TopologyDomain
    node_label_key: str

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TopologyLevel":
        return cls(
            domain=TopologyDomain(d["domain"]),
            node_label_key=d.get("nodeLabelKey") or d.get("node_label_key"),
        )


@dataclass
class ClusterTopology:
    """Cluster-scoped topology declaration (clustertopology.go:40)."""

    name: str
    levels: list[TopologyLevel] = field(default_factory=list)

    def sorted_levels(self) -> list[TopologyLevel]:
        """Levels broadest → narrowest (clustertopology.go:141)."""
        return sorted(self.levels, key=lambda l: TOPOLOGY_DOMAIN_ORDER[l.domain])

    def label_key_for(self, domain: TopologyDomain) -> Optional[str]:
        for level in self.levels:
            if level.domain == domain:
                return level.node_label_key
        return None

    def with_host_level(self) -> "ClusterTopology":
        """The operator appends the `host` level bound to
        `kubernetes.io/hostname` when absent (clustertopology.go:102-107)."""
        if self.label_key_for(TopologyDomain.HOST) is not None:
            return self
        return ClusterTopology(
            name=self.name,
            levels=[*self.levels, TopologyLevel(TopologyDomain.HOST, "kubernetes.io/hostname")],
        )

    def levels_doc(self) -> list[dict]:
        """The wire shape of the effective hierarchy (host level included,
        broadest first), as a journal's fleet record holds it."""
        return [
            {"domain": lvl.domain.value, "nodeLabelKey": lvl.node_label_key}
            for lvl in self.with_host_level().sorted_levels()
        ]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ClusterTopology":
        spec = d.get("spec", d)
        return cls(
            name=d.get("metadata", {}).get("name", d.get("name", "default")),
            levels=[TopologyLevel.from_dict(x) for x in spec.get("levels", [])],
        )


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ObjectMeta":
        return cls(name=d.get("name", ""), namespace=d.get("namespace", "default"))


@dataclass
class Container:
    name: str
    requests: dict[str, float] = field(default_factory=dict)  # base units

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Container":
        res = d.get("resources", {}) or {}
        requests = {k: parse_quantity(v) for k, v in (res.get("requests", {}) or {}).items()}
        return cls(name=d["name"], requests=requests)


@dataclass
class PodSpec:
    """The part of corev1.PodSpec that drives placement."""

    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[dict] = field(default_factory=list)

    def total_requests(self) -> dict[str, float]:
        """Aggregate resource requests across containers (max with init containers)."""
        total: dict[str, float] = {}
        for c in self.containers:
            for k, v in c.requests.items():
                total[k] = total.get(k, 0.0) + v
        for c in self.init_containers:
            for k, v in c.requests.items():
                total[k] = max(total.get(k, 0.0), v)
        return total

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodSpec":
        return cls(
            containers=[Container.from_dict(c) for c in d.get("containers", []) or []],
            init_containers=[Container.from_dict(c) for c in d.get("initContainers", []) or []],
            node_selector=dict(d.get("nodeSelector", {}) or {}),
            tolerations=list(d.get("tolerations", []) or []),
        )


@dataclass
class TopologyConstraint:
    """Pack each replica instance within one domain of `pack_domain` (hard);
    `preferred_domain` is the soft counterpart that only moves the
    PlacementScore (podcliqueset.go:188-197, podgang.go:101-117)."""

    pack_domain: Optional[TopologyDomain] = None
    preferred_domain: Optional[TopologyDomain] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> Optional["TopologyConstraint"]:
        if not d:
            return None
        pack = d.get("packDomain")
        preferred = d.get("preferredDomain")
        if pack is None and preferred is None:
            return None
        return cls(
            pack_domain=TopologyDomain(pack) if pack is not None else None,
            preferred_domain=TopologyDomain(preferred) if preferred is not None else None,
        )


@dataclass
class PodCliqueSpec:
    """Spec of one clique role (podclique.go:54-79)."""

    pod_spec: PodSpec
    replicas: int = 0  # defaulted to 1
    min_available: Optional[int] = None  # defaulted to replicas

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSpec":
        return cls(
            pod_spec=PodSpec.from_dict(d.get("podSpec", {}) or {}),
            replicas=int(d.get("replicas", 0) or 0),
            min_available=int(d["minAvailable"]) if d.get("minAvailable") is not None else None,
        )


@dataclass
class PodCliqueTemplateSpec:
    """Named clique template inside a PodCliqueSet (podcliqueset.go:160-186)."""

    name: str
    spec: PodCliqueSpec
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueTemplateSpec":
        return cls(
            name=d["name"],
            spec=PodCliqueSpec.from_dict(d.get("spec", {}) or {}),
            topology_constraint=TopologyConstraint.from_dict(d.get("topologyConstraint")),
        )


@dataclass
class PodCliqueScalingGroupConfig:
    """Template-level scaling-group config (podcliqueset.go:200-236).

    PCSG replicas [0, minAvailable) join the base PodGang; the rest get
    scaled PodGangs (scalinggroup.go:56-67)."""

    name: str
    clique_names: list[str]
    replicas: int = 1
    min_available: int = 1
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueScalingGroupConfig":
        return cls(
            name=d["name"],
            clique_names=list(d.get("cliqueNames", []) or []),
            replicas=int(d["replicas"]) if d.get("replicas") is not None else 1,
            min_available=int(d["minAvailable"]) if d.get("minAvailable") is not None else 1,
            topology_constraint=TopologyConstraint.from_dict(d.get("topologyConstraint")),
        )


@dataclass
class PodCliqueSetTemplateSpec:
    """The per-replica template (podcliqueset.go:126-159)."""

    cliques: list[PodCliqueTemplateSpec] = field(default_factory=list)
    pod_clique_scaling_group_configs: list[PodCliqueScalingGroupConfig] = field(default_factory=list)
    # SLO tier (`sloClass`: latency, standard, batch-preemptible): "" on
    # load, defaulting fills "standard"; every gang of the set carries it.
    slo_class: str = ""
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSetTemplateSpec":
        return cls(
            cliques=[PodCliqueTemplateSpec.from_dict(c) for c in d.get("cliques", []) or []],
            pod_clique_scaling_group_configs=[
                PodCliqueScalingGroupConfig.from_dict(c)
                for c in d.get("podCliqueScalingGroups", d.get("podCliqueScalingGroupConfigs", [])) or []
            ],
            slo_class=d.get("sloClass", ""),
            topology_constraint=TopologyConstraint.from_dict(d.get("topologyConstraint")),
        )


@dataclass
class PodCliqueSetSpec:
    replicas: int = 1
    template: PodCliqueSetTemplateSpec = field(default_factory=PodCliqueSetTemplateSpec)
    # Spread each PCS replica across this domain (replica-spread analog).
    topology_spread_domain: Optional[TopologyDomain] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSetSpec":
        return cls(
            replicas=int(d.get("replicas", 1) or 1),
            template=PodCliqueSetTemplateSpec.from_dict(d.get("template", {}) or {}),
            topology_spread_domain=(
                TopologyDomain(d["topologySpreadDomain"]) if d.get("topologySpreadDomain") else None
            ),
        )


@dataclass
class PodCliqueSet:
    metadata: ObjectMeta
    spec: PodCliqueSetSpec

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSet":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata", {}) or {}),
            spec=PodCliqueSetSpec.from_dict(d.get("spec", {}) or {}),
        )

    def clique_template(self, name: str) -> Optional[PodCliqueTemplateSpec]:
        for c in self.spec.template.cliques:
            if c.name == name:
                return c
        return None

    def standalone_clique_templates(self) -> list[PodCliqueTemplateSpec]:
        """Cliques NOT belonging to any scaling group."""
        in_group = {n for cfg in self.spec.template.pod_clique_scaling_group_configs for n in cfg.clique_names}
        return [c for c in self.spec.template.cliques if c.name not in in_group]
