"""Core workload API: PodCliqueSet / PodClique / PodCliqueScalingGroup / ClusterTopology.

Semantic parity with the reference core API (operator/api/core/v1alpha1/):
  - PodCliqueSetSpec / TemplateSpec with cliques, startup type, terminationDelay,
    scaling-group configs (podcliqueset.go:52-58,126-159)
  - CliqueStartupType {AnyOrder, InOrder, Explicit} (podcliqueset.go:249-257)
  - PodCliqueSpec with RoleName, Replicas, MinAvailable, StartsAfter, ScaleConfig
    (podclique.go:54-79); AutoScalingConfig (podclique.go:82-101)
  - PodCliqueScalingGroupConfig with dual-purpose MinAvailable (podcliqueset.go:216-227)
  - TopologyConstraint{PackDomain} (podcliqueset.go:188-197)
  - TopologyDomain 7-level hierarchy with ordering (clustertopology.go:92-136)
  - Rolling-update progress types (podcliqueset.go:96-118, podclique.go:140-164)

These are plain dataclasses (the "CRD" layer); everything tensor-shaped lives in
grove_tpu/state. All objects round-trip from the reference's YAML shapes via
``from_dict`` so the reference sample workloads load unmodified.

The port's copy of grove_tpu/api/types.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Any, Optional

from grove_tpu_torch.api.quantity import parse_quantity

# ---------------------------------------------------------------------------------
# Topology domains (clustertopology.go:92-136)
# ---------------------------------------------------------------------------------


class TopologyDomain(str, enum.Enum):
    """Seven-level topology hierarchy, broadest → narrowest.

    TPU mapping: `region`/`zone`/`datacenter` ride DCN; `block` ≈ a pod of
    slices, `rack` ≈ one slice (ICI domain), `host` ≈ one host's chips,
    `numa` ≈ chips behind one PCIe/NUMA node.
    """

    REGION = "region"
    ZONE = "zone"
    DATACENTER = "datacenter"
    BLOCK = "block"
    RACK = "rack"
    HOST = "host"
    NUMA = "numa"


# Lower value = broader scope (clustertopology.go:124-136).
TOPOLOGY_DOMAIN_ORDER: dict[TopologyDomain, int] = {
    TopologyDomain.REGION: 0,
    TopologyDomain.ZONE: 1,
    TopologyDomain.DATACENTER: 2,
    TopologyDomain.BLOCK: 3,
    TopologyDomain.RACK: 4,
    TopologyDomain.HOST: 5,
    TopologyDomain.NUMA: 6,
}


def is_domain_narrower(d: TopologyDomain, other: TopologyDomain) -> bool:
    """True if `d` is narrower (more specific) than `other` (clustertopology.go:110-112)."""
    return TOPOLOGY_DOMAIN_ORDER[d] > TOPOLOGY_DOMAIN_ORDER[other]


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
    """Cluster-scoped topology declaration (clustertopology.go:40).

    The operator auto-appends the `host` level bound to `kubernetes.io/hostname`
    if absent (internal/clustertopology/clustertopology.go:102-107).
    """

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
        if self.label_key_for(TopologyDomain.HOST) is not None:
            return self
        return ClusterTopology(
            name=self.name,
            levels=[*self.levels, TopologyLevel(TopologyDomain.HOST, "kubernetes.io/hostname")],
        )

    def levels_doc(self) -> list[dict]:
        """The wire shape of the effective hierarchy (host level included,
        broadest first) — the ONE rendering both the synced ClusterTopology
        CR and /statusz (CLI `get topology`) use."""
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


DEFAULT_CLUSTER_TOPOLOGY = ClusterTopology(
    name="default",
    levels=[
        TopologyLevel(TopologyDomain.ZONE, "topology.kubernetes.io/zone"),
        TopologyLevel(TopologyDomain.BLOCK, "topology.kubernetes.io/block"),
        TopologyLevel(TopologyDomain.RACK, "topology.kubernetes.io/rack"),
        TopologyLevel(TopologyDomain.HOST, "kubernetes.io/hostname"),
    ],
)


# ---------------------------------------------------------------------------------
# Shared metadata / pod template primitives
# ---------------------------------------------------------------------------------


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    uid: str = ""
    generation: int = 1
    finalizers: list[str] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: Optional[float] = None
    owner: Optional[str] = None  # FQN of owning object (controller ref analog)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            labels=dict(d.get("labels", {}) or {}),
            annotations=dict(d.get("annotations", {}) or {}),
        )


@dataclass
class Container:
    name: str
    image: str = ""
    command: list[str] = field(default_factory=list)
    args: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    # Deferred env vars (`valueFrom` downward-API/fieldRef entries) kept verbatim
    # so nothing from a loaded workload is silently dropped.
    env_value_from: dict[str, dict] = field(default_factory=dict)
    requests: dict[str, float] = field(default_factory=dict)  # base units
    limits: dict[str, float] = field(default_factory=dict)
    ports: list[int] = field(default_factory=list)
    # [{"name": ..., "mountPath": ...}] — fulfilled by the node runtime
    # against PodSpec.volumes (the kubelet contract).
    volume_mounts: list[dict] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Container":
        res = d.get("resources", {}) or {}
        requests = {k: parse_quantity(v) for k, v in (res.get("requests", {}) or {}).items()}
        limits = {k: parse_quantity(v) for k, v in (res.get("limits", {}) or {}).items()}
        env: dict[str, str] = {}
        env_value_from: dict[str, dict] = {}
        for e in d.get("env", []) or []:
            if "valueFrom" in e:
                env_value_from[e["name"]] = e["valueFrom"]
            elif "value" in e:
                env[e["name"]] = str(e["value"])
        ports = [p.get("containerPort") for p in d.get("ports", []) or [] if "containerPort" in p]
        return cls(
            name=d["name"],
            image=d.get("image", ""),
            command=list(d.get("command", []) or []),
            args=list(d.get("args", []) or []),
            env=env,
            env_value_from=env_value_from,
            requests=requests,
            limits=limits,
            ports=ports,
            volume_mounts=[dict(v) for v in d.get("volumeMounts", []) or []],
        )


@dataclass
class PodSpec:
    """The subset of corev1.PodSpec that drives placement and lifecycle."""

    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    node_selector: dict[str, str] = field(default_factory=dict)
    priority_class_name: str = ""
    restart_policy: str = "Always"
    termination_grace_period_seconds: int = 30
    scheduling_gates: list[str] = field(default_factory=list)
    hostname: str = ""
    subdomain: str = ""
    tolerations: list[dict] = field(default_factory=list)
    resource_claims: list[dict] = field(default_factory=list)  # MNNVL/ICI analog
    # Declared volumes ([{"name": ..., "secret": {"secretName": ...}}, ...]);
    # the runtime materializes them for the containers' volume_mounts.
    volumes: list[dict] = field(default_factory=list)

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
            priority_class_name=d.get("priorityClassName", ""),
            restart_policy=d.get("restartPolicy", "Always") or "Always",
            # `or 30` would coerce an explicit 0 (force-immediate-kill, a
            # standard k8s idiom) back to the default — only None defaults.
            termination_grace_period_seconds=(
                30
                if d.get("terminationGracePeriodSeconds") is None
                else d["terminationGracePeriodSeconds"]
            ),
            tolerations=list(d.get("tolerations", []) or []),
            resource_claims=list(d.get("resourceClaims", []) or []),
            volumes=[dict(v) for v in d.get("volumes", []) or []],
        )


# ---------------------------------------------------------------------------------
# Workload topology constraint (podcliqueset.go:188-197)
# ---------------------------------------------------------------------------------


@dataclass
class TopologyConstraint:
    """Pack each replica instance within one domain of `pack_domain`.

    NOTE: this constrains EACH replica independently — different replicas may
    land in different domains (podcliqueset.go:190-196).

    `preferred_domain` is the soft counterpart (wire key `preferredDomain`):
    the scheduler tries to pack the replica into one domain at that level
    and degrades the gang's PlacementScore — never rejects — when it cannot
    (the Required/Preferred pair of the scheduler IR's
    TopologyPackConstraint, podgang.go:101-117). Either field may be unset;
    a constraint with both packs hard at `pack_domain` and scores soft at
    `preferred_domain` (which must be equal or narrower to mean anything).
    """

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
            preferred_domain=(
                TopologyDomain(preferred) if preferred is not None else None
            ),
        )


# ---------------------------------------------------------------------------------
# Autoscaling (podclique.go:82-101)
# ---------------------------------------------------------------------------------


@dataclass
class AutoScalingConfig:
    """HPA-shaped autoscaling config: min/max replicas + metric specs."""

    max_replicas: int
    min_replicas: Optional[int] = None  # defaulted to .Replicas by webhook
    metrics: list[dict[str, Any]] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> Optional["AutoScalingConfig"]:
        if not d:
            return None
        return cls(
            max_replicas=int(d["maxReplicas"]),
            min_replicas=int(d["minReplicas"]) if d.get("minReplicas") is not None else None,
            metrics=list(d.get("metrics", []) or []),
        )


# ---------------------------------------------------------------------------------
# PodClique (podclique.go)
# ---------------------------------------------------------------------------------


class CliqueStartupType(str, enum.Enum):
    """Startup ordering across cliques (podcliqueset.go:249-257)."""

    ANY_ORDER = "CliqueStartupTypeAnyOrder"
    IN_ORDER = "CliqueStartupTypeInOrder"
    EXPLICIT = "CliqueStartupTypeExplicit"


@dataclass
class PodCliqueSpec:
    """Spec of one clique role (podclique.go:54-79)."""

    role_name: str
    pod_spec: PodSpec
    replicas: int = 0  # defaulted to 1
    min_available: Optional[int] = None  # defaulted to replicas
    starts_after: list[str] = field(default_factory=list)
    scale_config: Optional[AutoScalingConfig] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSpec":
        return cls(
            role_name=d.get("roleName", ""),
            pod_spec=PodSpec.from_dict(d.get("podSpec", {}) or {}),
            replicas=int(d.get("replicas", 0) or 0),
            min_available=int(d["minAvailable"]) if d.get("minAvailable") is not None else None,
            starts_after=list(d.get("startsAfter", []) or []),
            scale_config=AutoScalingConfig.from_dict(d.get("autoScalingConfig")),
        )


@dataclass
class PodCliqueTemplateSpec:
    """Named clique template inside a PodCliqueSet (podcliqueset.go:160-186)."""

    name: str
    spec: PodCliqueSpec
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueTemplateSpec":
        return cls(
            name=d["name"],
            spec=PodCliqueSpec.from_dict(d.get("spec", {}) or {}),
            labels=dict(d.get("labels", {}) or {}),
            annotations=dict(d.get("annotations", {}) or {}),
            topology_constraint=TopologyConstraint.from_dict(d.get("topologyConstraint")),
        )


@dataclass
class PodCliqueStatus:
    """Status rollup for a PodClique (podclique.go:104-137)."""

    replicas: int = 0
    ready_replicas: int = 0
    scheduled_replicas: int = 0
    # Pods still holding the podgang-pending scheduling gate
    # (scheduleGatedReplicas, podclique.go status).
    schedule_gated_replicas: int = 0
    updated_replicas: int = 0
    conditions: list["Condition"] = field(default_factory=list)
    current_pod_template_hash: Optional[str] = None
    current_pcs_generation_hash: Optional[str] = None
    selector: str = ""
    last_errors: list[str] = field(default_factory=list)


@dataclass
class PodClique:
    """The PodClique CR: one role's pods within one PCS replica."""

    metadata: ObjectMeta
    spec: PodCliqueSpec
    status: PodCliqueStatus = field(default_factory=PodCliqueStatus)
    # Denormalized bookkeeping (reference keeps these in labels):
    template_name: str = ""
    pcs_name: str = ""
    pcs_replica_index: int = 0
    pcsg_name: Optional[str] = None  # FQN of owning PCSG, if any
    pcsg_replica_index: Optional[int] = None
    pod_gang_name: str = ""
    topology_constraint: Optional[TopologyConstraint] = None

    @property
    def min_available(self) -> int:
        return self.spec.min_available if self.spec.min_available is not None else self.spec.replicas


# ---------------------------------------------------------------------------------
# PodCliqueScalingGroup (scalinggroup.go)
# ---------------------------------------------------------------------------------


@dataclass
class PodCliqueScalingGroupConfig:
    """Template-level scaling-group config (podcliqueset.go:200-236).

    MinAvailable is dual-purpose (scalinggroup.go:56-67): the gang-scheduling
    floor (PCSG replicas [0, minAvailable) join the base PodGang; the rest get
    scaled PodGangs) AND the gang-termination threshold.
    """

    name: str
    clique_names: list[str]
    replicas: int = 1
    min_available: int = 1
    scale_config: Optional[AutoScalingConfig] = None
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueScalingGroupConfig":
        return cls(
            name=d["name"],
            clique_names=list(d.get("cliqueNames", []) or []),
            replicas=int(d["replicas"]) if d.get("replicas") is not None else 1,
            min_available=int(d["minAvailable"]) if d.get("minAvailable") is not None else 1,
            scale_config=AutoScalingConfig.from_dict(d.get("scaleConfig")),
            topology_constraint=TopologyConstraint.from_dict(d.get("topologyConstraint")),
        )


@dataclass
class PodCliqueScalingGroupSpec:
    """Spec of the PCSG CR materialized per PCS replica (scalinggroup.go:51-71)."""

    clique_names: list[str]
    replicas: int = 1
    min_available: int = 1

    @classmethod
    def from_config(cls, cfg: PodCliqueScalingGroupConfig) -> "PodCliqueScalingGroupSpec":
        return cls(
            clique_names=list(cfg.clique_names),
            replicas=cfg.replicas,
            min_available=cfg.min_available,
        )


@dataclass
class PodCliqueScalingGroupStatus:
    replicas: int = 0
    scheduled_replicas: int = 0
    available_replicas: int = 0
    updated_replicas: int = 0
    conditions: list["Condition"] = field(default_factory=list)
    rolling_update_progress: Optional["PCSGRollingUpdateProgress"] = None
    selector: str = ""
    last_errors: list[str] = field(default_factory=list)


@dataclass
class PodCliqueScalingGroup:
    metadata: ObjectMeta
    spec: PodCliqueScalingGroupSpec
    status: PodCliqueScalingGroupStatus = field(default_factory=PodCliqueScalingGroupStatus)
    template_name: str = ""  # config name within the PCS template
    pcs_name: str = ""
    pcs_replica_index: int = 0
    topology_constraint: Optional[TopologyConstraint] = None


# ---------------------------------------------------------------------------------
# Rolling update progress (podcliqueset.go:96-118, scalinggroup.go:106-129)
# ---------------------------------------------------------------------------------


@dataclass
class PodCliqueSetRollingUpdateProgress:
    update_started_at: float = 0.0
    update_ended_at: Optional[float] = None
    current_replica_index: Optional[int] = None
    updated_replica_indices: list[int] = field(default_factory=list)


@dataclass
class PCSGRollingUpdateProgress:
    update_started_at: float = 0.0
    update_ended_at: Optional[float] = None
    current_replica_index: Optional[int] = None
    updated_replica_indices: list[int] = field(default_factory=list)


# ---------------------------------------------------------------------------------
# PodCliqueSet (podcliqueset.go)
# ---------------------------------------------------------------------------------


@dataclass
class HeadlessServiceConfig:
    publish_not_ready_addresses: bool = True


@dataclass
class PodCliqueSetTemplateSpec:
    """The per-replica template (podcliqueset.go:126-159)."""

    cliques: list[PodCliqueTemplateSpec] = field(default_factory=list)
    startup_type: CliqueStartupType = CliqueStartupType.ANY_ORDER
    pod_clique_scaling_group_configs: list[PodCliqueScalingGroupConfig] = field(default_factory=list)
    termination_delay_seconds: float = 4 * 3600.0  # default 4h (podcliqueset.go:154)
    priority_class_name: str = ""
    # SLO tier (constants.SLO_CLASSES): admission order, borrowing
    # eligibility, preemptibility (docs/design.md "Multi-tenant SLO
    # tiers"). "" on load; defaulting fills "standard".
    slo_class: str = ""
    headless_service_config: Optional[HeadlessServiceConfig] = None
    topology_constraint: Optional[TopologyConstraint] = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "PodCliqueSetTemplateSpec":
        term = d.get("terminationDelay")
        if term is None:
            term_s = 4 * 3600.0
        elif isinstance(term, (int, float)):
            term_s = float(term)
        else:
            term_s = _parse_duration(term)
        hs = d.get("headlessServiceConfig")
        return cls(
            cliques=[PodCliqueTemplateSpec.from_dict(c) for c in d.get("cliques", []) or []],
            # CRD JSON tag is `cliqueStartupType` (reference podcliqueset.go:133);
            # accept `startupType` as a convenience alias.
            startup_type=CliqueStartupType(
                d.get("cliqueStartupType") or d.get("startupType") or CliqueStartupType.ANY_ORDER.value
            ),
            pod_clique_scaling_group_configs=[
                PodCliqueScalingGroupConfig.from_dict(c)
                for c in d.get("podCliqueScalingGroups", d.get("podCliqueScalingGroupConfigs", [])) or []
            ],
            termination_delay_seconds=term_s,
            priority_class_name=d.get("priorityClassName", ""),
            slo_class=d.get("sloClass", ""),
            headless_service_config=(
                HeadlessServiceConfig(bool(hs.get("publishNotReadyAddresses", True))) if hs else None
            ),
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
class PodGangStatusSummary:
    """Per-gang status surfaced in PCS status (podcliqueset.go:262-270)."""

    name: str
    phase: str = "Pending"
    conditions: list["Condition"] = field(default_factory=list)


@dataclass
class PodCliqueSetStatus:
    replicas: int = 0
    updated_replicas: int = 0
    available_replicas: int = 0
    observed_generation: int = 0
    current_generation_hash: Optional[str] = None
    updated_generation_hash: Optional[str] = None
    rolling_update_progress: Optional[PodCliqueSetRollingUpdateProgress] = None
    pod_gang_statuses: list[PodGangStatusSummary] = field(default_factory=list)
    conditions: list["Condition"] = field(default_factory=list)
    last_errors: list[str] = field(default_factory=list)
    selector: str = ""


@dataclass
class PodCliqueSet:
    metadata: ObjectMeta
    spec: PodCliqueSetSpec
    status: PodCliqueSetStatus = field(default_factory=PodCliqueSetStatus)

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

    def scaling_group_for_clique(self, clique_name: str) -> Optional[PodCliqueScalingGroupConfig]:
        for cfg in self.spec.template.pod_clique_scaling_group_configs:
            if clique_name in cfg.clique_names:
                return cfg
        return None

    def standalone_clique_templates(self) -> list[PodCliqueTemplateSpec]:
        """Cliques NOT belonging to any scaling group."""
        in_group = {n for cfg in self.spec.template.pod_clique_scaling_group_configs for n in cfg.clique_names}
        return [c for c in self.spec.template.cliques if c.name not in in_group]


# ---------------------------------------------------------------------------------
# Conditions
# ---------------------------------------------------------------------------------


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


def get_condition(conditions: list[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def set_condition(conditions: list[Condition], cond: Condition, now: float = 0.0) -> list[Condition]:
    """Upsert preserving last_transition_time when status is unchanged."""
    out = []
    found = False
    for c in conditions:
        if c.type == cond.type:
            found = True
            if c.status == cond.status:
                out.append(_dc_replace(cond, last_transition_time=c.last_transition_time))
            else:
                out.append(_dc_replace(cond, last_transition_time=now))
        else:
            out.append(c)
    if not found:
        out.append(_dc_replace(cond, last_transition_time=now))
    return out


# ---------------------------------------------------------------------------------


def _parse_duration(s: str) -> float:
    """Parse Go-style duration strings: '4h', '30m', '1h30m', '90s', '100ms'."""
    if re.fullmatch(r"(?:[0-9.]+(?:ms|us|ns|h|m|s))+", s) is None:
        raise ValueError(f"invalid duration: {s!r}")
    m = re.findall(r"([0-9.]+)(ms|us|ns|h|m|s)", s)
    mult = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
    return sum(float(v) * mult[u] for v, u in m)
