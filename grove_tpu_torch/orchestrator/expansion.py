"""PodCliqueSet expansion: PCS → PodCliques, ScalingGroups, PodGangs, Pods.

This is the declarative core of the reconcile cascade (SURVEY.md §1/§3.3),
rebuilt as a pure function: given a defaulted PodCliqueSet and a ClusterTopology,
produce the full desired object set. Parity targets:
  - base/scaled gang split: PCSG replicas [0, minAvailable) join the base gang of
    their PCS replica; replicas [minAvailable, replicas) each get one scaled gang
    (operator/internal/controller/podcliqueset/components/podgang/syncflow.go:166-327)
  - PodGroups carry {PodReferences, MinReplicas=clique minAvailable}
    (syncflow.go:560-581)
  - topology translation: workload PackDomain → IR Required node-label key
    (syncflow.go:341-365); missing domain in the ClusterTopology nullifies the
    constraint rather than erroring
  - PCSG-level constraints become per-PCSG-replica TopologyConstraintGroupConfigs
    over that replica's member PodGroups (scheduler/api podgang.go:120-128)
  - pod build: scheduling gate `grove.io/podgang-pending-creation`, GROVE_* env,
    hostname `<pclqFQN>-<idx>`, subdomain = headless service
    (podclique/components/pod/pod.go:68,135-172,232-269)

The port's copy of grove_tpu/orchestrator/expansion.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Optional

from grove_tpu_torch.api import constants, naming
from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.podgang import (
    IRTopologyConstraint,
    NamespacedName,
    PodGang,
    PodGangSpec,
    PodGroup,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from grove_tpu_torch.api.types import (
    ClusterTopology,
    Container,
    ObjectMeta,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueScalingGroupSpec,
    PodCliqueSet,
    PodCliqueTemplateSpec,
    TopologyConstraint,
    TopologyDomain,
)


@dataclass
class DesiredState:
    """Everything one PodCliqueSet materializes into (the reference's ordered
    component kinds, podcliqueset/reconcilespec.go:206-221)."""

    podcliques: list[PodClique] = field(default_factory=list)
    scaling_groups: list[PodCliqueScalingGroup] = field(default_factory=list)
    podgangs: list[PodGang] = field(default_factory=list)
    pods: list[Pod] = field(default_factory=list)
    # Auxiliary managed resources (api/resources.py): per-replica headless
    # Service objects, HPAs for auto-scaled targets, per-PCS RBAC + SA token.
    services: list = field(default_factory=list)
    hpas: list = field(default_factory=list)
    rbac: list = field(default_factory=list)  # [sa, role, binding, secret]

    @property
    def headless_services(self) -> list[str]:
        """Name view over the Service objects — one source of truth."""
        return [svc.name for svc in self.services]

    def podgang(self, name: str) -> Optional[PodGang]:
        for g in self.podgangs:
            if g.name == name:
                return g
        return None

    def clique(self, fqn: str) -> Optional[PodClique]:
        for c in self.podcliques:
            if c.metadata.name == fqn:
                return c
        return None

    def pods_of_clique(self, fqn: str) -> list[Pod]:
        return [p for p in self.pods if p.pclq_fqn == fqn]

    def pods_of_gang(self, gang_name: str) -> list[Pod]:
        return [p for p in self.pods if p.podgang_name == gang_name]


def compute_pod_template_hash(template: PodCliqueTemplateSpec, priority_class_name: str = "") -> str:
    """Stable short hash over what constitutes a pod *template* change.

    Parity with the reference hash inputs (podcliqueset/reconcilespec.go:109-122 /
    internal/utils/kubernetes/pod.go:125): clique labels + annotations + PodSpec +
    the template-level PriorityClassName. Deliberately EXCLUDES replicas,
    minAvailable, scaleConfig and startsAfter — scaling is not an update.
    """
    h = hashlib.sha256()
    h.update(repr(sorted(template.labels.items())).encode())
    h.update(repr(sorted(template.annotations.items())).encode())
    h.update(repr(template.spec.pod_spec).encode())
    h.update(priority_class_name.encode())
    return h.hexdigest()[:10]


def compute_generation_hash(pcs: PodCliqueSet) -> str:
    """Hash over all clique pod templates (podcliqueset/reconcilespec.go:109-122)."""
    h = hashlib.sha256()
    pcn = pcs.spec.template.priority_class_name
    for clique in pcs.spec.template.cliques:
        h.update(compute_pod_template_hash(clique, pcn).encode())
    return h.hexdigest()[:10]


def translate_pack_constraint(
    tc: TopologyConstraint | None, topology: ClusterTopology | None, tas_enabled: bool = True
) -> Optional[IRTopologyConstraint]:
    """Workload domain name → IR node-label key (podgang/syncflow.go:341-365).

    A domain missing from the ClusterTopology nullifies the constraint (logged
    and skipped in the reference) rather than failing the sync. `packDomain`
    becomes the IR's Required key, `preferredDomain` its Preferred key — the
    Required/Preferred pair of podgang.go:101-117; either may be absent.
    """
    if not tas_enabled or tc is None or topology is None:
        return None
    req_key = (
        topology.label_key_for(tc.pack_domain)
        if tc.pack_domain is not None
        else None
    )
    pref_key = (
        topology.label_key_for(tc.preferred_domain)
        if tc.preferred_domain is not None
        else None
    )
    if req_key is None and pref_key is None:
        return None
    return IRTopologyConstraint(
        pack_constraint=TopologyPackConstraint(required=req_key, preferred=pref_key)
    )


def expand_podcliqueset(
    pcs: PodCliqueSet,
    topology: ClusterTopology | None = None,
    *,
    tas_enabled: bool = True,
    pcsg_replica_overrides: dict[str, int] | None = None,
    pclq_replica_overrides: dict[str, int] | None = None,
    rng: random.Random | None = None,
    auto_slice_enabled: bool = False,
    slice_resource_name: str = constants.DEFAULT_SLICE_RESOURCE,
    initc_server_url: str = "",
    initc_mode: str = "operator",
) -> DesiredState:
    """Expand a defaulted PodCliqueSet into its full desired object set.

    `pcsg_replica_overrides` / `pclq_replica_overrides` carry HPA-mutated scale
    values keyed by FQN (analog of determinePodCliqueReplicas,
    podgang/syncflow.go:368-395).

    `auto_slice_enabled` is the MNNVL-injection analog
    (`internal/mnnvl/injection.go:30-74`): pods requesting the slice resource
    get an ICI-slice resource claim, and their pod groups get a rack-level
    (ICI-domain) required pack-set unless the workload authored one — TPU
    pods of one gang land inside one interconnect domain the way MNNVL gangs
    land inside one NVLink ComputeDomain. A PCS can opt out with the
    annotation grove.io/auto-slice: "disabled" (mnnvl/helpers.go:30-98).
    """
    rng = rng or random.Random(0)
    pcsg_replica_overrides = pcsg_replica_overrides or {}
    pclq_replica_overrides = pclq_replica_overrides or {}
    out = DesiredState()
    ns = pcs.metadata.namespace
    pcs_name = pcs.metadata.name
    tmpl = pcs.spec.template
    gen_hash = compute_generation_hash(pcs)
    # The host level is always present (the reference appends it when building
    # the ClusterTopology CR, internal/clustertopology/clustertopology.go:102-107).
    if topology is not None:
        topology = topology.with_host_level()
    # Per-template hashes, computed once (templates repeat across PCS/PCSG replicas).
    tmpl_hashes = {
        c.name: compute_pod_template_hash(c, tmpl.priority_class_name) for c in tmpl.cliques
    }

    def _new_podgang(
        name: str, pcs_replica: int, base_name: str | None = None, scaled_index: int = -1
    ) -> PodGang:
        return PodGang(
            name=name,
            namespace=ns,
            pcs_name=pcs_name,
            pcs_replica_index=pcs_replica,
            base_podgang_name=base_name,
            scaled_index=scaled_index,
            # Capacity queue rides the PCS annotation (KAI Queue analog);
            # every gang of the set draws from the same queue.
            queue=pcs.metadata.annotations.get(constants.ANNOTATION_QUEUE, ""),
            # SLO tier rides the template; every gang of the set shares it
            # (a scaled gang cannot out-tier its base).
            slo_class=tmpl.slo_class,
            spec=PodGangSpec(
                priority_class_name=tmpl.priority_class_name,
                topology_constraint=translate_pack_constraint(
                    tmpl.topology_constraint, topology, tas_enabled
                ),
                # Replica spread: base gangs only (base_name None); translated
                # to the node-label key like pack constraints so the solver
                # stays label-keyed, not enum-keyed.
                spread_key=(
                    topology.label_key_for(pcs.spec.topology_spread_domain)
                    if base_name is None
                    and tas_enabled
                    and pcs.spec.topology_spread_domain is not None
                    else None
                ),
            ),
        )

    # Per-PCS RBAC + SA token credential objects (serviceaccount/role/
    # rolebinding/satokensecret components).
    from grove_tpu_torch.api.resources import HeadlessService, build_pcs_rbac

    out.rbac = list(build_pcs_rbac(pcs_name, ns))
    _collect_hpas(out, pcs)

    for i in range(pcs.spec.replicas):
        svc = naming.headless_service_name(pcs_name, i)
        out.services.append(
            HeadlessService(
                name=svc,
                namespace=ns,
                pcs_name=pcs_name,
                pcs_replica_index=i,
                publish_not_ready_addresses=True,
                selector={
                    constants.LABEL_PART_OF: pcs_name,
                    constants.LABEL_PCS_REPLICA_INDEX: str(i),
                },
            )
        )
        base_gang = _new_podgang(naming.base_podgang_name(pcs_name, i), i)

        # Standalone cliques — always members of the base gang.
        for clique_tmpl in pcs.standalone_clique_templates():
            fqn = naming.podclique_name(pcs_name, i, clique_tmpl.name)
            replicas = pclq_replica_overrides.get(fqn, clique_tmpl.spec.replicas)
            pclq = _build_podclique(
                pcs, clique_tmpl, fqn, i, base_gang.name, replicas=replicas
            )
            out.podcliques.append(pclq)
            group = _build_pod_group(pclq, clique_tmpl, topology, tas_enabled)
            base_gang.spec.pod_groups.append(group)
            pods = _build_pods(
                pcs, pclq, clique_tmpl, svc, i, gen_hash, rng,
                tmpl_hash=tmpl_hashes[clique_tmpl.name],
                initc_server_url=initc_server_url,
                initc_mode=initc_mode,
            )
            group.pod_references = [NamespacedName(ns, p.name) for p in pods]
            out.pods.extend(pods)

        # Scaling groups.
        for cfg in tmpl.pod_clique_scaling_group_configs:
            pcsg_fqn = naming.scaling_group_name(pcs_name, i, cfg.name)
            pcsg_replicas = pcsg_replica_overrides.get(pcsg_fqn, cfg.replicas)
            pcsg = PodCliqueScalingGroup(
                metadata=ObjectMeta(
                    name=pcsg_fqn,
                    namespace=ns,
                    labels={
                        constants.LABEL_MANAGED_BY: constants.LABEL_MANAGED_BY_VALUE,
                        constants.LABEL_PART_OF: pcs_name,
                        constants.LABEL_PCS_REPLICA_INDEX: str(i),
                    },
                    owner=pcs_name,
                ),
                spec=PodCliqueScalingGroupSpec(
                    clique_names=list(cfg.clique_names),
                    replicas=pcsg_replicas,
                    min_available=cfg.min_available,
                ),
                template_name=cfg.name,
                pcs_name=pcs_name,
                pcs_replica_index=i,
                topology_constraint=cfg.topology_constraint,
            )
            out.scaling_groups.append(pcsg)

            for j in range(pcsg_replicas):
                in_base = j < cfg.min_available
                if in_base:
                    gang = base_gang
                else:
                    gang = _new_podgang(
                        naming.scaled_podgang_name(pcsg_fqn, j - cfg.min_available),
                        i,
                        base_name=base_gang.name,
                        scaled_index=j - cfg.min_available,
                    )
                    out.podgangs.append(gang)

                replica_group_names: list[str] = []
                for clique_name in cfg.clique_names:
                    clique_tmpl = pcs.clique_template(clique_name)
                    if clique_tmpl is None:
                        continue
                    fqn = naming.podclique_name(pcsg_fqn, j, clique_tmpl.name)
                    pclq = _build_podclique(
                        pcs,
                        clique_tmpl,
                        fqn,
                        i,
                        gang.name,
                        replicas=clique_tmpl.spec.replicas,
                        pcsg_name=pcsg_fqn,
                        pcsg_replica_index=j,
                        base_podgang_name=None if in_base else base_gang.name,
                    )
                    out.podcliques.append(pclq)
                    group = _build_pod_group(pclq, clique_tmpl, topology, tas_enabled)
                    gang.spec.pod_groups.append(group)
                    replica_group_names.append(group.name)
                    pods = _build_pods(
                        pcs, pclq, clique_tmpl, svc, i, gen_hash, rng,
                        tmpl_hash=tmpl_hashes[clique_tmpl.name],
                        pcsg_fqn=pcsg_fqn, pcsg_replica=j,
                        base_podgang_name=None if in_base else base_gang.name,
                        initc_server_url=initc_server_url,
                        initc_mode=initc_mode,
                    )
                    group.pod_references = [NamespacedName(ns, p.name) for p in pods]
                    out.pods.extend(pods)

                # PCSG-level packing: all pods of this PCSG replica pack together
                # (one TopologyConstraintGroupConfig per replica).
                sg_tc = translate_pack_constraint(cfg.topology_constraint, topology, tas_enabled)
                if sg_tc is not None and replica_group_names:
                    gang.spec.topology_constraint_group_configs.append(
                        TopologyConstraintGroupConfig(
                            name=f"{pcsg_fqn}-{j}",
                            pod_group_names=replica_group_names,
                            topology_constraint=sg_tc,
                        )
                    )

        out.podgangs.append(base_gang)

    if slice_injection_active(pcs, auto_slice_enabled):
        _inject_tpu_slices(out, pcs, topology, slice_resource_name, tas_enabled)

    # Stable ordering: base gangs in replica order, then scaled gangs by
    # numeric scaled index (NOT name — "-10" must sort after "-2").
    out.podgangs.sort(
        key=lambda g: (g.is_scaled, g.pcs_replica_index, g.scaled_index, g.name)
    )
    return out


def _collect_hpas(out: DesiredState, pcs: PodCliqueSet) -> None:
    """HPA objects per auto-scaled standalone clique and PCSG
    (components/hpa/hpa.go:130,249-259): ScaleTargetRef -> the FQN whose
    scale subresource (cluster.scale_overrides) the controller adjusts."""
    from grove_tpu_torch.api.resources import HorizontalPodAutoscaler

    ns = pcs.metadata.namespace
    for i in range(pcs.spec.replicas):
        for tmpl in pcs.standalone_clique_templates():
            sc = tmpl.spec.scale_config
            if sc is None:
                continue
            fqn = naming.podclique_name(pcs.metadata.name, i, tmpl.name)
            out.hpas.append(
                HorizontalPodAutoscaler(
                    name=f"{fqn}-hpa",
                    namespace=ns,
                    pcs_name=pcs.metadata.name,
                    target_kind="PodClique",
                    target_name=fqn,
                    min_replicas=(
                        sc.min_replicas if sc.min_replicas is not None else tmpl.spec.replicas
                    ),
                    max_replicas=sc.max_replicas,
                    target_spec_replicas=tmpl.spec.replicas,
                    metrics=list(sc.metrics),
                )
            )
        for cfg in pcs.spec.template.pod_clique_scaling_group_configs:
            if cfg.scale_config is None:
                continue
            fqn = naming.scaling_group_name(pcs.metadata.name, i, cfg.name)
            out.hpas.append(
                HorizontalPodAutoscaler(
                    name=f"{fqn}-hpa",
                    namespace=ns,
                    pcs_name=pcs.metadata.name,
                    target_kind="PodCliqueScalingGroup",
                    target_name=fqn,
                    min_replicas=(
                        cfg.scale_config.min_replicas
                        if cfg.scale_config.min_replicas is not None
                        else cfg.replicas
                    ),
                    max_replicas=cfg.scale_config.max_replicas,
                    target_spec_replicas=cfg.replicas,
                    metrics=list(cfg.scale_config.metrics),
                )
            )


def slice_injection_active(pcs: PodCliqueSet, auto_slice_enabled: bool) -> bool:
    """Config gate + per-PCS opt-out annotation (mnnvl/helpers.go:30-98).

    The admission chain defaults grove.io/auto-slice to "enabled" on
    qualifying workloads and rejects "enabled" when the feature is off
    (api/admission.py), so at expansion time the gate is simply: feature on
    and not explicitly opted out."""
    return (
        auto_slice_enabled
        and pcs.metadata.annotations.get(constants.ANNOTATION_AUTO_SLICE)
        != constants.AUTO_SLICE_DISABLED
    )


def template_requests_slice(
    clique_tmpl: PodCliqueTemplateSpec, slice_resource_name: str
) -> bool:
    return clique_tmpl.spec.pod_spec.total_requests().get(slice_resource_name, 0.0) > 0


def inject_slice_claim(pod: Pod, slice_resource_name: str) -> None:
    """Attach the ICI-slice resource claim (ComputeDomain resourceClaim analog
    — consumed by the node runtime, invisible to the bin-packing solver).
    Idempotent: pod replacement re-runs the pod build path."""
    if any(c.get("name") == "tpu-ici-slice" for c in pod.spec.resource_claims):
        return
    pod.spec.resource_claims.append(
        {
            "name": "tpu-ici-slice",
            "source": {
                "sliceResource": slice_resource_name,
                "iciDomain": pod.podgang_name,
            },
        }
    )


def _inject_tpu_slices(
    out: DesiredState,
    pcs: PodCliqueSet,
    topology: ClusterTopology | None,
    slice_resource_name: str,
    tas_enabled: bool,
) -> None:
    """MNNVL-injection analog (injection.go:30-74 + computedomain.go:90-111).

    For every pod group whose template requests the slice resource:
      - each pod gets a resource claim naming its gang's ICI slice;
      - the group gets a required rack-level pack-set (rack == ICI domain in
        the 7-level hierarchy, SURVEY.md §5.8) unless the workload already
        authored a required constraint for it — and only while TAS is
        enabled, matching translate_pack_constraint's nullification of all
        other constraints when it is off.
    """
    rack_key = (
        topology.label_key_for(TopologyDomain.RACK)
        if topology is not None and tas_enabled
        else None
    )
    slice_templates = {
        c.name
        for c in pcs.spec.template.cliques
        if template_requests_slice(c, slice_resource_name)
    }
    if not slice_templates:
        return
    clique_by_name = {c.metadata.name: c for c in out.podcliques}
    slice_groups: set[str] = set()
    for gang in out.podgangs:
        for group in gang.spec.pod_groups:
            clique = clique_by_name.get(group.name)
            if clique is None or clique.template_name not in slice_templates:
                continue
            slice_groups.add(group.name)
            has_required = (
                group.topology_constraint is not None
                and group.topology_constraint.pack_constraint is not None
                and group.topology_constraint.pack_constraint.required is not None
            )
            if rack_key is not None and not has_required:
                # An authored preferred-only constraint keeps its soft level;
                # the injection only supplies the missing hard ICI-domain pack.
                pref = (
                    group.topology_constraint.pack_constraint.preferred
                    if group.topology_constraint is not None
                    and group.topology_constraint.pack_constraint is not None
                    else None
                )
                group.topology_constraint = IRTopologyConstraint(
                    pack_constraint=TopologyPackConstraint(
                        required=rack_key, preferred=pref
                    )
                )
    for pod in out.pods:
        if pod.pclq_fqn in slice_groups:
            inject_slice_claim(pod, slice_resource_name)


def _build_podclique(
    pcs: PodCliqueSet,
    clique_tmpl: PodCliqueTemplateSpec,
    fqn: str,
    pcs_replica: int,
    podgang_name: str,
    *,
    replicas: int,
    pcsg_name: str | None = None,
    pcsg_replica_index: int | None = None,
    base_podgang_name: str | None = None,
) -> PodClique:
    import copy

    spec = copy.deepcopy(clique_tmpl.spec)
    spec.replicas = replicas
    labels = {
        constants.LABEL_MANAGED_BY: constants.LABEL_MANAGED_BY_VALUE,
        constants.LABEL_PART_OF: pcs.metadata.name,
        constants.LABEL_PCS_REPLICA_INDEX: str(pcs_replica),
        constants.LABEL_PODGANG: podgang_name,
        **clique_tmpl.labels,
    }
    if pcsg_name is not None:
        labels[constants.LABEL_SCALING_GROUP] = pcsg_name
        labels[constants.LABEL_PCSG_REPLICA_INDEX] = str(pcsg_replica_index)
    if base_podgang_name is not None:
        labels[constants.LABEL_BASE_PODGANG] = base_podgang_name
    return PodClique(
        metadata=ObjectMeta(
            name=fqn,
            namespace=pcs.metadata.namespace,
            labels=labels,
            annotations=dict(clique_tmpl.annotations),
            owner=pcsg_name or pcs.metadata.name,
        ),
        spec=spec,
        template_name=clique_tmpl.name,
        pcs_name=pcs.metadata.name,
        pcs_replica_index=pcs_replica,
        pcsg_name=pcsg_name,
        pcsg_replica_index=pcsg_replica_index,
        pod_gang_name=podgang_name,
        topology_constraint=clique_tmpl.topology_constraint,
    )


def _build_pod_group(
    pclq: PodClique,
    clique_tmpl: PodCliqueTemplateSpec,
    topology: ClusterTopology | None,
    tas_enabled: bool,
) -> PodGroup:
    return PodGroup(
        name=pclq.metadata.name,
        min_replicas=pclq.min_available,
        topology_constraint=translate_pack_constraint(
            clique_tmpl.topology_constraint, topology, tas_enabled
        ),
    )


INITC_CONTAINER_NAME = "grove-initc"


def initc_args(
    pcs: PodCliqueSet, pclq: PodClique, clique_tmpl: PodCliqueTemplateSpec
) -> list[str] | None:
    """Startup-ordering agent args for one clique's pods, or None when the
    clique has no parents (initcontainer.go:142-158). Invariant across the
    replica loop — compute once per clique."""
    from grove_tpu_torch.orchestrator.startup import parent_template_names, resolve_parent_fqns

    parents = parent_template_names(pcs, clique_tmpl.name)
    if not parents:
        return None
    reqs: list[str] = []
    for parent_tmpl in parents:
        parent = pcs.clique_template(parent_tmpl)
        min_avail = parent.spec.min_available if parent is not None else 1
        for parent_fqn in resolve_parent_fqns(None, pcs, pclq, parent_tmpl):
            reqs.append(f"{parent_fqn}:{min_avail}")
    return [f"--podcliques={','.join(reqs)}"]


# Where the runtime mounts the PCS's SA token secret inside the pod (the
# projected-token volume analog); the injected agent reads it from here.
INITC_TOKEN_MOUNT_DIR = "/var/run/secrets/grove.io/sa-token"
INITC_TOKEN_MOUNT = f"{INITC_TOKEN_MOUNT_DIR}/token"
INITC_TOKEN_VOLUME = "grove-sa-token"


def _inject_initc(
    spec,
    args: list[str],
    pcs_name: str,
    server_url: str = "",
    initc_mode: str = "operator",
) -> None:
    """Inject the startup-ordering init container (initcontainer.go:51,98-126);
    its args are exactly what the agent binary consumes (python -m
    grove_tpu_torch.initc). The SA-token distribution is DECLARED in the pod spec
    the way the reference declares it: a secret volume + mount the node
    runtime fulfills (satokensecret component + projected volume); the agent
    reads the mounted file via --token-file.

    `initc_mode` kubernetes (cluster.initcMode): the agent gates on the
    kube-apiserver directly (--kube, the reference's own informer path) —
    no operator URL in the pod; the mounted secret then carries a REAL SA
    token the apiserver honors (sync_rbac mirrors SA/Role/RoleBinding and a
    service-account-token Secret)."""
    if any(c.name == INITC_CONTAINER_NAME for c in spec.init_containers):
        return
    secret_name = naming.initc_sa_token_secret_name(pcs_name)
    if not any(v.get("name") == INITC_TOKEN_VOLUME for v in spec.volumes):
        spec.volumes.append(
            {"name": INITC_TOKEN_VOLUME, "secret": {"secretName": secret_name}}
        )
    if initc_mode == "kubernetes":
        # No explicit --namespace: the operator mirrors gang pods (and the
        # per-PCS RBAC) into cluster.kubeNamespace, which the store-level
        # PCS namespace need not match — the agent's in-cluster
        # namespace-file fallback names the namespace the pod actually
        # runs in, which is by construction where its gang lives.
        mode_args = ["--kube"]
    else:
        # --server: the operator's advertised URL (servers.advertiseUrl);
        # unset keeps the agent's localhost default (single-host runs).
        mode_args = [f"--server={server_url}"] if server_url else []
    spec.init_containers.append(
        Container(
            name=INITC_CONTAINER_NAME,
            image="grove-initc",
            # The agent binary inside the grove-initc image: the same
            # container whichever package placed the pod.
            command=["python", "-m", "grove_tpu.initc"],
            args=list(args) + mode_args + [f"--token-file={INITC_TOKEN_MOUNT}"],
            volume_mounts=[
                {"name": INITC_TOKEN_VOLUME, "mountPath": INITC_TOKEN_MOUNT_DIR}
            ],
        )
    )


def _build_pods(
    pcs: PodCliqueSet,
    pclq: PodClique,
    clique_tmpl: PodCliqueTemplateSpec,
    headless_service: str,
    pcs_replica: int,
    gen_hash: str,
    rng: random.Random,
    *,
    tmpl_hash: str | None = None,
    pcsg_fqn: str | None = None,
    pcsg_replica: int | None = None,
    base_podgang_name: str | None = None,
    initc_server_url: str = "",
    initc_mode: str = "operator",
) -> list[Pod]:
    """Build the pods of one clique (podclique/components/pod/pod.go:135-269)."""
    import copy

    pods = []
    if tmpl_hash is None:
        tmpl_hash = compute_pod_template_hash(clique_tmpl)
    fqn = pclq.metadata.name
    startup_args = initc_args(pcs, pclq, clique_tmpl)
    for idx in range(pclq.spec.replicas):
        env = {
            constants.ENV_PCS_NAME: pcs.metadata.name,
            constants.ENV_PCS_INDEX: str(pcs_replica),
            constants.ENV_PCLQ_NAME: fqn,
            constants.ENV_PCLQ_POD_INDEX: str(idx),
            constants.ENV_HEADLESS_SERVICE: naming.headless_service_address(
                pcs.metadata.name, pcs_replica, pcs.metadata.namespace
            ),
        }
        if pcsg_fqn is not None:
            env[constants.ENV_PCSG_NAME] = pcsg_fqn
            env[constants.ENV_PCSG_INDEX] = str(pcsg_replica)
        labels = {
            constants.LABEL_MANAGED_BY: constants.LABEL_MANAGED_BY_VALUE,
            constants.LABEL_PART_OF: pcs.metadata.name,
            constants.LABEL_PODCLIQUE: fqn,
            constants.LABEL_PODGANG: pclq.pod_gang_name,
            constants.LABEL_PCS_REPLICA_INDEX: str(pcs_replica),
            constants.LABEL_POD_TEMPLATE_HASH: tmpl_hash,
            constants.LABEL_PCS_GENERATION_HASH: gen_hash,
            constants.LABEL_POD_INDEX: str(idx),
        }
        if base_podgang_name is not None:
            labels[constants.LABEL_BASE_PODGANG] = base_podgang_name
        if pcsg_fqn is not None:
            # Member pods carry the PCSG identity (the reference labels
            # member cliques and their pods the same way,
            # podcliquescalinggroup/components/podclique/podclique.go:209)
            # — the PCSG's HPA status.selector selects by this label.
            labels[constants.LABEL_SCALING_GROUP] = pcsg_fqn
            labels[constants.LABEL_PCSG_REPLICA_INDEX] = str(pcsg_replica)
        spec = copy.deepcopy(clique_tmpl.spec.pod_spec)
        spec.hostname = naming.pod_hostname(fqn, idx)
        spec.subdomain = headless_service
        if startup_args is not None:
            _inject_initc(
                spec, startup_args, pcs.metadata.name, initc_server_url,
                initc_mode=initc_mode,
            )
        pods.append(
            Pod(
                name=naming.pod_name(fqn, rng),
                namespace=pcs.metadata.namespace,
                labels=labels,
                spec=spec,
                pclq_fqn=fqn,
                podgang_name=pclq.pod_gang_name,
                base_podgang_name=base_podgang_name,
                pod_index=idx,
                pod_template_hash=tmpl_hash,
                env=env,
                scheduling_gates=[constants.POD_GANG_SCHEDULING_GATE],
            )
        )
    return pods
