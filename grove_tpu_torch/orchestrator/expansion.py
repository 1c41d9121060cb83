"""PodCliqueSet expansion: PCS → PodGangs and Pods (grove_tpu/orchestrator/
expansion.py counterpart, cut to the objects placement reads).

Parity targets:
  - base/scaled gang split: PCSG replicas [0, minAvailable) join the base gang of
    their PCS replica; replicas [minAvailable, replicas) each get one scaled gang
    (operator/internal/controller/podcliqueset/components/podgang/syncflow.go:166-327)
  - PodGroups carry {PodReferences, MinReplicas=clique minAvailable}
    (syncflow.go:560-581)
  - topology translation: workload PackDomain → IR Required node-label key
    (syncflow.go:341-365); a domain missing from the ClusterTopology nullifies
    the constraint rather than erroring
  - PCSG-level constraints become per-PCSG-replica TopologyConstraintGroupConfigs
    over that replica's member PodGroups (scheduler/api podgang.go:120-128)
  - pod names `<pclqFQN>-<5char suffix>` drawn from a Random(0) per expansion,
    in the JAX package's pod order, so both packages name pods alike
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass, field
from typing import Optional

from grove_tpu_torch.api import naming
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
    PodCliqueSet,
    PodCliqueTemplateSpec,
    TopologyConstraint,
)


@dataclass
class DesiredState:
    """The gangs and pods one PodCliqueSet materializes into."""

    podgangs: list[PodGang] = field(default_factory=list)
    pods: list[Pod] = field(default_factory=list)


def translate_pack_constraint(
    tc: TopologyConstraint | None, topology: ClusterTopology | None
) -> Optional[IRTopologyConstraint]:
    """Workload domain name → IR node-label key (podgang/syncflow.go:341-365).
    `packDomain` becomes the IR's Required key, `preferredDomain` its
    Preferred key; either may be absent."""
    if tc is None or topology is None:
        return None
    req_key = topology.label_key_for(tc.pack_domain) if tc.pack_domain is not None else None
    pref_key = (
        topology.label_key_for(tc.preferred_domain) if tc.preferred_domain is not None else None
    )
    if req_key is None and pref_key is None:
        return None
    return IRTopologyConstraint(
        pack_constraint=TopologyPackConstraint(required=req_key, preferred=pref_key)
    )


def expand_podcliqueset(pcs: PodCliqueSet, topology: ClusterTopology | None = None) -> DesiredState:
    """Expand a defaulted PodCliqueSet into its gangs and pods."""
    rng = random.Random(0)
    out = DesiredState()
    ns = pcs.metadata.namespace
    pcs_name = pcs.metadata.name
    tmpl = pcs.spec.template
    # The host level is always present (the reference appends it when building
    # the ClusterTopology CR, internal/clustertopology/clustertopology.go:102-107).
    if topology is not None:
        topology = topology.with_host_level()

    def new_podgang(name: str, pcs_replica: int, base_name: str | None = None,
                    scaled_index: int = -1) -> PodGang:
        spread = pcs.spec.topology_spread_domain
        return PodGang(
            name=name,
            pcs_name=pcs_name,
            pcs_replica_index=pcs_replica,
            base_podgang_name=base_name,
            scaled_index=scaled_index,
            slo_class=tmpl.slo_class,
            spec=PodGangSpec(
                topology_constraint=translate_pack_constraint(tmpl.topology_constraint, topology),
                # Replica spread: base gangs only, as a node-label key.
                spread_key=(
                    topology.label_key_for(spread)
                    if base_name is None and spread is not None
                    else None
                ),
            ),
        )

    def add_clique(gang: PodGang, clique_tmpl: PodCliqueTemplateSpec, fqn: str) -> PodGroup:
        spec = clique_tmpl.spec
        group = PodGroup(
            name=fqn,
            min_replicas=spec.min_available if spec.min_available is not None else spec.replicas,
            topology_constraint=translate_pack_constraint(clique_tmpl.topology_constraint, topology),
        )
        for _ in range(spec.replicas):
            pod = Pod(
                name=naming.pod_name(fqn, rng),
                namespace=ns,
                spec=copy.copy(spec.pod_spec),
                pclq_fqn=fqn,
                podgang_name=gang.name,
            )
            group.pod_references.append(NamespacedName(ns, pod.name))
            out.pods.append(pod)
        gang.spec.pod_groups.append(group)
        return group

    for i in range(pcs.spec.replicas):
        base_gang = new_podgang(naming.base_podgang_name(pcs_name, i), i)

        # Standalone cliques — always members of the base gang.
        for clique_tmpl in pcs.standalone_clique_templates():
            add_clique(base_gang, clique_tmpl, naming.podclique_name(pcs_name, i, clique_tmpl.name))

        # Scaling groups.
        for cfg in tmpl.pod_clique_scaling_group_configs:
            pcsg_fqn = naming.scaling_group_name(pcs_name, i, cfg.name)
            sg_tc = translate_pack_constraint(cfg.topology_constraint, topology)
            for j in range(cfg.replicas):
                if j < cfg.min_available:
                    gang = base_gang
                else:
                    k = j - cfg.min_available
                    gang = new_podgang(
                        naming.scaled_podgang_name(pcsg_fqn, k), i,
                        base_name=base_gang.name, scaled_index=k,
                    )
                    out.podgangs.append(gang)
                group_names = []
                for name in cfg.clique_names:
                    clique_tmpl = pcs.clique_template(name)
                    if clique_tmpl is not None:
                        fqn = naming.podclique_name(pcsg_fqn, j, name)
                        group_names.append(add_clique(gang, clique_tmpl, fqn).name)
                # PCSG-level packing: all pods of this PCSG replica pack together.
                if sg_tc is not None and group_names:
                    gang.spec.topology_constraint_group_configs.append(
                        TopologyConstraintGroupConfig(
                            name=f"{pcsg_fqn}-{j}",
                            pod_group_names=group_names,
                            topology_constraint=sg_tc,
                        )
                    )

        out.podgangs.append(base_gang)

    # Stable ordering: base gangs in replica order, then scaled gangs by
    # numeric scaled index (NOT name — "-10" must sort after "-2").
    out.podgangs.sort(key=lambda g: (g.is_scaled, g.pcs_replica_index, g.scaled_index, g.name))
    return out
