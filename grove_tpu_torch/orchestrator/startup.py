"""Startup ordering — the grove-initc analog.

The reference injects an init container into pods of cliques with StartsAfter;
it watches the gang's pods and exits once every parent clique has >=
minAvailable Ready pods (operator/initc/internal/wait.go:111-275). Here the
same gate is a pure predicate the simulator (or a real in-pod agent) evaluates
before letting a pod's user containers start.

Startup types (podcliqueset.go:249-257):
  AnyOrder  — no parents
  InOrder   — parents = the clique immediately before it in template order
  Explicit  — parents = PodClique.StartsAfter

The port's copy of grove_tpu/orchestrator/startup.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from grove_tpu_torch.api import naming
from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.types import CliqueStartupType, PodClique, PodCliqueSet
from grove_tpu_torch.orchestrator.store import Cluster


def parent_template_names(pcs: PodCliqueSet, clique_template_name: str) -> list[str]:
    """Template names of the cliques that must be Ready first."""
    tmpl = pcs.spec.template
    order = [c.name for c in tmpl.cliques]
    if tmpl.startup_type == CliqueStartupType.ANY_ORDER:
        return []
    if tmpl.startup_type == CliqueStartupType.IN_ORDER:
        idx = order.index(clique_template_name)
        return [order[idx - 1]] if idx > 0 else []
    clique = pcs.clique_template(clique_template_name)
    return list(clique.spec.starts_after) if clique else []


def resolve_parent_fqns(
    cluster: Cluster, pcs: PodCliqueSet, child: PodClique, parent_template: str
) -> list[str]:
    """Parent clique FQNs in the child's context — mirrors how the reference
    computes the initc `--podcliques=<fqn>:<minAvailable>` args at pod build
    time (podclique/components/pod/initcontainer.go:142-158):

      - parent in the SAME scaling group      → the child's own PCSG replica
      - parent standalone                     → the PCS replica's clique
      - parent in another scaling group       → that group's base-gang replicas
                                                 [0, minAvailable)
    """
    i = child.pcs_replica_index
    child_sg = None
    parent_sg = None
    for cfg in pcs.spec.template.pod_clique_scaling_group_configs:
        if child.template_name in cfg.clique_names:
            child_sg = cfg
        if parent_template in cfg.clique_names:
            parent_sg = cfg
    if parent_sg is None:
        return [naming.podclique_name(pcs.metadata.name, i, parent_template)]
    sg_fqn = naming.scaling_group_name(pcs.metadata.name, i, parent_sg.name)
    if child_sg is not None and child_sg.name == parent_sg.name:
        return [naming.podclique_name(sg_fqn, child.pcsg_replica_index, parent_template)]
    return [
        naming.podclique_name(sg_fqn, j, parent_template)
        for j in range(parent_sg.min_available)
    ]


def may_start(cluster: Cluster, pod: Pod) -> bool:
    """Gate evaluated when the pod's containers would start (initc exit test):
    every parent clique has ready >= minAvailable (wait.go:240-275)."""
    clique = cluster.podcliques.get(pod.pclq_fqn)
    if clique is None:
        return True
    pcs = cluster.podcliquesets.get(clique.pcs_name)
    if pcs is None:
        return True
    for parent_tmpl in parent_template_names(pcs, clique.template_name):
        for parent_fqn in resolve_parent_fqns(cluster, pcs, clique, parent_tmpl):
            parent = cluster.podcliques.get(parent_fqn)
            if parent is None:
                return False
            ready = sum(1 for p in cluster.pods_of_clique(parent_fqn) if p.ready and p.is_active)
            if ready < parent.min_available:
                return False
    return True
