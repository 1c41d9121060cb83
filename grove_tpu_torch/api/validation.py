"""Admission validation, parity with the validating webhook
(operator/internal/webhook/admission/pcs/validation/podcliqueset.go and
topologyconstraints.go).

Rules (reference line numbers in parens):
  - PCS name <= 45 chars so generated pod names fit 63 (podcliqueset.go:37-39,564)
  - at least one clique (116); unique clique names + role names (138-139)
  - clique: replicas > 0 (350); 0 < minAvailable <= replicas (358-362)
  - startsAfter: non-empty names, no self-reference, unique (369-375); every
    dependency exists (303); no cycles (309)
  - clique scaleConfig: minReplicas >= minAvailable (406), maxReplicas >=
    minReplicas (409), maxReplicas >= replicas (381)
  - PCSG: unique names (236); clique names exist; no clique in two groups (238);
    replicas > 0 (209); minAvailable > 0 (215); minAvailable <= replicas (222);
    scaleConfig.minReplicas >= minAvailable (229); member cliques must not have
    individual autoscaling (podcliqueset.go API note :202)
  - terminationDelay > 0 (260)
  - topology constraints: domain must exist in the cluster topology; child
    constraints must be equal-or-narrower than parent (PCS >= PCSG >= PCLQ)
    (topologyconstraints.go)
  - update immutability: minAvailable, clique set/order under InOrder/Explicit
    startup (492-544)
"""

from __future__ import annotations

from dataclasses import dataclass

from grove_tpu_torch.api.constants import (
    ANNOTATION_ROLLOUT_STRATEGY,
    MAX_PCS_NAME_LENGTH,
    ROLLOUT_STRATEGIES,
    SLO_CLASSES,
)
from grove_tpu_torch.api.types import (
    ClusterTopology,
    CliqueStartupType,
    PodCliqueSet,
    TopologyConstraint,
    TopologyDomain,
    is_domain_narrower,
)


@dataclass
class ValidationError(Exception):
    field: str
    message: str

    def __str__(self) -> str:
        return f"{self.field}: {self.message}"


def validate_podcliqueset(
    pcs: PodCliqueSet, topology: ClusterTopology | None = None
) -> list[ValidationError]:
    """Full create-time validation; returns a list of errors (empty = valid)."""
    # The host level is always available (clustertopology.go:102-107).
    if topology is not None:
        topology = topology.with_host_level()
    errs: list[ValidationError] = []
    name = pcs.metadata.name
    if not name:
        errs.append(ValidationError("metadata.name", "name is required"))
    # The 45-char budget caps the COMBINED <pcs>[-<pcsg>]-<pclq> name material
    # so generated pod names `<pcs>-<i>[-<pcsg>-<j>]-<pclq>-<suffix>` fit the
    # 63-char DNS label (validation/podcliqueset.go:564-578).
    sg_of_clique = {
        cn: cfg.name
        for cfg in pcs.spec.template.pod_clique_scaling_group_configs
        for cn in cfg.clique_names
    }
    for clique in pcs.spec.template.cliques:
        parts = [name, sg_of_clique.get(clique.name, ""), clique.name]
        combined = sum(len(p) for p in parts if p)
        if combined > MAX_PCS_NAME_LENGTH:
            errs.append(
                ValidationError(
                    "metadata.name",
                    f"combined name length {combined} for clique {clique.name!r} exceeds "
                    f"{MAX_PCS_NAME_LENGTH} characters; generated pod names would not fit "
                    f"the 63-character limit",
                )
            )
    if pcs.spec.replicas < 1:
        errs.append(ValidationError("spec.replicas", "must be greater than 0"))

    tmpl = pcs.spec.template
    if not tmpl.cliques:
        errs.append(ValidationError("spec.template.cliques", "at least one PodClique must be defined"))
    if tmpl.termination_delay_seconds is not None and tmpl.termination_delay_seconds <= 0:
        errs.append(ValidationError("spec.template.terminationDelay", "must be greater than 0"))
    # sloClass: one of the fixed tenancy tiers ("" = defaulting fills
    # "standard"; an unknown tier would silently schedule as standard, so
    # reject it at admission instead).
    if tmpl.slo_class and tmpl.slo_class not in SLO_CLASSES:
        errs.append(
            ValidationError(
                "spec.template.sloClass",
                f"unknown SLO class {tmpl.slo_class!r}; must be one of {', '.join(SLO_CLASSES)}",
            )
        )
    # grove.io/rollout-strategy: the per-PCS update-strategy override must
    # name a known strategy — a typo'd value would silently fall back to the
    # global rollout.enabled default, the opposite of what was asked for.
    strategy = (pcs.metadata.annotations or {}).get(ANNOTATION_ROLLOUT_STRATEGY)
    if strategy is not None and strategy not in ROLLOUT_STRATEGIES:
        errs.append(
            ValidationError(
                f"metadata.annotations[{ANNOTATION_ROLLOUT_STRATEGY}]",
                f"unknown rollout strategy {strategy!r}; must be one of "
                + ", ".join(ROLLOUT_STRATEGIES),
            )
        )

    clique_names = [c.name for c in tmpl.cliques]
    _require_unique(errs, clique_names, "spec.template.cliques.name", "clique names must be unique")
    role_names = [c.spec.role_name for c in tmpl.cliques if c.spec.role_name]
    _require_unique(errs, role_names, "spec.template.cliques.spec.roleName", "role names must be unique")

    sg_member_cliques: set[str] = set()
    for cfg in tmpl.pod_clique_scaling_group_configs:
        sg_member_cliques.update(cfg.clique_names)

    for i, clique in enumerate(tmpl.cliques):
        fld = f"spec.template.cliques[{i}]"
        spec = clique.spec
        if spec.replicas <= 0:
            errs.append(ValidationError(f"{fld}.spec.replicas", "must be greater than 0"))
        if spec.min_available is not None:
            if spec.min_available <= 0:
                errs.append(ValidationError(f"{fld}.spec.minAvailable", "must be greater than 0"))
            elif spec.min_available > spec.replicas:
                errs.append(
                    ValidationError(f"{fld}.spec.minAvailable", "minAvailable must not be greater than replicas")
                )
        for dep in spec.starts_after:
            if not dep:
                errs.append(ValidationError(f"{fld}.spec.startsAfter", "clique dependency must not be empty"))
            elif dep == clique.name:
                errs.append(ValidationError(f"{fld}.spec.startsAfter", "clique dependency cannot refer to itself"))
            elif dep not in clique_names:
                errs.append(
                    ValidationError(
                        f"{fld}.spec.startsAfter",
                        f"unknown clique {dep!r}, all clique dependencies must be defined as cliques",
                    )
                )
        _require_unique(errs, spec.starts_after, f"{fld}.spec.startsAfter", "clique dependencies must be unique")
        if spec.scale_config is not None:
            sc = spec.scale_config
            if clique.name in sg_member_cliques:
                errs.append(
                    ValidationError(
                        f"{fld}.spec.autoScalingConfig",
                        "cliques in a PodCliqueScalingGroup cannot have individual autoscaling",
                    )
                )
            min_avail = spec.min_available if spec.min_available is not None else spec.replicas
            min_reps = sc.min_replicas if sc.min_replicas is not None else spec.replicas
            if min_reps < min_avail:
                errs.append(
                    ValidationError(
                        f"{fld}.spec.autoScalingConfig.minReplicas",
                        "must be greater than or equal to minAvailable",
                    )
                )
            if sc.max_replicas < min_reps:
                errs.append(
                    ValidationError(
                        f"{fld}.spec.autoScalingConfig.maxReplicas",
                        "must be greater than or equal to minReplicas",
                    )
                )
            if sc.max_replicas < spec.replicas:
                errs.append(
                    ValidationError(
                        f"{fld}.spec.autoScalingConfig.maxReplicas",
                        "must be greater than or equal to replicas",
                    )
                )

    errs.extend(_validate_startup_dag(pcs))
    errs.extend(_validate_scaling_groups(pcs))
    errs.extend(_validate_topology_constraints(pcs, topology))
    return errs


def _validate_scaling_groups(pcs: PodCliqueSet) -> list[ValidationError]:
    errs: list[ValidationError] = []
    tmpl = pcs.spec.template
    clique_names = {c.name for c in tmpl.cliques}
    sg_names = [cfg.name for cfg in tmpl.pod_clique_scaling_group_configs]
    _require_unique(errs, sg_names, "spec.template.podCliqueScalingGroups.name", "scaling group names must be unique")
    all_members: list[str] = []
    for i, cfg in enumerate(tmpl.pod_clique_scaling_group_configs):
        fld = f"spec.template.podCliqueScalingGroups[{i}]"
        if not cfg.clique_names:
            errs.append(ValidationError(f"{fld}.cliqueNames", "at least one clique name is required"))
        for cn in cfg.clique_names:
            if cn not in clique_names:
                errs.append(ValidationError(f"{fld}.cliqueNames", f"unknown clique {cn!r}"))
        all_members.extend(cfg.clique_names)
        if cfg.replicas <= 0:
            errs.append(ValidationError(f"{fld}.replicas", "must be greater than 0"))
        if cfg.min_available <= 0:
            errs.append(ValidationError(f"{fld}.minAvailable", "must be greater than 0"))
        if cfg.min_available > cfg.replicas:
            errs.append(ValidationError(f"{fld}.minAvailable", "minAvailable must not be greater than replicas"))
        if cfg.scale_config is not None:
            min_reps = cfg.scale_config.min_replicas if cfg.scale_config.min_replicas is not None else cfg.replicas
            if min_reps < cfg.min_available:
                errs.append(
                    ValidationError(
                        f"{fld}.scaleConfig.minReplicas",
                        "must be greater than or equal to minAvailable",
                    )
                )
            if cfg.scale_config.max_replicas < min_reps:
                errs.append(
                    ValidationError(
                        f"{fld}.scaleConfig.maxReplicas",
                        "must be greater than or equal to minReplicas",
                    )
                )
    _require_unique(
        errs,
        all_members,
        "spec.template.podCliqueScalingGroups.cliqueNames",
        "clique names must not overlap across scaling groups",
    )
    return errs


def _validate_startup_dag(pcs: PodCliqueSet) -> list[ValidationError]:
    """Cycle detection over StartsAfter (validation/podcliqueset.go:290-309)."""
    errs: list[ValidationError] = []
    tmpl = pcs.spec.template
    if tmpl.startup_type != CliqueStartupType.EXPLICIT:
        for c in tmpl.cliques:
            if c.spec.starts_after:
                errs.append(
                    ValidationError(
                        "spec.template.cliques.spec.startsAfter",
                        "startsAfter is only allowed with CliqueStartupTypeExplicit",
                    )
                )
                break
        return errs

    graph = {c.name: [d for d in c.spec.starts_after if any(x.name == d for x in tmpl.cliques)] for c in tmpl.cliques}
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}

    def dfs(node: str) -> bool:
        color[node] = GRAY
        for dep in graph[node]:
            if color[dep] == GRAY:
                return True
            if color[dep] == WHITE and dfs(dep):
                return True
        color[node] = BLACK
        return False

    for node in graph:
        if color[node] == WHITE and dfs(node):
            errs.append(
                ValidationError(
                    "spec.template.cliques.spec.startsAfter",
                    "clique must not have circular dependencies",
                )
            )
            break
    return errs


def _validate_topology_constraints(
    pcs: PodCliqueSet, topology: ClusterTopology | None
) -> list[ValidationError]:
    """Hierarchy: child (PCLQ) must be equal-or-narrower than parent (PCSG/PCS),
    and every referenced domain must exist in the ClusterTopology
    (validation/topologyconstraints.go)."""
    errs: list[ValidationError] = []
    tmpl = pcs.spec.template

    if (
        pcs.spec.topology_spread_domain is not None
        and topology is not None
        and topology.label_key_for(pcs.spec.topology_spread_domain) is None
    ):
        errs.append(
            ValidationError(
                "spec.topologySpreadDomain",
                f"topology domain {pcs.spec.topology_spread_domain.value!r} "
                "is not defined in the cluster topology",
            )
        )

    def check_domain_exists(tc: TopologyConstraint | None, fld: str) -> None:
        if tc is None or topology is None:
            return
        for dom in (tc.pack_domain, tc.preferred_domain):
            if dom is not None and topology.label_key_for(dom) is None:
                errs.append(
                    ValidationError(
                        fld,
                        f"topology domain {dom.value!r} is not defined in the cluster topology",
                    )
                )
        # A preferred level BROADER than the required pack is vacuous (the
        # required domain already confines every pod inside one preferred
        # domain) — reject it as authored confusion, like the parent check.
        if (
            tc.pack_domain is not None
            and tc.preferred_domain is not None
            and is_domain_narrower(tc.pack_domain, tc.preferred_domain)
        ):
            errs.append(
                ValidationError(
                    fld,
                    f"preferredDomain {tc.preferred_domain.value!r} must be equal to "
                    f"or narrower than packDomain {tc.pack_domain.value!r}",
                )
            )

    def check_narrower(child: TopologyConstraint | None, parent: TopologyConstraint | None, fld: str) -> None:
        if child is None or parent is None:
            return
        if child.pack_domain is None or parent.pack_domain is None:
            return  # preferred-only constraints never conflict hierarchically
        if is_domain_narrower(parent.pack_domain, child.pack_domain):
            errs.append(
                ValidationError(
                    fld,
                    f"constraint domain {child.pack_domain.value!r} must be equal to or "
                    f"narrower than the parent constraint {parent.pack_domain.value!r}",
                )
            )

    pcs_tc = tmpl.topology_constraint
    check_domain_exists(pcs_tc, "spec.template.topologyConstraint")
    sg_by_clique: dict[str, TopologyConstraint | None] = {}
    for i, cfg in enumerate(tmpl.pod_clique_scaling_group_configs):
        fld = f"spec.template.podCliqueScalingGroups[{i}].topologyConstraint"
        check_domain_exists(cfg.topology_constraint, fld)
        check_narrower(cfg.topology_constraint, pcs_tc, fld)
        for cn in cfg.clique_names:
            sg_by_clique[cn] = cfg.topology_constraint
    for i, clique in enumerate(tmpl.cliques):
        fld = f"spec.template.cliques[{i}].topologyConstraint"
        check_domain_exists(clique.topology_constraint, fld)
        parent = sg_by_clique.get(clique.name) or pcs_tc
        check_narrower(clique.topology_constraint, parent, fld)
    return errs


def validate_update(old: PodCliqueSet, new: PodCliqueSet) -> list[ValidationError]:
    """Update immutability (validation/podcliqueset.go:440-544)."""
    errs: list[ValidationError] = []
    old_tmpl, new_tmpl = old.spec.template, new.spec.template

    old_cliques = {c.name: c for c in old_tmpl.cliques}
    new_cliques = {c.name: c for c in new_tmpl.cliques}
    if set(old_cliques) != set(new_cliques):
        errs.append(
            ValidationError("spec.template.cliques", "cliques cannot be added or removed on update")
        )
    if new_tmpl.startup_type != old_tmpl.startup_type:
        errs.append(ValidationError("spec.template.startupType", "field is immutable"))
    if new_tmpl.startup_type in (CliqueStartupType.IN_ORDER, CliqueStartupType.EXPLICIT):
        old_order = [c.name for c in old_tmpl.cliques]
        new_order = [c.name for c in new_tmpl.cliques]
        if old_order != new_order and set(old_order) == set(new_order):
            errs.append(
                ValidationError(
                    "spec.template.cliques",
                    "clique order cannot be changed when StartupType is InOrder or Explicit",
                )
            )
    for name, new_c in new_cliques.items():
        old_c = old_cliques.get(name)
        if old_c is None:
            continue
        if new_c.spec.min_available != old_c.spec.min_available:
            errs.append(ValidationError(f"spec.template.cliques[{name}].spec.minAvailable", "field is immutable"))
        if new_c.spec.role_name != old_c.spec.role_name:
            errs.append(ValidationError(f"spec.template.cliques[{name}].spec.roleName", "field is immutable"))

    old_sgs = {c.name: c for c in old_tmpl.pod_clique_scaling_group_configs}
    new_sgs = {c.name: c for c in new_tmpl.pod_clique_scaling_group_configs}
    if set(old_sgs) != set(new_sgs):
        errs.append(
            ValidationError(
                "spec.template.podCliqueScalingGroups",
                "scaling groups cannot be added or removed on update",
            )
        )
    for name, new_sg in new_sgs.items():
        old_sg = old_sgs.get(name)
        if old_sg is None:
            continue
        if new_sg.min_available != old_sg.min_available:
            errs.append(
                ValidationError(f"spec.template.podCliqueScalingGroups[{name}].minAvailable", "field is immutable")
            )
        if new_sg.clique_names != old_sg.clique_names:
            errs.append(
                ValidationError(f"spec.template.podCliqueScalingGroups[{name}].cliqueNames", "field is immutable")
            )
    return errs


def _require_unique(errs: list[ValidationError], items: list[str], field_name: str, message: str) -> None:
    seen: set[str] = set()
    for item in items:
        if item in seen:
            errs.append(ValidationError(field_name, f"{message}: {item!r}"))
            return
        seen.add(item)
