"""Admission defaulting, parity with the defaulting webhook
(operator/internal/webhook/admission/pcs/defaulting/podcliqueset.go:35-108).

Applied in place on a freshly loaded PodCliqueSet before validation:
  - namespace -> "default"
  - clique replicas 0 -> 1; minAvailable -> replicas;
    scaleConfig.minReplicas -> replicas
  - PCSG config replicas -> 1 (kubebuilder default), minAvailable -> 1,
    scaleConfig.minReplicas -> PCSG replicas
  - terminationDelay -> 4h; headlessServiceConfig.publishNotReadyAddresses -> true
  - podSpec restartPolicy -> Always, terminationGracePeriodSeconds -> 30

The port's copy of grove_tpu/api/defaulting.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from grove_tpu_torch.api.constants import DEFAULT_SLO_CLASS
from grove_tpu_torch.api.types import (
    AutoScalingConfig,
    HeadlessServiceConfig,
    PodCliqueSet,
)


def default_podcliqueset(pcs: PodCliqueSet) -> PodCliqueSet:
    """Mutates and returns pcs (analog of defaultPodCliqueSet, defaulting/podcliqueset.go:35)."""
    if not pcs.metadata.namespace:
        pcs.metadata.namespace = "default"
    tmpl = pcs.spec.template

    for clique in tmpl.cliques:
        spec = clique.spec
        if spec.replicas == 0:
            spec.replicas = 1
        if spec.min_available is None:
            spec.min_available = spec.replicas
        if spec.scale_config is not None and spec.scale_config.min_replicas is None:
            spec.scale_config.min_replicas = spec.replicas
        ps = spec.pod_spec
        if not ps.restart_policy:
            ps.restart_policy = "Always"
        if ps.termination_grace_period_seconds is None:
            ps.termination_grace_period_seconds = 30

    for cfg in tmpl.pod_clique_scaling_group_configs:
        # replicas/minAvailable carry kubebuilder default 1 (podcliqueset.go:212-227);
        # the dataclass already defaults both to 1 on load.
        if cfg.scale_config is not None and cfg.scale_config.min_replicas is None:
            cfg.scale_config.min_replicas = cfg.replicas

    if tmpl.termination_delay_seconds is None:
        tmpl.termination_delay_seconds = 4 * 3600.0
    if not tmpl.slo_class:
        tmpl.slo_class = DEFAULT_SLO_CLASS
    if tmpl.headless_service_config is None:
        tmpl.headless_service_config = HeadlessServiceConfig(publish_not_ready_addresses=True)
    return pcs


def effective_min_replicas(scale_config: AutoScalingConfig | None, replicas: int) -> int:
    if scale_config is None or scale_config.min_replicas is None:
        return replicas
    return scale_config.min_replicas
