"""Admission defaulting, parity with the defaulting webhook
(operator/internal/webhook/admission/pcs/defaulting/podcliqueset.go:35-108),
cut to the fields placement reads:
  - namespace -> "default"
  - clique replicas 0 -> 1; minAvailable -> replicas
  - template sloClass "" -> "standard"
PCSG config replicas and minAvailable default to 1 on load (kubebuilder
defaults, podcliqueset.go:212-227).
"""

from __future__ import annotations

from grove_tpu_torch.api.types import PodCliqueSet

DEFAULT_SLO_CLASS = "standard"


def default_podcliqueset(pcs: PodCliqueSet) -> PodCliqueSet:
    """Mutates and returns pcs (analog of defaultPodCliqueSet, defaulting/podcliqueset.go:35)."""
    if not pcs.metadata.namespace:
        pcs.metadata.namespace = "default"
    if not pcs.spec.template.slo_class:
        pcs.spec.template.slo_class = DEFAULT_SLO_CLASS
    for clique in pcs.spec.template.cliques:
        spec = clique.spec
        if spec.replicas == 0:
            spec.replicas = 1
        if spec.min_available is None:
            spec.min_available = spec.replicas
    return pcs
