"""Reconcile cascade: expansion, gating, gang termination, rolling updates."""

from grove_tpu_torch.orchestrator.expansion import (  # noqa: F401
    DesiredState,
    compute_generation_hash,
    compute_pod_template_hash,
    expand_podcliqueset,
    translate_pack_constraint,
)
