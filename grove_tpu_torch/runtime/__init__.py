"""Operator runtime: configuration, reconcile flow, manager, boot path.

The analog of the reference's `operator/cmd` + `operator/internal/controller`
runtime layers (SURVEY.md §1 L2/L3): a validated YAML OperatorConfiguration
boots a manager that wires the store, the reconcile loop (typed step results,
requeue semantics), observability (leveled logging, metrics endpoint, health
probes), leader election, and optionally the scheduler-backend sidecar — all
from one config file.
"""

from grove_tpu_torch.runtime.config import (
    OperatorConfiguration,
    load_operator_config,
    validate_operator_config,
)
from grove_tpu_torch.runtime.flow import (
    ReconcileStepResult,
    continue_reconcile,
    reconcile_after,
    reconcile_with_errors,
    run_reconcile_flow,
    short_circuit,
)
from grove_tpu_torch.runtime.manager import Manager

__all__ = [
    "Manager",
    "OperatorConfiguration",
    "ReconcileStepResult",
    "continue_reconcile",
    "load_operator_config",
    "reconcile_after",
    "reconcile_with_errors",
    "run_reconcile_flow",
    "short_circuit",
    "validate_operator_config",
]
