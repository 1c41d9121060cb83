"""Reconcile-flow plumbing: typed step results and the step runner.

Mirror of `operator/internal/controller/common/flow.go:34-116`: every
reconcile phase is a step function returning a ReconcileStepResult —
continue, requeue-after, continue-but-requeue, or short-circuit (with or
without errors). The runner executes steps in order, honors the result
semantics, and aggregates the requeue horizon; the error recorder persists
LastErrors to the object's status (reconcileerrorrecorder.go analog).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from grove_tpu_torch.utils.errors import GroveError


@dataclass
class ReconcileStepResult:
    """Outcome of one reconcile step (flow.go:34-57)."""

    continue_reconcile: bool = True
    requeue_after_seconds: Optional[float] = None
    errors: list[GroveError] = field(default_factory=list)
    description: str = ""

    @property
    def has_errors(self) -> bool:
        return bool(self.errors)


def continue_reconcile() -> ReconcileStepResult:
    """Proceed to the next step (flow.go ContinueReconcile)."""
    return ReconcileStepResult()


def reconcile_after(seconds: float, description: str = "") -> ReconcileStepResult:
    """Stop the flow; run the whole reconcile again after `seconds`
    (flow.go ReconcileAfter)."""
    return ReconcileStepResult(
        continue_reconcile=False,
        requeue_after_seconds=seconds,
        description=description,
    )


def continue_and_requeue_after(
    seconds: float, description: str = ""
) -> ReconcileStepResult:
    """Keep running later steps, but also requeue (sentinel
    ErrCodeContinueReconcileAndRequeue semantics)."""
    return ReconcileStepResult(
        continue_reconcile=True,
        requeue_after_seconds=seconds,
        description=description,
    )


def reconcile_with_errors(
    description: str, *errors: GroveError, requeue_after_seconds: float = 5.0
) -> ReconcileStepResult:
    """Stop the flow with errors; errors imply a retry requeue
    (flow.go ReconcileWithErrors)."""
    return ReconcileStepResult(
        continue_reconcile=False,
        requeue_after_seconds=requeue_after_seconds,
        errors=list(errors),
        description=description,
    )


def short_circuit(description: str = "") -> ReconcileStepResult:
    """Stop the flow successfully — nothing more to do this pass
    (flow.go ShortCircuitReconcileFlow)."""
    return ReconcileStepResult(continue_reconcile=False, description=description)


@dataclass
class FlowOutcome:
    """Aggregate of a full flow run."""

    requeue_after_seconds: Optional[float] = None
    errors: list[GroveError] = field(default_factory=list)
    steps_run: list[str] = field(default_factory=list)

    @property
    def has_errors(self) -> bool:
        return bool(self.errors)


def run_reconcile_flow(
    steps: list[tuple[str, Callable[[], ReconcileStepResult]]],
    error_recorder: Optional[Callable[[list[GroveError]], None]] = None,
) -> FlowOutcome:
    """Execute named steps in order with flow.go semantics.

    - a step that raises GroveError is treated as reconcile_with_errors
    - any other exception is wrapped (operation = step name)
    - the outcome's requeue horizon is the MINIMUM of all requested requeues
      (the soonest need wins, matching workqueue semantics)
    - error_recorder receives the accumulated errors (possibly empty — an
      empty record CLEARS LastErrors, as the reference recorder does)
    """
    outcome = FlowOutcome()
    for name, step in steps:
        outcome.steps_run.append(name)
        try:
            result = step()
        except GroveError as e:
            seconds = getattr(e, "requeue_seconds", 5.0)
            if e.is_sentinel:
                result = ReconcileStepResult(
                    continue_reconcile="CONTINUE" in e.code,
                    requeue_after_seconds=seconds,
                    description=str(e),
                )
            else:
                result = reconcile_with_errors(name, e)
        except Exception as e:  # noqa: BLE001 — reconcile must not crash the loop
            result = reconcile_with_errors(
                name,
                GroveError(code="ERR_SYNC_RESOURCE", operation=name, message=str(e), cause=e),
            )
        outcome.errors.extend(result.errors)
        if result.requeue_after_seconds is not None:
            outcome.requeue_after_seconds = (
                result.requeue_after_seconds
                if outcome.requeue_after_seconds is None
                else min(outcome.requeue_after_seconds, result.requeue_after_seconds)
            )
        if not result.continue_reconcile:
            break
    if error_recorder is not None:
        error_recorder(outcome.errors)
    return outcome
