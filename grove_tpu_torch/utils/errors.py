"""Typed error model driving reconcile flow control.

Mirror of the reference's `operator/internal/errors/{errors,sentinel}.go`:
every controller error carries a stable machine code + the operation that
failed, errors wrap causes, and two sentinel codes are flow-control signals
(requeue-after / continue-and-requeue) rather than failures. The reconcile
flow (grove_tpu_torch/runtime/flow.py) and the error recorder (LastErrors persisted
to status) consume these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# Stable error codes (internal/errors/errors.go analog).
ERR_GET_RESOURCE = "ERR_GET_RESOURCE"
ERR_SYNC_RESOURCE = "ERR_SYNC_RESOURCE"
ERR_DELETE_RESOURCE = "ERR_DELETE_RESOURCE"
ERR_EXPAND_WORKLOAD = "ERR_EXPAND_WORKLOAD"
ERR_SOLVE = "ERR_SOLVE"
ERR_VALIDATION = "ERR_VALIDATION"
ERR_CONFIG = "ERR_CONFIG"
ERR_BACKEND = "ERR_BACKEND"
ERR_PERSISTENCE = "ERR_PERSISTENCE"

# Sentinel codes: flow-control, not failures (internal/errors/sentinel.go).
ERR_CODE_REQUEUE_AFTER = "ERR_REQUEUE_AFTER"
ERR_CODE_CONTINUE_RECONCILE_AND_REQUEUE = "ERR_CONTINUE_RECONCILE_AND_REQUEUE"

_SENTINELS = {ERR_CODE_REQUEUE_AFTER, ERR_CODE_CONTINUE_RECONCILE_AND_REQUEUE}


@dataclass
class GroveError(Exception):
    """Typed error: {code, operation, message}, optionally wrapping a cause."""

    code: str
    operation: str
    message: str
    cause: Optional[BaseException] = field(default=None, repr=False)

    def __str__(self) -> str:  # [code] operation: message (cause)
        base = f"[{self.code}] {self.operation}: {self.message}"
        return f"{base} (cause: {self.cause})" if self.cause else base

    @property
    def is_sentinel(self) -> bool:
        return self.code in _SENTINELS


def wrap(code: str, operation: str, err: BaseException) -> GroveError:
    """Wrap any exception into a GroveError, preserving an existing code."""
    if isinstance(err, GroveError):
        return err
    return GroveError(code=code, operation=operation, message=str(err), cause=err)


def requeue_after(operation: str, seconds: float) -> GroveError:
    """Sentinel: stop this reconcile, run again after `seconds`."""
    e = GroveError(
        code=ERR_CODE_REQUEUE_AFTER,
        operation=operation,
        message=f"requeue after {seconds:g}s",
    )
    e.requeue_seconds = seconds  # type: ignore[attr-defined]
    return e


def continue_and_requeue(operation: str, seconds: float) -> GroveError:
    """Sentinel: keep reconciling subsequent steps, but also requeue."""
    e = GroveError(
        code=ERR_CODE_CONTINUE_RECONCILE_AND_REQUEUE,
        operation=operation,
        message=f"continue, requeue after {seconds:g}s",
    )
    e.requeue_seconds = seconds  # type: ignore[attr-defined]
    return e
