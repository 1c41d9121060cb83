"""Multi-tenant SLO tiers (docs/design.md "Multi-tenant SLO tiers").

Composes the existing pieces — hierarchical capacity queues, priority
preemption, disruption-budgeted migration, the flight recorder — into a
per-tenant SLO enforcement story:

  - SLO classes (`api.constants.SLO_CLASSES`) mapped to admission order,
    borrowing eligibility, and preemptibility (slo.py);
  - deterministic priority aging so in-quota demand cannot be starved
    forever by higher-weight borrowers (aging.py);
  - a per-tenant fairness ledger surfaced via /statusz, metrics, and
    `grove-tpu get tenancy` (ledger.py).

The enforcement itself lives in the controller's admission pass
(orchestrator/controller.py); this package holds the pure policy pieces so
they are unit-testable and shared with the bench harness.

The port's copy of grove_tpu/tenancy/__init__.py, whole; it imports nothing of
the JAX package.
"""

from grove_tpu_torch.tenancy.aging import aging_boost
from grove_tpu_torch.tenancy.ledger import TenantLedger, quantile
from grove_tpu_torch.tenancy.slo import (
    is_valid_slo_class,
    normalized_slo_class,
    slo_borrow_eligible,
    slo_rank,
    stream_order_key,
)

__all__ = [
    "aging_boost",
    "TenantLedger",
    "quantile",
    "is_valid_slo_class",
    "normalized_slo_class",
    "slo_borrow_eligible",
    "slo_rank",
    "stream_order_key",
]
