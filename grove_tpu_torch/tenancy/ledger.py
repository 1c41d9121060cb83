"""Per-tenant fairness ledger.

Tenant identity is the capacity queue a gang draws quota from (PodGang
.queue) — the same key the QueueTree charges, so admission accounting and
fairness accounting cannot disagree about who a gang belongs to.

The ledger is pure bookkeeping: the controller calls the note_* hooks from
decision points that are already journaled (wave records, aging / reclaim /
preemption action records), so the ledger itself never needs to be part of
the replay closure — replaying the journal rebuilds an equivalent ledger.

Bind-latency samples are kept per (tenant, SLO class) in bounded reservoirs
(newest-kept) so hundreds of churning tenants cannot grow the ledger
without bound; the p50/p99 cut from them is what the tenancy bench gates
tier ordering on.

The port's copy of grove_tpu/tenancy/ledger.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grove_tpu_torch.tenancy.slo import normalized_slo_class

# Newest-kept samples per (tenant, class); enough for a stable p99 without
# unbounded growth under churn.
_LATENCY_CAP = 512


def quantile(samples: list[float], q: float) -> float:
    """Nearest-rank quantile; 0.0 on empty input. Deterministic (no
    interpolation-mode surprises across numpy versions)."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(q * len(xs) + 0.5) - 1))
    return xs[idx]


@dataclass
class TenantStats:
    """One tenant's (= one queue's) cumulative counters."""

    submitted: int = 0          # gangs that entered the contender field
    admitted: int = 0           # gangs granted quota into a solve batch
    admitted_borrowing: int = 0  # admissions that rode borrowed capacity
    bound: int = 0              # gangs fully bound
    preemptions_suffered: int = 0
    preemptions_caused: int = 0
    reclaims_suffered: int = 0
    reclaims_caused: int = 0
    aging_boosts: int = 0       # aging ladder steps granted to this tenant
    # SLO class -> bounded bind-latency samples (seconds, newest kept).
    bind_latencies: dict[str, list[float]] = field(default_factory=dict)

    def admitted_ratio(self) -> float:
        return self.admitted / self.submitted if self.submitted else 0.0

    def borrowed_share(self) -> float:
        return self.admitted_borrowing / self.admitted if self.admitted else 0.0


class TenantLedger:
    """Fairness accounting across tenants; surfaced via /statusz tenancy,
    grove_tenancy_* metrics, and `grove-tpu get tenancy`."""

    def __init__(self) -> None:
        self.tenants: dict[str, TenantStats] = {}
        # Monotonic totals the manager cuts delta-exported counters from.
        self.totals: dict[str, int] = {
            "submitted": 0,
            "admitted": 0,
            "admitted_borrowing": 0,
            "bound": 0,
            "preemptions": 0,
            "reclaims": 0,
            "aging_boosts": 0,
            "reclaim_deferred": 0,
        }

    def _stats(self, tenant: str) -> TenantStats:
        st = self.tenants.get(tenant)
        if st is None:
            st = self.tenants[tenant] = TenantStats()
        return st

    def note_submitted(self, tenant: str) -> None:
        self._stats(tenant).submitted += 1
        self.totals["submitted"] += 1

    def note_admitted(self, tenant: str, borrowed: bool) -> None:
        st = self._stats(tenant)
        st.admitted += 1
        self.totals["admitted"] += 1
        if borrowed:
            st.admitted_borrowing += 1
            self.totals["admitted_borrowing"] += 1

    def note_bound(self, tenant: str, slo_class: str, latency_s: float) -> None:
        st = self._stats(tenant)
        st.bound += 1
        self.totals["bound"] += 1
        samples = st.bind_latencies.setdefault(normalized_slo_class(slo_class), [])
        samples.append(latency_s)
        if len(samples) > _LATENCY_CAP:
            del samples[: len(samples) - _LATENCY_CAP]

    def note_preemption(self, victim_tenant: str, contender_tenant: str) -> None:
        self._stats(victim_tenant).preemptions_suffered += 1
        self._stats(contender_tenant).preemptions_caused += 1
        self.totals["preemptions"] += 1

    def note_reclaim(self, victim_tenant: str, contender_tenant: str) -> None:
        self._stats(victim_tenant).reclaims_suffered += 1
        self._stats(contender_tenant).reclaims_caused += 1
        self.totals["reclaims"] += 1

    def note_aging(self, tenant: str) -> None:
        self._stats(tenant).aging_boosts += 1
        self.totals["aging_boosts"] += 1

    def note_reclaim_deferred(self) -> None:
        self.totals["reclaim_deferred"] += 1

    def tier_latencies(self) -> dict[str, list[float]]:
        """SLO class -> pooled bind-latency samples across every tenant."""
        pooled: dict[str, list[float]] = {}
        for st in self.tenants.values():
            for cls, samples in st.bind_latencies.items():
                pooled.setdefault(cls, []).extend(samples)
        return pooled

    def snapshot(self, top: int = 0) -> dict:
        """The /statusz `tenancy` doc. `top` > 0 bounds the per-tenant
        table (busiest first) so hundreds of tenants stay renderable."""
        names = sorted(
            self.tenants,
            key=lambda t: (-self.tenants[t].submitted, t),
        )
        if top > 0:
            names = names[:top]
        tenants = {}
        for name in names:
            st = self.tenants[name]
            tenants[name] = {
                "submitted": st.submitted,
                "admitted": st.admitted,
                "admittedRatio": round(st.admitted_ratio(), 4),
                "borrowedShare": round(st.borrowed_share(), 4),
                "bound": st.bound,
                "preemptionsSuffered": st.preemptions_suffered,
                "preemptionsCaused": st.preemptions_caused,
                "reclaimsSuffered": st.reclaims_suffered,
                "reclaimsCaused": st.reclaims_caused,
                "agingBoosts": st.aging_boosts,
            }
        tiers = {
            cls: {
                "samples": len(samples),
                "p50BindSeconds": round(quantile(samples, 0.50), 6),
                "p99BindSeconds": round(quantile(samples, 0.99), 6),
            }
            for cls, samples in sorted(self.tier_latencies().items())
        }
        return {
            "tenantCount": len(self.tenants),
            "totals": dict(self.totals),
            "tiers": tiers,
            "tenants": tenants,
        }
