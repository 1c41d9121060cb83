"""In-memory object store — the apiserver/informer-cache analog.

The reference's controllers read and write CRs through kube-apiserver watch
streams (SURVEY.md §5.8). Here the store is a plain indexed object graph the
controller reconciles against and the simulator mutates; a live-cluster driver
can populate the same store from real informers.

Unlike informer caches, reads here are strongly consistent — so the
reference's ExpectationsStore machinery (internal/expect/expectations.go) is
unnecessary by construction.

The port's copy of grove_tpu/orchestrator/store.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

# Default control-plane event ring capacity (controllers.eventsBuffer
# overrides it at manager boot). A bounded ring: an unbounded event list
# leaks memory linearly with churn over a long soak.
DEFAULT_EVENTS_MAXLEN = 4096

from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.podgang import PodGang
from grove_tpu_torch.api.types import (
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueSet,
)
from grove_tpu_torch.state.cluster import Node


class _PodDict(dict):
    """Pod store with clique/gang indexes maintained on every mutation.

    pods_of_clique/pods_of_gang were O(all pods) linear scans; at bench scale
    (10k pods x 1250 gangs) one reconcile pass burned seconds in them. The
    index keys (pclq_fqn, podgang_name) are set at construction and never
    reassigned, so membership mutations are the only invalidation points —
    and every path (including tests assigning `cluster.pods[x] = p`) goes
    through these overrides."""

    def __init__(self, initial: dict | None = None):
        super().__init__()
        self.by_clique: dict[str, dict[str, Pod]] = {}
        self.by_gang: dict[str, dict[str, Pod]] = {}
        for name, pod in (initial or {}).items():
            self[name] = pod

    def _unindex(self, pod: Pod) -> None:
        for index, key in (
            (self.by_clique, pod.pclq_fqn),
            (self.by_gang, pod.podgang_name),
        ):
            group = index.get(key)
            if group is not None:
                group.pop(pod.name, None)
                if not group:
                    del index[key]

    def __setitem__(self, name: str, pod: Pod) -> None:
        if name != pod.name:
            raise ValueError(f"pod stored under {name!r} but named {pod.name!r}")
        if name in self:
            self._unindex(super().__getitem__(name))
        super().__setitem__(name, pod)
        self.by_clique.setdefault(pod.pclq_fqn, {})[name] = pod
        self.by_gang.setdefault(pod.podgang_name, {})[name] = pod

    def __delitem__(self, name: str) -> None:
        self._unindex(super().__getitem__(name))
        super().__delitem__(name)

    def pop(self, name, default=None):
        if name in self:
            pod = super().__getitem__(name)
            del self[name]
            return pod
        return default

    def update(self, other=(), **kw):  # dict.update bypasses __setitem__
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def setdefault(self, name, default=None):
        if name not in self:
            self[name] = default  # route through __setitem__ (dict's is C-level)
        return self[name]

    def __ior__(self, other):
        self.update(other)
        return self

    def clear(self):
        super().clear()
        self.by_clique.clear()
        self.by_gang.clear()


@dataclass
class Cluster:
    """All objects, indexed by name. One namespace (multiplex outside if needed)."""

    nodes: dict[str, Node] = field(default_factory=dict)
    podcliquesets: dict[str, PodCliqueSet] = field(default_factory=dict)
    podcliques: dict[str, PodClique] = field(default_factory=dict)
    scaling_groups: dict[str, PodCliqueScalingGroup] = field(default_factory=dict)
    podgangs: dict[str, PodGang] = field(default_factory=dict)
    pods: _PodDict = field(default_factory=_PodDict)
    # Managed auxiliary resource objects (api/resources.py; the reference's
    # ordered component kinds, podcliqueset/reconcilespec.go:206-221).
    services: dict[str, object] = field(default_factory=dict)  # HeadlessService
    hpas: dict[str, object] = field(default_factory=dict)  # HorizontalPodAutoscaler
    service_accounts: dict[str, object] = field(default_factory=dict)
    roles: dict[str, object] = field(default_factory=dict)
    role_bindings: dict[str, object] = field(default_factory=dict)
    secrets: dict[str, object] = field(default_factory=dict)  # TokenSecret
    # HPA scale subresource values, keyed by target FQN (pclq or pcsg).
    scale_overrides: dict[str, int] = field(default_factory=dict)
    # Bounded control-plane event ring: (time, obj, msg). A deque(maxlen)
    # so long soaks cannot leak; overflow drops the OLDEST event and counts
    # it (events_dropped -> grove_events_dropped_total). events_total is the
    # monotonic global index — consumers that mirror the ring incrementally
    # (watch driver event publishing) track position in it, because deque
    # indices shift as old entries fall off.
    events: deque = field(
        default_factory=lambda: deque(maxlen=DEFAULT_EVENTS_MAXLEN)
    )
    events_dropped: int = 0
    events_total: int = 0

    @property
    def headless_services(self) -> set[str]:
        """Service-name view over the Service objects — one source of truth
        (the dict); kept for the discovery-by-name callers."""
        return {svc.name for svc in self.services.values()}

    # --- queries (componentutils analogs) ---------------------------------------

    def _indexed_pods(self) -> "_PodDict":
        # Persistence restore (serde) may setattr a plain dict; adopt it.
        if not isinstance(self.pods, _PodDict):
            self.pods = _PodDict(self.pods)
        return self.pods

    def pods_of_clique(self, pclq_fqn: str) -> list[Pod]:
        return list(self._indexed_pods().by_clique.get(pclq_fqn, {}).values())

    def pods_of_gang(self, gang_name: str) -> list[Pod]:
        return list(self._indexed_pods().by_gang.get(gang_name, {}).values())

    def cliques_of_pcs(self, pcs_name: str) -> list[PodClique]:
        return [c for c in self.podcliques.values() if c.pcs_name == pcs_name]

    def cliques_of_pcs_replica(self, pcs_name: str, replica: int) -> list[PodClique]:
        return [
            c
            for c in self.podcliques.values()
            if c.pcs_name == pcs_name and c.pcs_replica_index == replica
        ]

    def cliques_of_pcsg(self, pcsg_fqn: str) -> list[PodClique]:
        return [c for c in self.podcliques.values() if c.pcsg_name == pcsg_fqn]

    def pcsgs_of_pcs(self, pcs_name: str) -> list[PodCliqueScalingGroup]:
        return [g for g in self.scaling_groups.values() if g.pcs_name == pcs_name]

    def gangs_of_pcs(self, pcs_name: str) -> list[PodGang]:
        return [g for g in self.podgangs.values() if g.pcs_name == pcs_name]

    def record_event(self, now: float, obj: str, msg: str) -> None:
        ev = self.events
        if ev.maxlen is not None and len(ev) == ev.maxlen:
            self.events_dropped += 1
        ev.append((now, obj, msg))
        self.events_total += 1

    def set_events_maxlen(self, maxlen: int) -> None:
        """Resize the event ring (controllers.eventsBuffer), keeping the
        newest events that fit."""
        maxlen = max(1, int(maxlen))
        if self.events.maxlen != maxlen:
            self.events = deque(self.events, maxlen=maxlen)

    def recent_events(self, n: int | None = None) -> list[tuple[float, str, str]]:
        """Newest-last event list (deques don't slice; every tail consumer
        goes through here)."""
        evs = list(self.events)
        return evs if n is None else evs[-n:]

    # --- mutations ---------------------------------------------------------------

    def delete_pod(self, name: str) -> Optional[Pod]:
        return self.pods.pop(name, None)

    def delete_clique_cascade(self, fqn: str) -> None:
        """Delete a PodClique and its pods (owner-reference cascade)."""
        self.podcliques.pop(fqn, None)
        for pod in list(self.pods.values()):
            if pod.pclq_fqn == fqn:
                del self.pods[pod.name]

    def delete_pcs_cascade(self, pcs_name: str) -> None:
        """Finalizer-driven teardown of everything a PCS owns
        (podcliqueset/reconciledelete.go analog)."""
        self.podcliquesets.pop(pcs_name, None)
        for c in [c.metadata.name for c in self.cliques_of_pcs(pcs_name)]:
            self.delete_clique_cascade(c)
        for g in [g.metadata.name for g in self.pcsgs_of_pcs(pcs_name)]:
            self.scaling_groups.pop(g, None)
        for g in [g.name for g in self.gangs_of_pcs(pcs_name)]:
            self.podgangs.pop(g, None)
        for coll in (
            self.services,
            self.hpas,
            self.service_accounts,
            self.roles,
            self.role_bindings,
            self.secrets,
        ):
            for name in [n for n, obj in coll.items() if getattr(obj, "pcs_name", None) == pcs_name]:
                del coll[name]
        for key in [k for k in self.scale_overrides if k.startswith(pcs_name + "-")]:
            del self.scale_overrides[key]


def active_pods(pods: Iterable[Pod]) -> list[Pod]:
    return [p for p in pods if p.is_active]
