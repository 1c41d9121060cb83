"""The watch driver: external cluster events → store, bindings → cluster.

The reference's controllers see the world exclusively through kube-apiserver
watch streams (informers, SURVEY.md §5.8); the in-pod agent watches too
(`operator/initc/internal/wait.go:111-164`). This module is that integration
path for the TPU stack: a WatchSource — KwokCluster (cluster/kwok.py) or the
live-apiserver KubernetesWatchSource (cluster/kubernetes.py) — produces
`WatchEvent`s, the WatchDriver applies them to the Manager's store, and
control-plane decisions (bindings, deletions) flow back out.

Apply discipline (the ExpectationsStore lesson,
`operator/internal/expect/expectations.go:33-71`): watch events are DELAYED
VIEWS, not commands. A pod event for an object the controller has deleted or
replaced must not resurrect it — pod events only ever update fields of a pod
that still exists in the store under the same binding. The store itself stays
strongly consistent (single writer: the manager loop), so unlike the
reference we need no create/delete expectation counters — the lag lives
entirely on the inbound event side.

Optionally forwards node state to a scheduler-backend sidecar via
UpdateCluster, so an out-of-process solver sees the same fleet
(backend/service.py; GREP-375).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Optional, Protocol

from grove_tpu_torch.api.pod import PodPhase
from grove_tpu_torch.state.cluster import Node


@dataclass
class WatchRetryPolicy:
    """Resubscribe pacing + resync accounting for an informer loop.

    The reference informer contract under churn: a dropped watch stream
    RESUBSCRIBES from the last-seen resourceVersion after a capped backoff
    (decorrelated jitter — a flapping apiserver must not see every informer
    reconnect in lockstep), and a 410 Gone (resourceVersion expired while
    we were away) forces a FULL RESYNC (relist + synthesized DELETEDs for
    ghosts). Both transitions are counted — a cluster whose watches flap is
    a cluster whose operator should know (grove_watch_* metrics).

    One policy instance per resource watch; `note_healthy()` after a
    successful list resets the backoff so the next episode starts fast."""

    base_s: float = 0.5
    cap_s: float = 30.0
    seed: int | None = None
    # Monotonic counters (read by the source's stats and the manager).
    reconnects: int = 0
    resyncs: int = 0
    _backoff: object = None

    def _ensure(self):
        if self._backoff is None:
            from grove_tpu_torch.utils.backoff import Backoff

            self._backoff = Backoff(self.base_s, self.cap_s, seed=self.seed)
        return self._backoff

    def next_delay(self) -> float:
        """Backoff before the next resubscribe attempt (counts a reconnect)."""
        self.reconnects += 1
        return self._ensure().next_delay() or self.cap_s

    def note_resync(self) -> None:
        """A 410 Gone forced a full relist."""
        self.resyncs += 1

    def note_healthy(self) -> None:
        """List/watch re-established: next failure episode backs off from
        the fast first retry again."""
        self._ensure().reset()


class EventType(str, enum.Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: EventType
    kind: str  # "Node" | "Pod"
    name: str
    obj: dict


class WatchSource(Protocol):
    def poll(self, now: float) -> list[WatchEvent]: ...

    # observe_* return None/True when the push landed durably; an explicit
    # False means "failed, retry me next tick" (a live apiserver can 500).
    def observe_binding(self, pod_name: str, node_name: str, now: float): ...

    def observe_deletion(self, pod_name: str, now: float): ...


@dataclass
class WatchDriver:
    """Pumps a WatchSource into a Cluster store and pushes decisions back."""

    cluster: "object"  # orchestrator.store.Cluster (duck-typed to avoid cycle)
    source: WatchSource
    backend: Optional["object"] = None  # backend.client.BackendClient
    # Workload CR events (PodCliqueSet, kubernetes source): handed to the
    # manager's admission-gated apply/delete path, NOT written raw into the
    # store — watch events never bypass the webhook-analog chain.
    workload_sink: Optional[object] = None  # callable(WatchEvent)
    child_scale_sink: Optional[object] = None  # callable(WatchEvent, now)
    # pods we've told the source about (bind pushed), and known-deleted pods
    _pushed_bindings: set[str] = field(default_factory=set)
    # pods whose bind FAILED after the source may have already materialized
    # the object (create-succeeded/bind-500): if the store drops such a pod
    # before a retry lands, it still needs an outbound deletion or the real
    # cluster keeps an unschedulable Pending pod forever.
    _attempted_bindings: set[str] = field(default_factory=set)
    _nodes_dirty: bool = field(default=True)
    # last-pushed CR status (JSON-canonical) per PCS: change detection for
    # the status write-back
    _pushed_status: dict = field(default_factory=dict)
    # control-plane events already mirrored as corev1 Events (index into
    # cluster.events)
    _pushed_events: int = 0

    # ---- inbound: events -> store --------------------------------------------------

    def pump(self, now: float) -> int:
        """Apply all due events; returns how many were applied."""
        events = self.source.poll(now)
        for ev in events:
            if ev.kind == "Node":
                self._apply_node(ev, now)
            elif ev.kind == "Pod":
                self._apply_pod(ev, now)
            elif ev.kind == "PodCliqueSet" and self.workload_sink is not None:
                if ev.type == EventType.ADDED:
                    # A CR (re)appeared at the apiserver: any cached "no CR
                    # there" status-push verdict is stale — push again even
                    # if the status itself hasn't changed since.
                    self._pushed_status.pop(ev.name, None)
                self.workload_sink(ev, now)
            elif (
                ev.kind in ("PodClique", "PodCliqueScalingGroup")
                and self.child_scale_sink is not None
            ):
                # External writes to the child CRs' scale subresource
                # (kubectl scale pclq / a cluster HPA); echoes of our own
                # projection PUTs no-op inside the sink.
                self.child_scale_sink(ev, now)
        # Dirty-flag, not event-count, gates forwarding: a failed UpdateCluster
        # (sidecar briefly down) must retry on the NEXT pump even if no new
        # node events arrive in between.
        if self.backend is not None and self._nodes_dirty:
            self._forward_nodes()
        return len(events)

    def _apply_node(self, ev: WatchEvent, now: float) -> None:
        c = self.cluster
        if ev.type == EventType.DELETED:
            c.nodes.pop(ev.name, None)
            # Pods on a vanished node are failed-with-the-machine; status
            # rollup + gang termination handle recovery from there.
            for pod in c.pods.values():
                if pod.node_name == ev.name and pod.is_active:
                    pod.phase = PodPhase.FAILED
                    pod.ready = False
        else:
            c.nodes[ev.name] = Node(
                name=ev.name,
                capacity=dict(ev.obj.get("capacity", {})),
                labels=dict(ev.obj.get("labels", {})),
                schedulable=bool(ev.obj.get("schedulable", True)),
                taints=[dict(t) for t in ev.obj.get("taints", [])],
            )
        self._nodes_dirty = True

    def _apply_pod(self, ev: WatchEvent, now: float) -> None:
        """Stale-view discipline: only mutate a pod that still exists AND is
        still bound where the event says — a lagged event for a deleted or
        re-placed pod is dropped, never resurrected."""
        pod = self.cluster.pods.get(ev.name)
        if pod is None:
            return  # controller already deleted it; lagged event is stale
        if ev.type == EventType.DELETED:
            # Controller-initiated deletions leave the store first, so a
            # DELETED for a pod still in the store is an OUT-OF-BAND removal
            # (kubectl delete, eviction): the pod died with the external
            # world — fail it so status rollup + gang termination recover,
            # and drop the binding record so a recreated namesake re-pushes.
            if pod.is_scheduled:
                pod.phase = PodPhase.FAILED
                pod.ready = False
                self._pushed_bindings.discard(ev.name)
            return
        node = ev.obj.get("node")
        if node is not None and pod.node_name != node:
            return  # stale: the pod has been re-placed since this event
        phase = ev.obj.get("phase")
        if phase is not None:
            try:
                pod.phase = PodPhase(phase)
            except ValueError:
                return  # unknown phase string from a foreign source: drop
        if "ready" in ev.obj:
            pod.ready = bool(ev.obj["ready"])
            if pod.ready and pod.started_at is None:
                pod.started_at = now

    # ---- outbound: store decisions -> source/backend -------------------------------

    def push(self, now: float) -> int:
        """Tell the source about new bindings and deletions; returns pushes.

        A push is recorded as done only when the source does NOT report
        failure (an explicit False return): a transient apiserver error on
        bind/delete must leave the pod in the retry set, or the store
        believes a placement the cluster never saw (orphaned forever)."""
        c = self.cluster
        pushed = 0
        live = set()
        for pod in c.pods.values():
            live.add(pod.name)
            if pod.is_scheduled and pod.name not in self._pushed_bindings:
                ok = self.source.observe_binding(pod.name, pod.node_name, now)
                if ok is not False:
                    self._pushed_bindings.add(pod.name)
                    self._attempted_bindings.discard(pod.name)
                    pushed += 1
                else:
                    self._attempted_bindings.add(pod.name)
        for name in list(self._pushed_bindings | self._attempted_bindings):
            if name not in live:
                ok = self.source.observe_deletion(name, now)
                if ok is not False:
                    self._pushed_bindings.discard(name)
                    self._attempted_bindings.discard(name)
                    pushed += 1
        pushed += self._push_workload_statuses()
        sync_services = getattr(self.source, "sync_services", None)
        if sync_services is not None:
            # Managed headless Services mirror to the real cluster (pod DNS
            # needs them); the source change-detects, so this is cheap.
            sync_services(list(self.cluster.services.values()))
        sync_rbac = getattr(self.source, "sync_rbac", None)
        if sync_rbac is not None:
            # SA/Role/RoleBinding BEFORE the token Secret that binds to the
            # SA (initcMode kubernetes; no-op in operator mode).
            sync_rbac(
                list(self.cluster.service_accounts.values()),
                list(self.cluster.roles.values()),
                list(self.cluster.role_bindings.values()),
            )
        sync_secrets = getattr(self.source, "sync_secrets", None)
        if sync_secrets is not None:
            # SA-token Secrets BEFORE pods need their mounts.
            sync_secrets(list(self.cluster.secrets.values()))
        sync_children = getattr(self.source, "sync_workload_children", None)
        if sync_children is not None:
            # kubectl-visible PodClique/PCSG projections (status included).
            sync_children(
                list(self.cluster.podcliques.values()),
                list(self.cluster.scaling_groups.values()),
            )
        publish_events = getattr(self.source, "publish_events", None)
        if publish_events is not None:
            # Control-plane events -> corev1 Events (kubectl get events).
            # High-water mark in the store's MONOTONIC event index
            # (events_total), not a deque position — the bounded ring drops
            # its oldest entries, so positions shift; events that fell off
            # before mirroring count as pushed (they are gone either way).
            evs = self.cluster.recent_events()
            skip = len(evs) - (self.cluster.events_total - self._pushed_events)
            if skip < 0:
                self._pushed_events = self.cluster.events_total - len(evs)
                skip = 0
            new = evs[skip : skip + 100]
            if new:
                self._pushed_events += publish_events(new)
        return pushed

    def _push_workload_statuses(self) -> int:
        """Reconciled PCS status -> the CR's status subresource (sources
        without publish_workload_status — KWOK — skip). Change-detected so
        a quiet control plane writes nothing."""
        publish = getattr(self.source, "publish_workload_status", None)
        if publish is None:
            return 0
        from grove_tpu_torch.utils.serde import to_k8s

        pushed = 0
        for name, pcs in list(self.cluster.podcliquesets.items()):
            doc = to_k8s(pcs.status)
            key = json.dumps(doc, sort_keys=True)
            if self._pushed_status.get(name) == key:
                continue
            ok = publish(name, doc)
            # None = no CR at the apiserver (store-only workload): record
            # the key so the doomed GET doesn't repeat every tick; False =
            # transient, retry next tick.
            if ok is not False:
                self._pushed_status[name] = key
                if ok is True:
                    pushed += 1
        for name in [n for n in self._pushed_status if n not in self.cluster.podcliquesets]:
            del self._pushed_status[name]
        return pushed

    def step(self, now: float) -> None:
        """One full exchange: inbound events, then outbound decisions."""
        self.pump(now)
        self.push(now)

    # ---- backend forwarding ---------------------------------------------------------

    def _forward_nodes(self) -> None:
        """Mirror the store's node fleet into the sidecar (UpdateCluster)."""
        self.backend.update_cluster(list(self.cluster.nodes.values()), full_replace=True)
        self._nodes_dirty = False
