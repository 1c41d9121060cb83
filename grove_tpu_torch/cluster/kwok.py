"""KWOK-shaped fake cluster: fabricated nodes + staged pod lifecycles.

The reference scales its control plane against KWOK v0.7.0 fake nodes
(`operator/hack/kind-up.sh:31,245-265`): nodes exist as API objects, and
stage configs advance bound pods through Pending → Running → Ready on timers
without any kubelet. This module is that mechanism for the TPU stack — an
external "cluster" the control plane only sees through watch events:

  control plane --> observe_binding(pod, node)    (the bind call)
  cluster       --> WatchEvent stream             (node + pod state changes)

`event_lag_s` models informer latency: an event becomes visible to pollers
only lag seconds after it happened. This is the stale-read window that
motivates the reference's ExpectationsStore
(`operator/internal/expect/expectations.go:33-71`); the WatchDriver's apply
discipline is tested against it.

Clock discipline matches grove_tpu_torch/sim: explicit `now` everywhere, no
wall-clock reads, so tests are deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from grove_tpu_torch.cluster.watch import EventType, WatchEvent
from grove_tpu_torch.state.cluster import Node


@dataclass
class _KwokPod:
    name: str
    node: str
    bound_at: float
    running_at: float | None = None
    ready_at: float | None = None
    deleted: bool = False


@dataclass
class KwokCluster:
    """Fake node fleet with staged pod lifecycles and lagged watch delivery."""

    nodes: dict[str, Node] = field(default_factory=dict)
    # Stage latencies (kind-up.sh:264-265 stage configs): bind -> Running,
    # Running -> Ready.
    running_delay_s: float = 0.5
    ready_delay_s: float = 0.5
    event_lag_s: float = 0.0

    _pods: dict[str, _KwokPod] = field(default_factory=dict)
    _queue: list[tuple[float, WatchEvent]] = field(default_factory=list)  # (visible_at, ev)

    # ---- cluster-side mutations (the "real world") -------------------------------

    def add_node(self, node: Node, now: float) -> None:
        self.nodes[node.name] = node
        self._emit(now, EventType.ADDED, "Node", node.name, self._node_payload(node))

    def remove_node(self, name: str, now: float) -> None:
        """Node disappears; its pods fail (terminated with the machine)."""
        self.nodes.pop(name, None)
        self._emit(now, EventType.DELETED, "Node", name, {})
        for pod in self._pods.values():
            if pod.node == name and not pod.deleted:
                pod.deleted = True
                self._emit(
                    now, EventType.MODIFIED, "Pod", pod.name,
                    {"phase": "Failed", "ready": False, "node": name},
                )

    def set_schedulable(self, name: str, schedulable: bool, now: float) -> None:
        node = self.nodes[name]
        node.schedulable = schedulable
        self._emit(now, EventType.MODIFIED, "Node", name, self._node_payload(node))

    def fail_pod(self, name: str, now: float) -> None:
        pod = self._pods.get(name)
        if pod is None or pod.deleted:
            return
        pod.deleted = True
        self._emit(
            now, EventType.MODIFIED, "Pod", name,
            {"phase": "Failed", "ready": False, "node": pod.node},
        )

    # ---- control-plane side ------------------------------------------------------

    def observe_binding(self, pod_name: str, node_name: str, now: float) -> None:
        """The bind call: control plane placed pod on node; stages start."""
        if pod_name in self._pods:
            return
        self._pods[pod_name] = _KwokPod(name=pod_name, node=node_name, bound_at=now)

    def observe_deletion(self, pod_name: str, now: float) -> None:
        """Control plane deleted the pod object; stop its lifecycle."""
        pod = self._pods.pop(pod_name, None)
        if pod is not None and not pod.deleted:
            self._emit(now, EventType.DELETED, "Pod", pod_name, {"node": pod.node})

    # ---- time + watch ------------------------------------------------------------

    def tick(self, now: float) -> None:
        """Advance pod stages up to `now` (KWOK stage controller analog)."""
        for pod in self._pods.values():
            if pod.deleted:
                continue
            if pod.running_at is None and now >= pod.bound_at + self.running_delay_s:
                pod.running_at = pod.bound_at + self.running_delay_s
                self._emit(
                    pod.running_at, EventType.MODIFIED, "Pod", pod.name,
                    {"phase": "Running", "ready": False, "node": pod.node},
                )
            if (
                pod.running_at is not None
                and pod.ready_at is None
                and now >= pod.running_at + self.ready_delay_s
            ):
                pod.ready_at = pod.running_at + self.ready_delay_s
                self._emit(
                    pod.ready_at, EventType.MODIFIED, "Pod", pod.name,
                    {"phase": "Running", "ready": True, "node": pod.node},
                )

    def poll(self, now: float) -> list[WatchEvent]:
        """Deliver events whose lag window has passed, in emission order."""
        self.tick(now)
        due = [(t, e) for t, e in self._queue if t <= now]
        self._queue = [(t, e) for t, e in self._queue if t > now]
        return [e for _, e in due]

    # ---- internals ---------------------------------------------------------------

    def _node_payload(self, node: Node) -> dict:
        return {
            "capacity": dict(node.capacity),
            "labels": dict(node.labels),
            "schedulable": node.schedulable,
            "taints": [dict(t) for t in node.taints],
        }

    def _emit(self, at: float, etype: EventType, kind: str, name: str, obj: dict) -> None:
        self._queue.append((at + self.event_lag_s, WatchEvent(etype, kind, name, obj)))


def kwok_fleet(nodes: list[Node], now: float = 0.0, **kwargs) -> KwokCluster:
    """Boot a KwokCluster pre-populated with `nodes` (events included)."""
    cluster = KwokCluster(**kwargs)
    for node in nodes:
        cluster.add_node(node, now)
    return cluster


def kwok_fleet_from_config(cluster_cfg, topology, now: float = 0.0) -> KwokCluster:
    """Fabricate the fleet declared by `cluster.source: kwok` in the operator
    config — the in-binary `make kind-up FAKE_NODES=N` analog
    (operator/hack/kind-up.sh:31,252-265).

    Every non-host topology level gets a node label so TAS pack constraints
    resolve against this fleet: hosts group into racks of `kwokHostsPerRack`,
    racks into blocks of `kwokRacksPerBlock`, and each broader level groups
    by the matching `kwokLevelGroupFactors` entry (narrowest first). The
    default zone-over-block shape keeps an implicit factor of 4 (the e2e
    rig's shape, operator/hack/e2e-cluster/create-e2e-cluster.py:133-135);
    config validation demands explicit factors only for hierarchies deeper
    than zone.
    """
    from grove_tpu_torch.api.types import TopologyDomain

    levels = [
        lvl
        for lvl in topology.sorted_levels()
        if lvl.domain != TopologyDomain.HOST
    ]
    # Group sizes, narrowest level first.
    factors = list(getattr(cluster_cfg, "kwok_level_group_factors", []) or [])
    sizes: list[int] = []
    for i in range(len(levels)):
        if i == 0:
            sizes.append(max(1, cluster_cfg.kwok_hosts_per_rack))
        elif i == 1:
            sizes.append(sizes[-1] * max(1, cluster_cfg.kwok_racks_per_block))
        elif i - 2 < len(factors):
            sizes.append(sizes[-1] * max(1, factors[i - 2]))
        else:
            # Implicit zone factor for the default <=3-level shape; configs
            # deeper than zone never get here (validation requires explicit
            # factors for them).
            sizes.append(sizes[-1] * 4)
    nodes = []
    # Revocable (spot) slice: the LAST `cluster.revocableNodes` nodes carry
    # the revocable attribute — the fleet segment a revocation notice
    # (sim.node_revocation site / Simulator.revoke_node) may take back.
    revocable_from = cluster_cfg.kwok_nodes - max(
        0, int(getattr(cluster_cfg, "revocable_nodes", 0) or 0)
    )
    for n in range(cluster_cfg.kwok_nodes):
        labels: dict[str, str] = {}
        for lvl, size in zip(reversed(levels), sizes):
            labels[lvl.node_label_key] = f"{lvl.domain.value}-{n // size}"
        nodes.append(
            Node(
                name=f"kwok-{n}",
                capacity={
                    "cpu": cluster_cfg.kwok_cpu_per_node,
                    "memory": cluster_cfg.kwok_memory_per_node,
                    "google.com/tpu": cluster_cfg.kwok_tpu_per_node,
                },
                labels=labels,
                revocable=n >= revocable_from,
            )
        )
    return kwok_fleet(
        nodes,
        now=now,
        running_delay_s=cluster_cfg.running_delay_seconds,
        ready_delay_s=cluster_cfg.ready_delay_seconds,
        event_lag_s=cluster_cfg.event_lag_seconds,
    )
