"""Dense cluster snapshot: nodes × resources × topology-domain arrays
(grove_tpu/state/cluster.py counterpart).

Encoding:
  capacity / allocated : float32 [N, R]  (base units; R = len(resource_names))
  node_domain_id       : int32  [L, N]   (domain ordinal per topology level;
                                          -1 = node not labeled at that level)
  schedulable          : bool   [N]      (False = cordoned/unready)

Topology levels are the sorted (broad→narrow) levels of the ClusterTopology
(clustertopology.go:92-136). Domain ordinals are dense per level so per-domain
aggregates are index sums over the node axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.types import ClusterTopology, TopologyDomain

DEFAULT_RESOURCES = ("cpu", "memory", "google.com/tpu", "nvidia.com/gpu")


@dataclass
class Node:
    """One schedulable node."""

    name: str
    capacity: dict[str, float] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    schedulable: bool = True
    # k8s taints ({"key", "value", "effect"}); NoSchedule/NoExecute block
    # placement unless the pod tolerates them (we ARE the scheduler).
    taints: list[dict] = field(default_factory=list)
    # Spot/preemptible capacity: a revocable node can receive a revocation
    # notice (revocation_deadline = sim/wall time the capacity disappears).
    # A pending notice makes the node unschedulable for new placement —
    # build_snapshot masks it — while existing bindings keep running until
    # the controller migrates or evicts them or the deadline kills the node.
    revocable: bool = False
    revocation_deadline: float | None = None


@dataclass
class ClusterSnapshot:
    """Immutable dense view of the cluster at one instant."""

    resource_names: tuple[str, ...]
    node_names: list[str]
    capacity: np.ndarray  # f32 [N, R]
    allocated: np.ndarray  # f32 [N, R]
    schedulable: np.ndarray  # bool [N]
    topology: ClusterTopology
    level_domains: list[TopologyDomain]  # broad→narrow, length L
    node_domain_id: np.ndarray  # i32 [L, N]
    domain_names: list[list[str]]  # per level: ordinal -> "/"-joined label path
    num_domains: np.ndarray  # i32 [L] (actual domain count per level)
    node_index_map: dict[str, int] = field(default_factory=dict)
    # Raw node labels and taints — nodeSelector and
    # toleration matching happen against these at encode time.
    node_labels: list[dict] = field(default_factory=list)
    node_taints: list[list] = field(default_factory=list)
    # Memos of the derived views below: the snapshot is immutable for its
    # lifetime, so each is computed once and read by every encode and
    # decode against it.
    _cap_scale: np.ndarray | None = field(default=None, repr=False, compare=False)
    _node_names_arr: np.ndarray | None = field(default=None, repr=False, compare=False)
    _tainted_idx: dict | None = field(default=None, repr=False, compare=False)
    _encode_epoch: tuple | None = field(default=None, repr=False, compare=False)

    def cap_scale(self) -> np.ndarray:
        """Per-resource capacity maxima (score normalization, encode group
        ordering)."""
        if self._cap_scale is None:
            self._cap_scale = np.maximum(self.capacity.max(axis=0), 1e-9)
        return self._cap_scale

    def node_names_arr(self) -> np.ndarray:
        """node_names as an object array (decode gathers through it)."""
        if self._node_names_arr is None:
            self._node_names_arr = np.asarray(self.node_names, dtype=object)
        return self._node_names_arr

    def tainted_node_indices(self, blocking_effects) -> list[int]:
        """Indices of nodes carrying scheduling-blocking taints, per
        effects set."""
        key = tuple(sorted(blocking_effects))
        if self._tainted_idx is None:
            self._tainted_idx = {}
        if key not in self._tainted_idx:
            self._tainted_idx[key] = [
                i
                for i, taints in enumerate(self.node_taints)
                if any(t.get("effect") in blocking_effects for t in taints)
            ]
        return self._tainted_idx[key]

    def encode_epoch(self) -> tuple:
        """Hashable digest of every snapshot input the encode reads: the
        resource axis, capacity (group ordering), the domain map (pack-set
        pins), node labels (selector rows) and node taints (toleration
        rows). The encode-row cache (solver/warm.py) keys rows on it, so a
        row is never reused against a snapshot it was not built for."""
        if self._encode_epoch is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            h.update(repr(self.resource_names).encode())
            h.update(np.ascontiguousarray(self.capacity).tobytes())
            h.update(np.ascontiguousarray(self.node_domain_id).tobytes())
            for labels in self.node_labels:
                h.update(repr(sorted(labels.items())).encode())
            for taints in self.node_taints:
                if taints:
                    h.update(repr(taints).encode())
            self._encode_epoch = (self.capacity.shape, h.hexdigest())
        return self._encode_epoch

    @property
    def free(self) -> np.ndarray:
        return self.capacity - self.allocated

    def node_index(self, name: str) -> int:
        return self.node_index_map[name]


def build_snapshot(
    nodes: list[Node],
    topology: ClusterTopology,
    bound_pods: list[Pod] | None = None,
    *,
    resource_names: tuple[str, ...] = DEFAULT_RESOURCES,
    pad_nodes_to: int | None = None,
) -> ClusterSnapshot:
    """Flatten node objects + topology labels into the dense snapshot over
    `resource_names`; `bound_pods` already hold capacity on their nodes.
    `pad_nodes_to` pads the node axis with unschedulable zero-capacity rows
    (a journaled wave's recorded node pad)."""
    topology = topology.with_host_level()
    levels = topology.sorted_levels()
    n_real = len(nodes)
    n = pad_nodes_to if pad_nodes_to is not None else n_real
    if n < n_real:
        raise ValueError(f"pad_nodes_to={n} < node count {n_real}")
    r = len(resource_names)

    capacity = np.zeros((n, r), dtype=np.float32)
    schedulable = np.zeros((n,), dtype=bool)
    for i, node in enumerate(nodes):
        # A revocation-pending node is masked like a cordoned one: every
        # placement path (serving solves, defrag, rescue) reads this array,
        # so no new pod lands on capacity that is about to vanish.
        schedulable[i] = node.schedulable and node.revocation_deadline is None
        for j, res in enumerate(resource_names):
            capacity[i, j] = node.capacity.get(res, 0.0)

    node_domain_id = np.full((len(levels), n), -1, dtype=np.int32)
    domain_names: list[list[str]] = []
    num_domains = np.zeros((len(levels),), dtype=np.int32)
    # Domain identity is the PATH of label values down the hierarchy, not the
    # raw value: rack "rack-1" in zone "z0" is a different physical rack than
    # "rack-1" in zone "z1". Every node gets a host value (label or node
    # name), so host-level ordinal == node index.
    node_paths: list[tuple[str, ...]] = [() for _ in range(n_real)]
    for li, level in enumerate(levels):
        ordinals: dict[tuple[str, ...], int] = {}
        for i, node in enumerate(nodes):
            value = node.labels.get(level.node_label_key)
            if value is None and level.domain == TopologyDomain.HOST:
                value = node.name  # hostname label implied by node identity
            if value is None:
                continue
            path = node_paths[i] + (value,)
            node_paths[i] = path
            if path not in ordinals:
                ordinals[path] = len(ordinals)
            node_domain_id[li, i] = ordinals[path]
        domain_names.append(["/".join(p) for p in ordinals])  # dicts keep ordinal order
        num_domains[li] = len(ordinals)
        if level.domain == TopologyDomain.HOST and len(ordinals) != n_real:
            raise ValueError(
                f"duplicate host-level domain values: {len(ordinals)} host "
                f"domains for {n_real} nodes (host labels must be unique)"
            )

    snap = ClusterSnapshot(
        resource_names=tuple(resource_names),
        node_names=[x.name for x in nodes],
        capacity=capacity,
        allocated=np.zeros_like(capacity),
        schedulable=schedulable,
        topology=topology,
        level_domains=[lv.domain for lv in levels],
        node_domain_id=node_domain_id,
        domain_names=domain_names,
        num_domains=num_domains,
        node_index_map={x.name: i for i, x in enumerate(nodes)},
        node_labels=[x.labels for x in nodes] + [{} for _ in range(n - n_real)],
        node_taints=[x.taints for x in nodes] + [[] for _ in range(n - n_real)],
    )
    for pod in bound_pods or []:
        # Skip stale bindings to nodes that no longer exist: the binding
        # holds no capacity on any node in this snapshot.
        if pod.node_name is not None and pod.node_name in snap.node_index_map:
            apply_binding(snap, pod)
    return snap


def pod_request_vector(pod: Pod, resource_names: tuple[str, ...]) -> np.ndarray:
    total = pod.spec.total_requests()
    return np.array([total.get(res, 0.0) for res in resource_names], dtype=np.float32)


def apply_binding(snap: ClusterSnapshot, pod: Pod) -> None:
    """Account a bound pod's requests against its node."""
    idx = snap.node_index(pod.node_name)
    snap.allocated[idx] += pod_request_vector(pod, snap.resource_names)


def release_binding(snap: ClusterSnapshot, pod: Pod) -> None:
    """Return a bound pod's requests to its node (clamped at 0)."""
    idx = snap.node_index(pod.node_name)
    snap.allocated[idx] -= pod_request_vector(pod, snap.resource_names)
    np.maximum(snap.allocated[idx], 0.0, out=snap.allocated[idx])
