"""Thin typed client for the grove-tpu scheduler-backend sidecar.

The operator-side half of the GREP-375 boundary: what the Go shim (or the
Python orchestrator in simulation) calls. One unary stub per RPC, protobuf
in/out — no generated stubs needed.
"""

from __future__ import annotations

import grpc

from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as pb
from grove_tpu_torch.backend.service import SERVICE_NAME

def node_to_proto(node) -> pb.Node:
    """state.cluster.Node -> pb.Node (the UpdateCluster feed of a node watch)."""
    return pb.Node(
        name=node.name,
        capacity=[pb.ResourceQuantity(name=k, value=v) for k, v in node.capacity.items()],
        labels=dict(node.labels),
        schedulable=node.schedulable,
        taints=[
            pb.Taint(
                key=t.get("key", ""),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in getattr(node, "taints", [])
        ],
    )


def _pack_proto(tc, out: pb.PackConstraint) -> None:
    p = getattr(tc, "pack_constraint", None) if tc is not None else None
    if p is not None:
        out.required_key = p.required or ""
        out.preferred_key = p.preferred or ""


def gang_to_proto(gang, pods_by_name: dict) -> pb.PodGangSpec:
    """api.podgang.PodGang (+ its pods) -> pb.PodGangSpec, the SyncPodGang
    payload an operator sends: each group's per-pod requests, nodeSelector
    and tolerations are its first pod's (a group's pods share a template),
    pack constraints at all three levels, the scaled/base, reuse and spread
    identity."""
    spec = pb.PodGangSpec(
        name=gang.name,
        namespace=gang.namespace,
        priority_class_name=gang.spec.priority_class_name or "",
        base_podgang_name=gang.base_podgang_name or "",
        spread_key=gang.spec.spread_key or "",
        pcs_name=gang.pcs_name,
        pcs_replica_index=gang.pcs_replica_index,
    )
    _pack_proto(gang.spec.topology_constraint, spec.pack_constraint)
    ref = gang.spec.reuse_reservation_ref
    if ref is not None:
        spec.reuse_reservation_ref.namespace = ref.namespace
        spec.reuse_reservation_ref.name = ref.name
    for grp in gang.spec.pod_groups:
        g = spec.pod_groups.add(name=grp.name, min_replicas=grp.min_replicas)
        for r in grp.pod_references:
            g.pod_references.add(namespace=r.namespace, name=r.name)
        _pack_proto(grp.topology_constraint, g.pack_constraint)
        pod = pods_by_name.get(grp.pod_references[0].name) if grp.pod_references else None
        if pod is not None:
            for name, value in pod.spec.total_requests().items():
                g.per_pod_requests.add(name=name, value=value)
            g.node_selector.update(pod.spec.node_selector or {})
            for t in pod.spec.tolerations or []:
                g.tolerations.add(key=t.get("key", ""), operator=t.get("operator", ""),
                                  value=t.get("value", ""), effect=t.get("effect", ""))
    for gc in gang.spec.topology_constraint_group_configs:
        c = spec.group_configs.add(name=gc.name, pod_group_names=list(gc.pod_group_names))
        _pack_proto(gc.topology_constraint, c.pack_constraint)
    return spec


_RESPONSES = {
    "Init": pb.InitResponse,
    "SyncPodGang": pb.SyncPodGangResponse,
    "OnPodGangDelete": pb.OnPodGangDeleteResponse,
    "PreparePod": pb.PreparePodResponse,
    "ValidatePodCliqueSet": pb.ValidatePodCliqueSetResponse,
    "UpdateCluster": pb.UpdateClusterResponse,
    "ReleasePods": pb.ReleasePodsResponse,
    "Solve": pb.SolveResponse,
}


class BackendClient:
    def __init__(self, address: str):
        self._channel = grpc.insecure_channel(address)
        self._stubs = {
            name: self._channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=lambda req: req.SerializeToString(),
                response_deserializer=resp_cls.FromString,
            )
            for name, resp_cls in _RESPONSES.items()
        }

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "BackendClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def init(self, topology: list[tuple[str, str]]) -> pb.InitResponse:
        req = pb.InitRequest()
        for domain, key in topology:
            req.topology.append(pb.TopologyLevel(domain=domain, node_label_key=key))
        return self._stubs["Init"](req)

    def sync_pod_gang(self, spec: pb.PodGangSpec) -> pb.SyncPodGangResponse:
        return self._stubs["SyncPodGang"](pb.SyncPodGangRequest(pod_gang=spec))

    def on_pod_gang_delete(self, name: str, namespace: str = "default") -> pb.OnPodGangDeleteResponse:
        return self._stubs["OnPodGangDelete"](
            pb.OnPodGangDeleteRequest(name=name, namespace=namespace)
        )

    def prepare_pod(self, pod_name: str, pod_gang_name: str = "") -> pb.PreparePodResponse:
        return self._stubs["PreparePod"](
            pb.PreparePodRequest(pod_name=pod_name, pod_gang_name=pod_gang_name)
        )

    def validate_podcliqueset(self, pcs_yaml: str) -> pb.ValidatePodCliqueSetResponse:
        return self._stubs["ValidatePodCliqueSet"](
            pb.ValidatePodCliqueSetRequest(pcs_yaml=pcs_yaml)
        )

    def update_cluster(self, nodes: list, full_replace: bool = False) -> pb.UpdateClusterResponse:
        """Accepts pb.Node protos or state.cluster.Node objects."""
        protos = [n if isinstance(n, pb.Node) else node_to_proto(n) for n in nodes]
        return self._stubs["UpdateCluster"](
            pb.UpdateClusterRequest(nodes=protos, full_replace=full_replace)
        )

    def release_pods(self, pod_names: list[str]) -> pb.ReleasePodsResponse:
        return self._stubs["ReleasePods"](pb.ReleasePodsRequest(pod_names=pod_names))

    def solve(self) -> pb.SolveResponse:
        return self._stubs["Solve"](pb.SolveRequest())
