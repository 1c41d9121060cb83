"""Dense cluster snapshot tensors."""

from grove_tpu_torch.state.cluster import (  # noqa: F401
    DEFAULT_RESOURCES,
    ClusterSnapshot,
    Node,
    apply_binding,
    build_snapshot,
    pod_request_vector,
)
