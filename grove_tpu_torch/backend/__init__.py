"""Scheduler-backend boundary: gRPC sidecar + client (GREP-375 contract).

The port's copy of grove_tpu/backend: the servicer solves on the card unless
the caller passes device="cpu"; the wire contract (proto package
`grove_tpu.backend.v1`, byte-identical .proto and descriptor) is the JAX
package's and the Go shim's."""

from grove_tpu_torch.backend.client import BackendClient
from grove_tpu_torch.backend.service import (
    BACKEND_NAME,
    PENDING_GATE,
    SCHEDULER_NAME,
    SERVICE_NAME,
    TPUSchedulerBackend,
    create_server,
)

__all__ = [
    "BACKEND_NAME",
    "BackendClient",
    "PENDING_GATE",
    "SCHEDULER_NAME",
    "SERVICE_NAME",
    "TPUSchedulerBackend",
    "create_server",
]
