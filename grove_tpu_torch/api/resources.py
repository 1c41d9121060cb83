"""Managed auxiliary resources: Service, HPA, RBAC, SA token Secret.

The reference's PodCliqueSet controller materializes these as first-class
Kubernetes objects per PCS (ordered kinds,
`podcliqueset/reconcilespec.go:206-221`):
  - per-replica headless Service for DNS discovery
    (`components/service/service.go:137-155`)
  - HorizontalPodAutoscaler per auto-scaled PCLQ / PCSG
    (`components/hpa/hpa.go:130,249-259`)
  - ServiceAccount + Role + RoleBinding + long-lived token Secret — the
    credentials grove-initc uses to watch pods
    (`components/serviceaccount|role|rolebinding|satokensecret/`)

Here they are typed store objects with the same ownership/GC semantics; the
token Secret is LIVE credential material — the manager's HTTP API (the
apiserver analog the initc agent polls) verifies it when the authorizer is
enabled.

The port's copy of grove_tpu/api/resources.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import hashlib
import secrets as _secrets
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class HeadlessService:
    """ClusterIP:None discovery service per PCS replica (service.go:137-155)."""

    name: str
    namespace: str = "default"
    pcs_name: str = ""
    pcs_replica_index: int = 0
    cluster_ip: str = "None"
    publish_not_ready_addresses: bool = True
    selector: dict[str, str] = field(default_factory=dict)


@dataclass
class HorizontalPodAutoscaler:
    """HPA over a CR scale subresource (hpa.go:249-259)."""

    name: str
    namespace: str = "default"
    pcs_name: str = ""
    target_kind: str = "PodClique"  # or PodCliqueScalingGroup
    target_name: str = ""  # FQN — the scale-override key
    min_replicas: int = 1
    max_replicas: int = 1
    # The target's spec replicas at build time — the scaling baseline before
    # any override exists (avoids fuzzy FQN->template back-resolution).
    target_spec_replicas: int = 1
    metrics: list[dict[str, Any]] = field(default_factory=list)


@dataclass
class ServiceAccount:
    name: str
    namespace: str = "default"
    pcs_name: str = ""


@dataclass
class Role:
    """Minimal rules model: what the initc credential may do."""

    name: str
    namespace: str = "default"
    pcs_name: str = ""
    rules: list[dict[str, Any]] = field(
        default_factory=lambda: [
            {"apiGroup": "grove.io", "resources": ["podcliques"], "verbs": ["get", "list"]},
            {"apiGroup": "", "resources": ["pods"], "verbs": ["get", "list"]},
        ]
    )


@dataclass
class RoleBinding:
    name: str
    namespace: str = "default"
    pcs_name: str = ""
    role_name: str = ""
    service_account_name: str = ""


@dataclass
class TokenSecret:
    """Long-lived SA token the initc agent presents to the manager API
    (satokensecret component analog). The token value is generated once at
    create and persisted with the control-plane state."""

    name: str
    namespace: str = "default"
    pcs_name: str = ""
    service_account_name: str = ""
    token: str = ""

    def __post_init__(self):
        if not self.token:
            self.token = _secrets.token_hex(16)

    def fingerprint(self) -> str:
        return hashlib.sha256(self.token.encode()).hexdigest()[:12]


def build_pcs_rbac(pcs_name: str, namespace: str) -> tuple[
    ServiceAccount, Role, RoleBinding, TokenSecret
]:
    """The four per-PCS credential objects, reference-named (namegen.go)."""
    from grove_tpu_torch.api import naming

    sa = ServiceAccount(
        name=naming.pod_service_account_name(pcs_name),
        namespace=namespace,
        pcs_name=pcs_name,
    )
    role = Role(
        name=naming.pod_role_name(pcs_name), namespace=namespace, pcs_name=pcs_name
    )
    binding = RoleBinding(
        name=naming.pod_role_binding_name(pcs_name),
        namespace=namespace,
        pcs_name=pcs_name,
        role_name=role.name,
        service_account_name=sa.name,
    )
    secret = TokenSecret(
        name=naming.initc_sa_token_secret_name(pcs_name),
        namespace=namespace,
        pcs_name=pcs_name,
        service_account_name=sa.name,
    )
    return sa, role, binding, secret
