"""Typed object clients over the manager API — the generated-clientset analog
(grove_tpu/client/typed.py counterpart).

The reference ships generated typed clientsets/informers/listers with fakes
(`operator/client/`, `scheduler/client/`, incl.
`scheduler/client/clientset/versioned/fake/`). Here the same two surfaces:

  GroveClient      — HTTP client over the manager's /api/v1 object API
                     (list/get for every collection, apply/delete for
                     PodCliqueSets through the admission chain)
  FakeGroveClient  — same interface over an in-process Manager, for tests
                     that don't want a socket (the fake-clientset analog)

Typed: get_* return the real dataclasses (decoded via utils/serde), not raw
dicts.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional

from grove_tpu_torch.utils import serde

# Typed decode needs the object modules registered (same set the
# control-plane persistence uses).
from grove_tpu_torch.api import pod as _pod
from grove_tpu_torch.api import podgang as _podgang
from grove_tpu_torch.api import resources as _resources
from grove_tpu_torch.api import types as _types
from grove_tpu_torch.state import cluster as _state

for _m in (_types, _pod, _podgang, _state, _resources):
    serde.register_module(_m)


class GroveApiError(Exception):
    def __init__(self, status: int, errors: list[str]):
        self.status = status
        self.errors = errors
        super().__init__(f"HTTP {status}: " + "; ".join(errors))


class GroveClient:
    """HTTP(S) typed client (apiserver-analog surface).

    `cafile` pins the manager's serving cert (the auto-mode self-signed cert
    doubles as the CA bundle: <tlsCertDir>/tls.crt); `token` is the bearer
    credential for authorizer-enabled managers."""

    def __init__(
        self,
        base_url: str,
        actor: str = "user",
        timeout_s: float = 10.0,
        cafile: str | None = None,
        token: str | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.actor = actor
        self.timeout_s = timeout_s
        self.token = token
        self._ssl_ctx = None
        if cafile is not None:
            from grove_tpu_torch.runtime.certs import pinned_client_context

            self._ssl_ctx = pinned_client_context(cafile)

    # -- transport ------------------------------------------------------------------

    def _request(self, method: str, path: str, body: bytes | None = None) -> Any:
        req = urllib.request.Request(
            f"{self.base_url}{path}", data=body, method=method
        )
        req.add_header("X-Grove-Actor", self.actor)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout_s, context=self._ssl_ctx
            ) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read())
                errors = doc.get("errors", [str(e)])
            except Exception:
                errors = [str(e)]
            raise GroveApiError(e.code, errors) from e

    def _list(self, kind: str) -> list[str]:
        return self._request("GET", f"/api/v1/{kind}")

    def _list_full(self, kind: str) -> dict[str, Any]:
        """One round trip for every object of a kind (?full=1) — the table
        path; per-name gets would be N+1 requests at cluster scale."""
        doc = self._request("GET", f"/api/v1/{kind}?full=1")
        return {name: serde.decode(obj) for name, obj in doc.items()}

    def _get(self, kind: str, name: str):
        return serde.decode(self._request("GET", f"/api/v1/{kind}/{name}"))

    # -- typed surface ---------------------------------------------------------------

    def list_podcliquesets(self) -> list[str]:
        return self._list("podcliquesets")

    def list_podcliquesets_full(self) -> dict[str, Any]:
        return self._list_full("podcliquesets")

    def list_podgangs_full(self) -> dict[str, Any]:
        return self._list_full("podgangs")

    def list_podcliques_full(self) -> dict[str, Any]:
        return self._list_full("podcliques")

    def list_scaling_groups_full(self) -> dict[str, Any]:
        return self._list_full("podcliquescalinggroups")

    def list_pods_full(self) -> dict[str, Any]:
        return self._list_full("pods")

    def list_nodes_full(self) -> dict[str, Any]:
        return self._list_full("nodes")

    def get_podcliqueset(self, name: str):
        return self._get("podcliquesets", name)

    def apply_podcliqueset(self, doc_or_yaml: dict | str) -> str:
        body = (
            doc_or_yaml if isinstance(doc_or_yaml, str) else json.dumps(doc_or_yaml)
        ).encode()
        return self._request("POST", "/api/v1/podcliquesets", body)["name"]

    def delete_podcliqueset(self, name: str) -> None:
        self._request("DELETE", f"/api/v1/podcliquesets/{name}")

    def list_podgangs(self) -> list[str]:
        return self._list("podgangs")

    def get_podgang(self, name: str):
        return self._get("podgangs", name)

    def list_pods(self) -> list[str]:
        return self._list("pods")

    def get_pod(self, name: str):
        return self._get("pods", name)

    def list_nodes(self) -> list[str]:
        return self._list("nodes")

    def get_node(self, name: str):
        return self._get("nodes", name)

    def list_services(self) -> list[str]:
        return self._list("services")

    def list_hpas(self) -> list[str]:
        return self._list("hpas")

    def events(self) -> list[tuple[float, str, str]]:
        return [tuple(e) for e in self._request("GET", "/api/v1/events")]

    def push_metrics(self, metrics: dict[str, float]) -> int:
        """HPA utilization feed (metrics-server analog): target FQN ->
        utilization normalized to the target (1.0 == at target)."""
        resp = self._request(
            "POST", "/api/v1/metrics", json.dumps(metrics).encode()
        )
        return resp["targets"]

    def scale(self, target: str, replicas: int) -> int:
        """kubectl-scale analog: set a PodClique/PCSG scale subresource.
        Returns the previous effective replica count."""
        resp = self._request(
            "POST",
            "/api/v1/scale",
            json.dumps({"target": target, "replicas": replicas}).encode(),
        )
        return resp["previous"]

    def statusz(self) -> dict:
        """Operator status document (build info, leadership, queue
        quota/usage, object counts)."""
        return self._request("GET", "/statusz")


class FakeGroveClient:
    """In-process fake with the same typed surface (fake-clientset analog).

    Backed by a live Manager: reads hit the store directly; applies run the
    same admission chain the HTTP path uses."""

    def __init__(self, manager, actor: str = "user"):
        self.manager = manager
        self.actor = actor

    def _coll(self, kind: str) -> dict:
        return {
            "podcliquesets": self.manager.cluster.podcliquesets,
            "podcliques": self.manager.cluster.podcliques,
            "podcliquescalinggroups": self.manager.cluster.scaling_groups,
            "podgangs": self.manager.cluster.podgangs,
            "pods": self.manager.cluster.pods,
            "nodes": self.manager.cluster.nodes,
            "services": self.manager.cluster.services,
            "hpas": self.manager.cluster.hpas,
        }[kind]

    def _list(self, kind: str) -> list[str]:
        return sorted(self._coll(kind))

    def _get(self, kind: str, name: str):
        obj = self._coll(kind).get(name)
        if obj is None:
            raise GroveApiError(404, ["not found"])
        return obj

    list_podcliquesets = lambda self: self._list("podcliquesets")  # noqa: E731
    list_podgangs = lambda self: self._list("podgangs")  # noqa: E731
    list_pods = lambda self: self._list("pods")  # noqa: E731
    list_nodes = lambda self: self._list("nodes")  # noqa: E731
    list_services = lambda self: self._list("services")  # noqa: E731
    list_hpas = lambda self: self._list("hpas")  # noqa: E731

    def _list_full(self, kind: str) -> dict:
        return dict(sorted(self._coll(kind).items()))

    list_podcliquesets_full = lambda self: self._list_full("podcliquesets")  # noqa: E731
    list_podgangs_full = lambda self: self._list_full("podgangs")  # noqa: E731
    list_podcliques_full = lambda self: self._list_full("podcliques")  # noqa: E731
    list_scaling_groups_full = lambda self: self._list_full("podcliquescalinggroups")  # noqa: E731
    list_pods_full = lambda self: self._list_full("pods")  # noqa: E731
    list_nodes_full = lambda self: self._list_full("nodes")  # noqa: E731

    def get_podcliqueset(self, name: str):
        return self._get("podcliquesets", name)

    def get_podgang(self, name: str):
        return self._get("podgangs", name)

    def get_pod(self, name: str):
        return self._get("pods", name)

    def get_node(self, name: str):
        return self._get("nodes", name)

    def push_metrics(self, metrics: dict[str, float]) -> int:
        import math as _math

        update = {str(k): float(v) for k, v in metrics.items()}
        bad = [k for k, v in update.items() if not _math.isfinite(v)]
        if bad:
            # Same contract as the HTTP path's 400 on non-finite values.
            raise GroveApiError(400, [f"non-finite utilization for {bad}"])
        self.manager.hpa_metrics.update(update)
        return len(update)

    def apply_podcliqueset(self, doc_or_yaml: dict | str) -> str:
        import yaml as _yaml

        from grove_tpu_torch.api.admission import AdmissionError
        from grove_tpu_torch.api.types import PodCliqueSet

        doc = (
            _yaml.safe_load(doc_or_yaml)
            if isinstance(doc_or_yaml, str)
            else doc_or_yaml
        )
        try:
            pcs = self.manager.apply_podcliqueset(
                PodCliqueSet.from_dict(doc), actor=self.actor
            )
        except AdmissionError as e:
            raise GroveApiError(422, [str(x) for x in e.errors]) from e
        return pcs.metadata.name

    def delete_podcliqueset(self, name: str) -> None:
        if name not in self.manager.cluster.podcliquesets:
            raise GroveApiError(404, ["not found"])
        self.manager.delete_podcliqueset(name, actor=self.actor)

    def statusz(self) -> dict:
        return self.manager.statusz()

    def scale(self, target: str, replicas: int) -> int:
        if not isinstance(replicas, int) or isinstance(replicas, bool):
            raise GroveApiError(400, ["replicas must be an integer"])
        try:
            return self.manager.scale_target(target, replicas, actor=self.actor)
        except KeyError:
            raise GroveApiError(404, [f"unknown scale target {target!r}"]) from None
        except ValueError as e:
            raise GroveApiError(400, [str(e)]) from None

    def events(self) -> list[tuple[float, str, str]]:
        return self.manager.cluster.recent_events(200)
