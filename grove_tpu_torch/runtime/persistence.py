"""Control-plane persistence: snapshot/restore the whole store.

The reference survives operator restarts because every piece of control-plane
state lives in CR status in etcd — generation hashes and per-level
RollingUpdateProgress (`operator/api/core/v1alpha1/podcliqueset.go:96-118`,
`podclique.go:140-164`, `scalinggroup.go:106-129`), bindings as pod specs,
breach timestamps as conditions. This stack's store is in-memory, so the
manager snapshots it to disk (typed JSON via grove_tpu_torch/utils/serde) and
restores on boot: a controller killed mid-rolling-update resumes exactly
where it stopped, one replica at a time.
"""

from __future__ import annotations

import json
from typing import Optional

from grove_tpu_torch.api import pod as pod_mod
from grove_tpu_torch.api import podgang as podgang_mod
from grove_tpu_torch.api import resources as resources_mod
from grove_tpu_torch.api import types as types_mod
from grove_tpu_torch.orchestrator.store import Cluster
from grove_tpu_torch.state import cluster as state_mod
from grove_tpu_torch.utils import serde
from grove_tpu_torch.utils.fsio import atomic_write_json

# v2: headless_services (derived set) replaced by typed aux-resource
# collections (services/hpas/service_accounts/roles/role_bindings/secrets).
SCHEMA_VERSION = 2

for _m in (types_mod, pod_mod, podgang_mod, state_mod, resources_mod):
    serde.register_module(_m)

# The store fields that constitute durable control-plane state. `events` is
# excluded deliberately: it is an unbounded diagnostic ring, not state the
# reconcile loop reads.
_STATE_FIELDS = (
    "nodes",
    "podcliquesets",
    "podcliques",
    "scaling_groups",
    "podgangs",
    "pods",
    "services",
    "hpas",
    "service_accounts",
    "roles",
    "role_bindings",
    "secrets",  # token material IS control-plane state (long-lived SA tokens)
    "scale_overrides",
)


def dump_cluster(cluster: Cluster) -> dict:
    return {
        "schema": SCHEMA_VERSION,
        **{f: serde.encode(getattr(cluster, f)) for f in _STATE_FIELDS},
    }


def load_cluster(doc: dict, into: Optional[Cluster] = None) -> Cluster:
    schema = doc.get("schema")
    if schema not in (1, SCHEMA_VERSION):
        raise ValueError(f"state schema {schema} not in (1, {SCHEMA_VERSION})")
    cluster = into if into is not None else Cluster()
    for f in _STATE_FIELDS:
        value = serde.decode(doc.get(f) or type(getattr(cluster, f))())
        if f == "pods":
            from grove_tpu_torch.orchestrator.store import _PodDict

            value = _PodDict(value)  # restore the clique/gang indexes
        setattr(cluster, f, value)
    # v1 migration: aux-resource collections did not exist (loaded empty
    # above); the next sync_workload re-materializes them — including FRESH
    # SA tokens, so in-flight agents holding old credentials re-auth via
    # their next mount read, not via this restore.
    return cluster


class StatePersistence:
    """Atomic snapshot/restore of a Cluster at a filesystem path."""

    def __init__(self, path: str, snapshot_interval_seconds: float = 10.0):
        self.path = path
        self.snapshot_interval_seconds = snapshot_interval_seconds
        self._last_snapshot: float = float("-inf")

    def snapshot(self, cluster: Cluster) -> None:
        atomic_write_json(self.path, dump_cluster(cluster))

    def maybe_snapshot(self, cluster: Cluster, now: float) -> bool:
        if now - self._last_snapshot < self.snapshot_interval_seconds:
            return False
        self.snapshot(cluster)
        self._last_snapshot = now
        return True

    def restore(self, into: Cluster) -> bool:
        """Load state into the store; False when no snapshot exists yet."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return False
        load_cluster(doc, into=into)
        return True
