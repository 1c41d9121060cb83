"""grove-initc: the startup-ordering agent.

Executable analog of the reference's `grove-initc` binary
(`operator/initc/cmd/main.go`, `operator/initc/internal/wait.go:111-275`):
injected as an init container into pods of cliques with startup parents, it
blocks the user containers until every parent PodClique has at least
minAvailable Ready pods, then exits 0.

Arg format matches the reference injection
(`podclique/components/pod/initcontainer.go:142-158`):

    python -m grove_tpu_torch.initc --podcliques=<fqn>:<minAvailable>[,<fqn>:<min>...] \
        --server http://127.0.0.1:2751 [--poll-interval 1.0] [--timeout 900]

Where the reference informer-watches gang pods through the apiserver with the
pod's projected ServiceAccount token, this agent polls the manager's HTTP API
(`/api/v1/podcliques/<fqn>`) — the apiserver analog in this stack. The wait
loop itself is a pure function over a `fetch` callable so the simulator
drives the exact same code against the in-process store.
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Iterable, Optional


@dataclass(frozen=True)
class Requirement:
    """One parent gate: clique FQN must have >= min_available Ready pods."""

    fqn: str
    min_available: int


def parse_podcliques_arg(value: str) -> list[Requirement]:
    """`a-0-prefill:2,a-0-router:1` -> [Requirement(...), ...] (options.go)."""
    reqs: list[Requirement] = []
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"--podcliques entry {part!r}: want <fqn>:<minAvailable>")
        fqn, _, min_s = part.rpartition(":")
        try:
            min_avail = int(min_s)
        except ValueError:
            raise ValueError(f"--podcliques entry {part!r}: minAvailable not an int")
        if not fqn or min_avail < 0:
            raise ValueError(f"--podcliques entry {part!r}: invalid")
        reqs.append(Requirement(fqn=fqn, min_available=min_avail))
    return reqs


# fetch: fqn -> (ready_count, exists). Missing cliques gate (wait.go treats a
# not-yet-created parent as not ready).
FetchFn = Callable[[str], tuple[int, bool]]


def requirements_met(fetch: FetchFn, reqs: Iterable[Requirement]) -> bool:
    for req in reqs:
        ready, exists = fetch(req.fqn)
        if not exists or ready < req.min_available:
            return False
    return True


def wait_until_ready(
    fetch: FetchFn,
    reqs: list[Requirement],
    *,
    timeout_s: float = 900.0,
    poll_interval_s: float = 1.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    on_poll: Optional[Callable[[int], None]] = None,
) -> bool:
    """Block until all requirements are met; False on timeout (exit 1)."""
    deadline = clock() + timeout_s
    polls = 0
    while True:
        if requirements_met(fetch, reqs):
            return True
        polls += 1
        if on_poll is not None:
            on_poll(polls)
        if clock() >= deadline:
            return False
        sleep(poll_interval_s)


def http_fetch(
    server: str,
    timeout_s: float = 5.0,
    token: str | None = None,
    cafile: str | None = None,
) -> FetchFn:
    """Poll the manager's HTTP(S) API (the apiserver analog). `token` is the
    per-PCS SA token (api/resources.TokenSecret) sent as a bearer credential
    — required when the manager runs with the authorizer enabled. `cafile`
    pins the manager's serving cert for https servers (tls auto mode's
    self-signed cert doubles as the CA bundle)."""
    ssl_ctx = None
    if cafile is not None:
        from grove_tpu_torch.runtime.certs import pinned_client_context

        ssl_ctx = pinned_client_context(cafile)

    def fetch(fqn: str) -> tuple[int, bool]:
        url = f"{server.rstrip('/')}/api/v1/podcliques/{fqn}"
        req = urllib.request.Request(url)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s, context=ssl_ctx) as resp:
                doc = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code in (401, 403):
                # A rejected credential never fixes itself by polling — fail
                # fast with a diagnosis instead of gating until timeout.
                raise PermissionError(
                    f"manager rejected the SA token ({e.code}) for {fqn}"
                ) from e
            # 404 = clique not created yet; 5xx = manager restarting. Either
            # way: keep gating, keep retrying — never crash the init phase.
            return 0, False
        except (OSError, TimeoutError, ValueError):
            # URLError/ConnectionReset/RemoteDisconnected/short-read JSON —
            # the manager being briefly unreachable means: keep gating, keep
            # retrying. An init container must never crash on a blip.
            return 0, False
        return int(doc.get("ready", 0)), True

    return fetch


def kube_fetch(
    server: str,
    namespace: str,
    token: str | None = None,
    cafile: str | None = None,
    timeout_s: float = 5.0,
    rbac_grace_s: float = 60.0,
) -> FetchFn:
    """Count Ready gang pods straight from the kube-apiserver — the
    reference agent's own path (`initc/internal/wait.go:111-164` informer;
    polled LIST here): pods selected by the `grove.io/podclique` label,
    ready = condition Ready=True and not terminating. Unlike http_fetch this
    needs no operator URL at all — the only dependency is the apiserver the
    pod already lives on, authenticated by the mounted per-PCS SA token
    (satokensecret component)."""
    import urllib.parse

    ssl_ctx = None
    if cafile is not None:
        import ssl

        # The cluster CA verifies the apiserver's own DNS SANs — full
        # hostname verification, unlike the operator-cert pin.
        ssl_ctx = ssl.create_default_context(cafile=cafile)
    # 401/403 right after pod start is EXPECTED here: the operator mirrors
    # the RoleBinding in the same push that creates the pod, and the
    # apiserver's RBAC cache can lag by seconds. Unlike the operator-API
    # path (where a rejected credential never heals), keep gating through a
    # grace window and only fail fast when the rejection persists.
    denied_since: list[float] = []

    def fetch(fqn: str) -> tuple[int, bool]:
        selector = urllib.parse.quote(f"grove.io/podclique={fqn}")
        url = (
            f"{server.rstrip('/')}/api/v1/namespaces/"
            f"{urllib.parse.quote(namespace)}/pods?labelSelector={selector}"
        )
        req = urllib.request.Request(url)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s, context=ssl_ctx) as resp:
                doc = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code in (401, 403):
                now = time.monotonic()
                if not denied_since:
                    denied_since.append(now)
                if now - denied_since[0] >= rbac_grace_s:
                    raise PermissionError(
                        f"apiserver rejected the SA token ({e.code}) listing "
                        f"pods of {fqn} for {rbac_grace_s:.0f}s (RBAC grace "
                        "exhausted)"
                    ) from e
            return 0, False
        except (OSError, TimeoutError, ValueError):
            return 0, False
        denied_since.clear()
        ready = 0
        for pod in doc.get("items", []) or []:
            if (pod.get("metadata", {}) or {}).get("deletionTimestamp"):
                continue
            conds = (pod.get("status", {}) or {}).get("conditions", []) or []
            if any(c.get("type") == "Ready" and c.get("status") == "True" for c in conds):
                ready += 1
        # A clique with no pods yet lists as empty — that still gates
        # (ready=0), matching the informer counting zero Ready pods.
        return ready, True

    return fetch


# In-cluster defaults (the downward/projected mounts every pod carries).
IN_CLUSTER_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_server() -> str | None:
    """https URL of the apiserver from the standard in-cluster env."""
    import os

    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    if not host:
        return None
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # bare IPv6 literal must be bracketed in a URL
    return f"https://{host}:{port}"


def store_fetch(cluster) -> FetchFn:
    """In-process fetch over the store — the simulator's agent path uses the
    same wait/requirements code as the binary."""

    def fetch(fqn: str) -> tuple[int, bool]:
        clique = cluster.podcliques.get(fqn)
        if clique is None:
            return 0, False
        ready = sum(1 for p in cluster.pods_of_clique(fqn) if p.ready and p.is_active)
        return ready, True

    return fetch
