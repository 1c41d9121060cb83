"""Real-cluster WatchSource: the kube-apiserver list/watch protocol
(grove_tpu/cluster/kubernetes.py counterpart).

The reference's controllers see the world exclusively through apiserver
watch streams (informers — `operator/internal/controller/manager.go:53-121`;
the in-pod agent watches the same way, `operator/initc/internal/wait.go:
111-164`). This module is that integration path for the TPU stack, speaking
the wire protocol directly with no client dependency:

  list:   GET  {server}/api/v1/nodes                      -> NodeList + resourceVersion
  watch:  GET  {server}/api/v1/nodes?watch=1&resourceVersion=RV
          newline-delimited JSON {"type": ADDED|MODIFIED|DELETED|BOOKMARK,
          "object": {...}} until the server closes the stream; a 410 Gone
          (resourceVersion too old) forces a relist.
  bind:   POST {server}/api/v1/namespaces/{ns}/pods/{name}/binding
          — the kube-scheduler bind subresource; this is how solver
          assignments become real placements.
  create: POST {server}/api/v1/namespaces/{ns}/pods (pod materialization;
          the reference's pod component creates these objects the same way,
          `podclique/components/pod/pod.go:68`).

Reader threads pump each resource's list+watch loop into one queue;
``poll(now)`` (the WatchSource contract, cluster/watch.py) drains it on the
manager's reconcile cadence, so the driver's stale-view discipline applies
to real clusters exactly as it does to the KWOK fake.

Auth: kubeconfig (token / client cert / CA, base64 ``*-data`` variants
included) or the in-cluster service-account mount. No client library —
stdlib http.client + ssl for the wire (yaml only for kubeconfig parsing),
same dependency policy as the rest of the runtime.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import queue
import ssl
import tempfile
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Optional

from grove_tpu_torch.api import constants as api_constants
from grove_tpu_torch.api.quantity import parse_quantity
from grove_tpu_torch.cluster.watch import EventType, WatchEvent, WatchRetryPolicy
from grove_tpu_torch import faults as faults_mod
from grove_tpu_torch.utils.backoff import Backoff

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# The watch must select exactly the pods expansion stamps (expansion.py uses
# these constants) — a literal here would silently diverge from the label.
DEFAULT_POD_LABEL_SELECTOR = (
    f"{api_constants.LABEL_MANAGED_BY}={api_constants.LABEL_MANAGED_BY_VALUE}"
)


class KubeApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"apiserver returned {status}: {message}")
        self.status = status


@dataclass
class KubeContext:
    """Connection material for one cluster, resolved from kubeconfig or the
    in-cluster service-account mount."""

    server: str  # e.g. https://10.0.0.1:6443
    token: Optional[str] = None
    ca_pem: Optional[str] = None  # PEM bundle (verify server)
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    insecure_skip_verify: bool = False
    namespace: str = "default"

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        if self.insecure_skip_verify:
            ctx = ssl._create_unverified_context()  # explicit kubeconfig opt-in
        else:
            ctx = ssl.create_default_context()
            if self.ca_pem:
                ctx.load_verify_locations(cadata=self.ca_pem)
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx


def _b64_to_tempfile(data_b64: str, suffix: str) -> str:
    """Client cert/key *-data entries must become files for load_cert_chain;
    0600 tempfiles owned by this process, unlinked at interpreter exit so
    key material never outlives the run."""
    import atexit

    f = tempfile.NamedTemporaryFile(
        mode="wb", suffix=suffix, delete=False, prefix="grove-kubeconfig-"
    )
    os.chmod(f.name, 0o600)
    f.write(base64.b64decode(data_b64))
    f.close()

    def _cleanup(path=f.name):
        try:
            os.unlink(path)
        except OSError:
            pass

    atexit.register(_cleanup)
    return f.name


def load_kube_context(
    kubeconfig_path: Optional[str] = None,
    context_name: Optional[str] = None,
    namespace: Optional[str] = None,
) -> KubeContext:
    """Resolve connection material: explicit kubeconfig path, else
    $KUBECONFIG (colon-separated list: the first file DEFINING the
    requested/current context wins — per-file resolution, not kubectl's
    full cross-file merge), else ~/.kube/config, else the in-cluster
    mount."""
    candidates: list[str]
    if kubeconfig_path:
        candidates = [kubeconfig_path]
    elif os.environ.get("KUBECONFIG"):
        candidates = [
            p for p in os.environ["KUBECONFIG"].split(os.pathsep) if p
        ]
    else:
        candidates = [os.path.expanduser("~/.kube/config")]
    errors: list[str] = []
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            return _context_from_kubeconfig(path, context_name, namespace)
        except ValueError as e:
            # Context not in THIS file — a later $KUBECONFIG entry may
            # define it (kubectl finds it via merging; we find it by file).
            errors.append(str(e))
    if os.path.exists(os.path.join(_SA_DIR, "token")):
        return _in_cluster_context(namespace)
    if errors:  # files existed but none defined the context
        raise ValueError("; ".join(errors))
    raise FileNotFoundError(
        f"no kubeconfig at {':'.join(candidates)} and no in-cluster "
        "service account mount"
    )


def _context_from_kubeconfig(
    path: str, context_name: Optional[str], namespace: Optional[str]
) -> KubeContext:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    by_name = lambda items: {i["name"]: i for i in items or []}  # noqa: E731
    contexts = by_name(doc.get("contexts"))
    clusters = by_name(doc.get("clusters"))
    users = by_name(doc.get("users"))
    name = context_name or doc.get("current-context")
    if not name or name not in contexts:
        raise ValueError(f"{path}: context {name!r} not found")
    ctx = contexts[name]["context"]
    cluster = clusters[ctx["cluster"]]["cluster"]
    user = users.get(ctx.get("user", ""), {}).get("user", {})

    ca_pem = None
    if cluster.get("certificate-authority-data"):
        ca_pem = base64.b64decode(cluster["certificate-authority-data"]).decode()
    elif cluster.get("certificate-authority"):
        with open(cluster["certificate-authority"]) as f:
            ca_pem = f.read()

    cert_file = user.get("client-certificate")
    key_file = user.get("client-key")
    if user.get("client-certificate-data"):
        cert_file = _b64_to_tempfile(user["client-certificate-data"], ".crt")
    if user.get("client-key-data"):
        key_file = _b64_to_tempfile(user["client-key-data"], ".key")

    return KubeContext(
        server=cluster["server"].rstrip("/"),
        token=user.get("token"),
        ca_pem=ca_pem,
        client_cert_file=cert_file,
        client_key_file=key_file,
        insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
        namespace=namespace or ctx.get("namespace", "default"),
    )


def _in_cluster_context(namespace: Optional[str]) -> KubeContext:
    with open(os.path.join(_SA_DIR, "token")) as f:
        token = f.read().strip()
    ca_path = os.path.join(_SA_DIR, "ca.crt")
    ca_pem = None
    if os.path.exists(ca_path):
        with open(ca_path) as f:
            ca_pem = f.read()
    ns = namespace
    ns_path = os.path.join(_SA_DIR, "namespace")
    if ns is None and os.path.exists(ns_path):
        with open(ns_path) as f:
            ns = f.read().strip()
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    return KubeContext(
        server=f"https://{host}:{port}",
        token=token,
        ca_pem=ca_pem,
        namespace=ns or "default",
    )


# ---------------------------------------------------------------------------------
# Client-side rate limiting (ClientConnectionConfiguration{QPS, Burst} analog)
# ---------------------------------------------------------------------------------


class TokenBucket:
    """QPS/Burst token bucket — the client-go flowcontrol rate limiter the
    reference's ClientConnectionConfiguration{QPS, Burst} configures.

    `burst` tokens of headroom refill at `qps` tokens/s; `acquire()` takes
    one token, sleeping out any deficit first (callers go at most `burst`
    over the sustained rate before throttling kicks in). qps <= 0 disables
    the limiter entirely. Thread-safe: the watch source's reader threads and
    the reconcile thread's binding calls share one bucket, which is the
    point — TOTAL apiserver pressure is what the server-side priority &
    fairness layer penalizes.
    """

    def __init__(
        self,
        qps: float,
        burst: int,
        time_fn=time.monotonic,
        sleep_fn=time.sleep,
    ):
        self.qps = float(qps)
        self.capacity = max(1, int(burst))
        self._tokens = float(self.capacity)
        self._time = time_fn
        self._sleep = sleep_fn
        self._last = time_fn()
        self._lock = threading.Lock()
        # Observability (the throttle counter metric's source of truth).
        self.throttled = 0  # acquisitions that had to wait
        self.wait_seconds = 0.0  # cumulative time spent waiting

    def acquire(self) -> float:
        """Take one token; returns the seconds waited (0.0 = no throttle)."""
        if self.qps <= 0:
            return 0.0
        with self._lock:
            now = self._time()
            self._tokens = min(
                self.capacity, self._tokens + (now - self._last) * self.qps
            )
            self._last = now
            self._tokens -= 1.0
            # Deficit tokens model queued requests: each waiter sleeps until
            # its token would have refilled, so concurrent callers space out
            # at the sustained rate instead of thundering on each refill.
            wait = max(0.0, -self._tokens / self.qps)
            if wait > 0:
                self.throttled += 1
                self.wait_seconds += wait
        if wait > 0:
            self._sleep(wait)
        return wait


# ---------------------------------------------------------------------------------
# Shared transport helpers
# ---------------------------------------------------------------------------------


def _open_connection(ctx: KubeContext, timeout: float) -> http.client.HTTPConnection:
    u = urllib.parse.urlsplit(ctx.server)
    if u.scheme == "https":
        return http.client.HTTPSConnection(
            u.hostname, u.port or 443, timeout=timeout, context=ctx.ssl_context()
        )
    return http.client.HTTPConnection(u.hostname, u.port or 80, timeout=timeout)


def _auth_headers(ctx: KubeContext) -> dict:
    h = {"Accept": "application/json"}
    if ctx.token:
        h["Authorization"] = f"Bearer {ctx.token}"
    return h


# ---------------------------------------------------------------------------------
# Object translation: k8s wire objects -> WatchEvent payloads
# ---------------------------------------------------------------------------------


def node_payload(obj: dict) -> dict:
    """corev1.Node -> the driver's node dict. Allocatable over capacity (what
    the scheduler may actually use); quantity strings -> base-unit floats."""
    status = obj.get("status", {}) or {}
    spec = obj.get("spec", {}) or {}
    raw = status.get("allocatable") or status.get("capacity") or {}
    return {
        "capacity": {k: parse_quantity(v) for k, v in raw.items()},
        "labels": dict((obj.get("metadata", {}) or {}).get("labels", {}) or {}),
        "schedulable": not spec.get("unschedulable", False),
        "taints": [dict(t) for t in spec.get("taints", []) or []],
    }


def pod_payload(obj: dict) -> dict:
    """corev1.Pod -> the driver's pod dict: phase, readiness (the Ready
    condition — same definition the initc agent counts,
    `initc/internal/wait.go:240-275`), and the bound node."""
    status = obj.get("status", {}) or {}
    ready = any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in status.get("conditions", []) or []
    )
    out: dict = {"ready": ready}
    if status.get("phase"):
        out["phase"] = status["phase"]
    node = (obj.get("spec", {}) or {}).get("nodeName")
    if node:
        out["node"] = node
    return out


# ---------------------------------------------------------------------------------
# The watch source
# ---------------------------------------------------------------------------------


@dataclass
class _ResourceWatch:
    kind: str  # "Node" | "Pod" | "PodCliqueSet"
    list_path: str  # e.g. /api/v1/nodes
    selector: str = ""  # labelSelector value, if any
    # 404 on the LIST means the resource type itself is absent (the grove.io
    # CRD not installed): back off this long instead of hot-looping, and log
    # the condition once, not per retry.
    missing_backoff_s: float = 1.0
    _missing_logged: bool = False
    # Disconnect handling: capped decorrelated-jitter resubscribe pacing +
    # resync accounting (cluster/watch.py WatchRetryPolicy). Replaces the
    # old fixed 1s sleep — a flapping apiserver sees spread-out reconnects,
    # and every reconnect/forced-resync is COUNTED (grove_watch_* metrics).
    retry: WatchRetryPolicy = field(default_factory=WatchRetryPolicy)


class KubernetesWatchSource:
    """WatchSource (cluster/watch.py protocol) backed by a live apiserver.

    Inbound: reader threads run list+watch per resource, translating wire
    objects into WatchEvents on a shared queue; `poll` drains it. Outbound:
    `observe_binding` materializes the pod object (if needed) and POSTs the
    binding subresource; `observe_deletion` deletes the pod.
    """

    def __init__(
        self,
        ctx: KubeContext,
        pod_label_selector: Optional[str] = None,  # None = the managed-by label
        pod_manifest_for: Optional[Callable[[str], Optional[dict]]] = None,
        request_timeout_s: float = 10.0,
        watch_read_timeout_s: float = 30.0,
        watch_workloads: bool = True,
        initc_kube_tokens: bool = False,
        qps: float = 50.0,  # ClientConnectionConfiguration.QPS (0 = unlimited)
        burst: int = 100,  # ClientConnectionConfiguration.Burst
        bind_retry_attempts: int = 1,  # in-call bind retries (resilience.*)
        transport_retries: int = 1,  # per-request reconnect attempts
        backoff_base_s: float = 0.05,  # shared decorrelated-jitter pacing
        backoff_cap_s: float = 2.0,
    ):
        if pod_label_selector is None:
            pod_label_selector = DEFAULT_POD_LABEL_SELECTOR
        self.ctx = ctx
        # One bucket for every request this source issues (unary calls AND
        # watch-stream initiations): total apiserver pressure is the thing
        # being limited.
        self.limiter = TokenBucket(qps, burst)
        self.pod_manifest_for = pod_manifest_for
        self._local = threading.local()  # per-thread persistent connection
        self._queue: "queue.Queue[WatchEvent]" = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._request_timeout_s = request_timeout_s
        self._watch_read_timeout_s = watch_read_timeout_s
        ns = urllib.parse.quote(ctx.namespace)
        self._pods_path = f"/api/v1/namespaces/{ns}/pods"
        # The user workload API over the SAME apiserver: PodCliqueSet CRs
        # arrive by watch exactly as the reference's controllers see them
        # (kubectl apply -> etcd -> watch, SURVEY §3.2-3.3); reconciled
        # status is written back to the CR's status subresource.
        self._pcs_path = (
            f"/apis/grove.io/v1alpha1/namespaces/{ns}/podcliquesets"
        )
        self._watches = [
            _ResourceWatch("Node", "/api/v1/nodes"),
            _ResourceWatch("Pod", self._pods_path, selector=pod_label_selector),
        ]
        if watch_workloads:
            self._watches.append(
                _ResourceWatch(
                    "PodCliqueSet", self._pcs_path, missing_backoff_s=30.0
                )
            )
            # Child CR projections are operator-owned, but their SCALE
            # subresource is a public surface (reference: HPA ScaleTargetRef
            # -> PCLQ/PCSG scale, components/hpa/hpa.go:249-259; kubectl
            # scale pclq). Watching them turns external spec.replicas writes
            # into scale events; echoes of our own projection PUTs compare
            # equal at the driver and cost nothing.
            for kind, plural in (
                ("PodClique", "podcliques"),
                ("PodCliqueScalingGroup", "podcliquescalinggroups"),
            ):
                self._watches.append(
                    _ResourceWatch(
                        kind,
                        f"/apis/grove.io/v1alpha1/namespaces/{ns}/{plural}",
                        missing_backoff_s=30.0,
                    )
                )
        # Bind retry (resilience.bindMaxAttempts): attempts per observe_
        # binding call, decorrelated-jitter paced; 1 = one shot, the
        # WatchDriver's cross-tick retry set is the outer loop either way.
        self.bind_retry_attempts = max(1, int(bind_retry_attempts))
        self.transport_retries = max(0, int(transport_retries))
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_cap_s = float(backoff_cap_s)
        # Monotonic fault-recovery counters (manager -> grove_bind_retries_
        # total; watch reconnect/resync counters live per _ResourceWatch).
        self.bind_retries = 0
        # Wire-visible error log (last few), surfaced via statusz/tests.
        self.errors: list[str] = []
        # Managed Services mirrored to the cluster: name -> last manifest.
        self._synced_services: dict[str, dict] = {}
        # Child CR projections (podcliques/pcsgs): plural -> name -> manifest.
        self._synced_children: dict[str, dict] = {}
        # SA-token Secrets mirrored (pods mount them): name -> manifest.
        self._synced_secrets: dict[str, dict] = {}
        # cluster.initcMode kubernetes: token Secrets become REAL
        # service-account-token Secrets (the control plane mints the token)
        # and the per-PCS SA/Role/RoleBinding are mirrored too.
        self.initc_kube_tokens = initc_kube_tokens
        self._synced_rbac: dict[str, dict[str, dict]] = {
            "serviceaccounts": {},
            "roles": {},
            "rolebindings": {},
        }
        # Collections whose cluster-side members have been LISTed into the
        # cache (crash-orphan GC; _sync_collection).
        self._seeded_bases: set[str] = set()
        # Per-collection sync counter driving the periodic resync relist.
        self._resync_counts: dict[str, int] = {}

    # ---- lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        for rw in self._watches:
            t = threading.Thread(
                target=self._run_watch, args=(rw,), daemon=True,
                name=f"kube-watch-{rw.kind.lower()}",
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    # ---- WatchSource protocol -------------------------------------------------------

    def poll(self, now: float) -> list[WatchEvent]:
        events: list[WatchEvent] = []
        while True:
            try:
                events.append(self._queue.get_nowait())
            except queue.Empty:
                return events

    def observe_binding(self, pod_name: str, node_name: str, now: float) -> bool:
        """Materialize + bind: ensure the Pod object exists (409 = already
        there), then POST the binding subresource — the scheduler-side bind
        call that turns a solver assignment into a kubelet start.

        Retry discipline (resilience.bindMaxAttempts): the whole
        create+bind sequence retries in-call with decorrelated-jitter
        pacing — both halves are idempotent (409 on create = already there,
        409 on bind = already bound), so a retry after an ambiguous
        transport failure converges instead of double-binding. Exhaustion
        returns False so the WatchDriver keeps the pod in its cross-tick
        retry set (a transient 500 must not orphan the placement)."""
        backoff = Backoff(self._backoff_base_s, self._backoff_cap_s)
        attempt = 0
        while True:
            ok = self._observe_binding_once(pod_name, node_name)
            if ok:
                return True
            attempt += 1
            if attempt >= self.bind_retry_attempts:
                return False
            self.bind_retries += 1
            backoff.sleep()

    def _observe_binding_once(self, pod_name: str, node_name: str) -> bool:
        manifest = (
            self.pod_manifest_for(pod_name) if self.pod_manifest_for else None
        )
        if manifest is not None:
            # Single-namespace operation (the store is single-namespace too,
            # orchestrator/store.py): the create must target the namespace
            # the watch covers or its events would never flow back.
            manifest.setdefault("metadata", {})["namespace"] = self.ctx.namespace
            try:
                self._request("POST", self._pods_path, manifest)
            except (KubeApiError, OSError, ValueError) as e:
                if not (isinstance(e, KubeApiError) and e.status == 409):
                    self._record_error(f"create pod {pod_name}: {e}")
                    return False  # AlreadyExists is the steady state; rest retry
        binding = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": pod_name, "namespace": self.ctx.namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node_name},
        }
        try:
            self._request("POST", f"{self._pods_path}/{pod_name}/binding", binding)
        except (KubeApiError, OSError, ValueError) as e:
            if isinstance(e, KubeApiError) and e.status == 409:
                return True  # already bound = this push already landed
            self._record_error(f"bind pod {pod_name} -> {node_name}: {e}")
            return False
        return True

    def watch_stats(self) -> dict:
        """Fault-recovery view of the informer loops (manager /statusz
        resilience.watch + grove_watch_* metrics)."""
        return {
            "reconnects": sum(rw.retry.reconnects for rw in self._watches),
            "resyncs": sum(rw.retry.resyncs for rw in self._watches),
            "bindRetries": self.bind_retries,
        }

    def sync_services(self, services: list) -> bool:
        """Mirror the store's HeadlessService objects into real cluster
        Services (service.go:137-155): pod DNS (`<hostname>.<subdomain>`)
        only resolves when the headless Service actually exists at the
        apiserver. Create-or-update for desired, delete for stale managed
        ones; returns False when any write failed (retried next push)."""
        ns = urllib.parse.quote(self.ctx.namespace)
        path = f"/api/v1/namespaces/{ns}/services"
        desired = {}
        for svc in services:
            desired[svc.name] = {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {
                    "name": svc.name,
                    "namespace": self.ctx.namespace,
                    "labels": {
                        api_constants.LABEL_MANAGED_BY: api_constants.LABEL_MANAGED_BY_VALUE,
                        api_constants.LABEL_PART_OF: svc.pcs_name,
                    },
                },
                "spec": {
                    "clusterIP": "None",
                    "selector": dict(svc.selector),
                    "publishNotReadyAddresses": bool(
                        svc.publish_not_ready_addresses
                    ),
                },
            }
        return self._sync_collection(path, desired, self._synced_services)

    def sync_secrets(self, secrets: list) -> bool:
        """Mirror the store's SA-token Secrets to the cluster — the rendered
        pods MOUNT them (initc token volume, satokensecret component
        analog); without this mirror every gated pod wedges in
        ContainerCreating on FailedMount."""
        ns = urllib.parse.quote(self.ctx.namespace)
        path = f"/api/v1/namespaces/{ns}/secrets"
        desired = {}
        for sec in secrets:
            meta = {
                "name": sec.name,
                "namespace": self.ctx.namespace,
                "labels": {
                    api_constants.LABEL_MANAGED_BY: api_constants.LABEL_MANAGED_BY_VALUE,
                    api_constants.LABEL_PART_OF: getattr(sec, "pcs_name", ""),
                },
            }
            if self.initc_kube_tokens:
                # initcMode kubernetes: the mounted token must be one the
                # APISERVER honors — a legacy service-account-token Secret,
                # whose `token` key the k8s control plane populates for the
                # bound SA (the reference's satokensecret component does
                # exactly this, components/satokensecret/).
                meta["annotations"] = {
                    "kubernetes.io/service-account.name": getattr(
                        sec, "service_account_name", ""
                    )
                }
                desired[sec.name] = {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "metadata": meta,
                    "type": "kubernetes.io/service-account-token",
                }
            else:
                desired[sec.name] = {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "metadata": meta,
                    "type": "Opaque",
                    "stringData": {"token": sec.token},
                }
        return self._sync_collection(
            path, desired, self._synced_secrets, recreate_on_invalid=True
        )

    def sync_rbac(self, service_accounts: list, roles: list, bindings: list) -> bool:
        """Mirror the per-PCS ServiceAccount/Role/RoleBinding so the
        service-account-token Secret resolves to a credential the apiserver
        accepts for listing gang pods (initcMode kubernetes; the reference's
        serviceaccount/role/rolebinding components). No-op unless
        initc_kube_tokens — operator-mode tokens never reach the apiserver."""
        if not self.initc_kube_tokens:
            return True
        ns_raw = self.ctx.namespace
        ns = urllib.parse.quote(ns_raw)

        def _meta(obj) -> dict:
            return {
                "name": obj.name,
                "namespace": ns_raw,
                "labels": {
                    api_constants.LABEL_MANAGED_BY: api_constants.LABEL_MANAGED_BY_VALUE,
                    api_constants.LABEL_PART_OF: getattr(obj, "pcs_name", ""),
                },
            }

        ok = self._sync_collection(
            f"/api/v1/namespaces/{ns}/serviceaccounts",
            {
                sa.name: {
                    "apiVersion": "v1",
                    "kind": "ServiceAccount",
                    "metadata": _meta(sa),
                }
                for sa in service_accounts
            },
            self._synced_rbac["serviceaccounts"],
        )
        rbac_base = f"/apis/rbac.authorization.k8s.io/v1/namespaces/{ns}"

        def _k8s_rules(role) -> list:
            # Store-level rules carry their apiGroup explicitly
            # (api/resources.Role) — no name-based guessing here.
            return [
                {
                    "apiGroups": [rule.get("apiGroup", "")],
                    "resources": list(rule.get("resources", [])),
                    "verbs": sorted(set(rule.get("verbs", [])) | {"watch"}),
                }
                for rule in role.rules
            ]

        ok = self._sync_collection(
            f"{rbac_base}/roles",
            {
                role.name: {
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "kind": "Role",
                    "metadata": _meta(role),
                    "rules": _k8s_rules(role),
                }
                for role in roles
            },
            self._synced_rbac["roles"],
        ) and ok
        ok = self._sync_collection(
            f"{rbac_base}/rolebindings",
            {
                rb.name: {
                    "apiVersion": "rbac.authorization.k8s.io/v1",
                    "kind": "RoleBinding",
                    "metadata": _meta(rb),
                    "roleRef": {
                        "apiGroup": "rbac.authorization.k8s.io",
                        "kind": "Role",
                        "name": rb.role_name,
                    },
                    "subjects": [
                        {
                            "kind": "ServiceAccount",
                            "name": rb.service_account_name,
                            "namespace": ns_raw,
                        }
                    ],
                }
                for rb in bindings
            },
            self._synced_rbac["rolebindings"],
        ) and ok
        return ok

    # ---- managed-object sync plumbing ----------------------------------------------

    _PREEXISTING = {"_preexisting": True}  # cache sentinel from seeding
    # Managed-collection syncs between resync relists (the informer-resync
    # analog healing out-of-band deletes of unchanged objects).
    RESYNC_SYNCS = 30

    def _seed_cache(self, base: str, cache: dict) -> bool:
        """First sync after (re)start: LIST the cluster's managed objects so
        ones surviving a crash participate in GC — an in-memory cache alone
        would orphan them forever (live DNS records, stale CRs)."""
        names = self._list_names(base, op="seed")
        if names is None:
            return False
        for name in names:
            cache.setdefault(name, dict(self._PREEXISTING))
        return True

    def _list_names(self, base: str, op: str = "resync") -> set | None:
        """Names of the collection's live managed objects, None on failure
        (a failed seed retries; a failed resync LIST must not evict)."""
        try:
            doc = self._request(
                "GET", base, query={"labelSelector": DEFAULT_POD_LABEL_SELECTOR}
            )
        except (KubeApiError, OSError, ValueError) as e:
            self._record_error(f"{op} {base}: {e}")
            return None
        return {
            item["metadata"]["name"] for item in doc.get("items", []) or []
        }

    def _upsert_object(
        self, base: str, name: str, manifest: dict, known: bool,
        status_subresource: bool = False,
        recreate_on_invalid: bool = False,
    ) -> bool:
        """Create-or-update with real apiserver semantics: updates are
        GET-then-PUT (resourceVersion threaded through), and when the CRD
        declares a status subresource the .status field — which the main
        PUT/POST STRIPS — is written with a second PUT to /status.

        `recreate_on_invalid`: a 422 on the update PUT means an immutable
        field changed (e.g. a Secret's `type` when cluster.initcMode flips)
        — delete + re-create instead of wedging on the same rejected PUT
        forever."""

        def _put_main() -> None:
            try:
                cur = self._request("GET", f"{base}/{name}")
            except KubeApiError as e:
                if e.status != 404:
                    raise
                # Known-to-us but gone from the cluster (out-of-band
                # kubectl delete): heal by re-creating instead of failing
                # the GET-then-PUT forever.
                self._request("POST", base, manifest)
                return
            body = dict(manifest)
            rv = (cur.get("metadata", {}) or {}).get("resourceVersion")
            if rv:
                body["metadata"] = {**manifest["metadata"], "resourceVersion": rv}
            try:
                self._request("PUT", f"{base}/{name}", body)
            except KubeApiError as e:
                if not (recreate_on_invalid and e.status == 422):
                    raise
                self._request("DELETE", f"{base}/{name}")
                self._request("POST", base, manifest)

        try:
            if known:
                _put_main()
            else:
                try:
                    self._request("POST", base, manifest)
                except KubeApiError as e:
                    if e.status != 409:
                        raise
                    _put_main()
            if status_subresource and "status" in manifest:
                cur = self._request("GET", f"{base}/{name}")
                cur["status"] = manifest["status"]
                self._request("PUT", f"{base}/{name}/status", cur)
        except (KubeApiError, OSError, ValueError) as e:
            self._record_error(f"sync {base}/{name}: {e}")
            return False
        return True

    def _sync_collection(
        self, base: str, desired: dict, cache: dict,
        status_subresource: bool = False,
        recreate_on_invalid: bool = False,
    ) -> bool:
        """Reconcile one managed collection: seed once, upsert changed,
        delete stale. `cache` maps name -> last-pushed manifest (or the
        seeding sentinel, which never equals a desired manifest)."""
        ok = True
        if base not in self._seeded_bases:
            if self._seed_cache(base, cache):
                self._seeded_bases.add(base)
            else:
                ok = False  # retry the seed next push; GC waits for it
        else:
            # Informer-resync analog: every RESYNC_SYNCS passes, re-LIST and
            # evict cache entries whose live object vanished (out-of-band
            # kubectl delete of an UNCHANGED object would otherwise be
            # skipped-as-synced forever; the upsert loop below re-creates
            # evicted names). Counted per collection, cheap: one LIST.
            self._resync_counts[base] = self._resync_counts.get(base, 0) + 1
            if self._resync_counts[base] >= self.RESYNC_SYNCS:
                live = self._list_names(base)
                if live is not None:
                    # Reset only on success: a failed relist retries next
                    # pass instead of waiting out another full interval.
                    self._resync_counts[base] = 0
                    for name in [n for n in cache if n not in live]:
                        del cache[name]
        for name, manifest in desired.items():
            if cache.get(name) == manifest:
                continue
            known = name in cache
            if self._upsert_object(
                base, name, manifest, known, status_subresource,
                recreate_on_invalid,
            ):
                cache[name] = manifest
            else:
                ok = False
        for name in [n for n in cache if n not in desired]:
            try:
                self._request("DELETE", f"{base}/{name}")
            except (KubeApiError, OSError, ValueError) as e:
                if not (isinstance(e, KubeApiError) and e.status == 404):
                    self._record_error(f"delete {base}/{name}: {e}")
                    ok = False
                    continue
            del cache[name]
        return ok

    def invalidate_child_projection(self, name: str) -> None:
        """Drop the sync cache entry for one child CR so the next push
        re-PUTs it even though the DESIRED manifest hasn't changed — the
        heal for an external write the operator rejected (the wire changed
        behind the cache's back; without this the CR would show the
        rejected value forever)."""
        for plural in ("podcliques", "podcliquescalinggroups"):
            self._synced_children.get(plural, {}).pop(name, None)

    def last_projected_replicas(self, name: str) -> Optional[int]:
        """spec.replicas of the child-CR manifest THIS process last pushed
        (None = never pushed / pre-existing from before a restart). The
        child-scale sink uses it to tell external writes from echoes and
        relist replays of our own projections — store state can't do that:
        a pending override makes the store disagree with what's actually on
        the wire."""
        for plural in ("podcliques", "podcliquescalinggroups"):
            manifest = self._synced_children.get(plural, {}).get(name)
            if isinstance(manifest, dict) and "spec" in manifest:
                reps = (manifest.get("spec") or {}).get("replicas")
                return reps if isinstance(reps, int) else None
        return None

    def sync_workload_children(self, podcliques: list, scaling_groups: list) -> bool:
        """Mirror the operator-owned PodClique / PodCliqueScalingGroup
        objects to the apiserver as CRs (the reference materializes these
        as CRs with status; here the store is authoritative and the CRs are
        a one-way kubectl-visible projection: `kubectl get pclq,pcsg`).
        Spec carries the scale-relevant fields; status is the full rollup."""
        from grove_tpu_torch.utils.serde import to_k8s

        ns = urllib.parse.quote(self.ctx.namespace)
        ok = True
        for plural, kind, objs, spec_of in (
            (
                "podcliques",
                "PodClique",
                podcliques,
                lambda o: {
                    "roleName": o.spec.role_name,
                    "replicas": o.spec.replicas,
                    "minAvailable": o.min_available,
                },
            ),
            (
                "podcliquescalinggroups",
                "PodCliqueScalingGroup",
                scaling_groups,
                lambda o: {
                    "replicas": o.spec.replicas,
                    "minAvailable": o.spec.min_available,
                    "cliqueNames": list(o.spec.clique_names),
                },
            ),
        ):
            base = f"/apis/grove.io/v1alpha1/namespaces/{ns}/{plural}"
            desired = {}
            for obj in objs:
                name = obj.metadata.name
                desired[name] = {
                    "apiVersion": "grove.io/v1alpha1",
                    "kind": kind,
                    "metadata": {
                        "name": name,
                        "namespace": self.ctx.namespace,
                        "labels": {
                            api_constants.LABEL_MANAGED_BY: api_constants.LABEL_MANAGED_BY_VALUE,
                            api_constants.LABEL_PART_OF: obj.pcs_name,
                        },
                    },
                    "spec": spec_of(obj),
                    "status": to_k8s(obj.status),
                }
            cache = self._synced_children.setdefault(plural, {})
            # status_subresource: the child CRDs declare one, so a real
            # apiserver STRIPS .status from the main POST/PUT — the rollup
            # must land through PUT .../status or kubectl shows none.
            ok = (
                self._sync_collection(
                    base, desired, cache, status_subresource=True
                )
                and ok
            )
        return ok

    def publish_events(self, events: list) -> int:
        """Mirror control-plane events ((ts, object, message) tuples) as
        corev1 Events — the reference records a k8s Event on every component
        action (`podgang/syncflow.go:451-458,547-554`); this is that
        visibility for `kubectl get events`. Returns how many landed (the
        caller advances its high-water mark by the return value, so a
        mid-batch failure retries only the tail)."""
        ns = urllib.parse.quote(self.ctx.namespace)
        path = f"/api/v1/namespaces/{ns}/events"
        landed = 0
        for ts, obj, msg in events:
            stamp = time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts if ts > 1e6 else time.time())
            )
            name = f"grove-{abs(hash((round(ts, 3), obj, msg))):x}"
            body = {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {"name": name, "namespace": self.ctx.namespace},
                "involvedObject": {
                    "namespace": self.ctx.namespace,
                    "name": obj,
                },
                "reason": "GroveReconcile",
                "message": msg,
                "type": "Normal",
                "firstTimestamp": stamp,
                "lastTimestamp": stamp,
                "count": 1,
                "source": {"component": "grove-tpu-operator"},
            }
            try:
                self._request("POST", path, body)
            except (KubeApiError, OSError, ValueError) as e:
                if isinstance(e, KubeApiError) and e.status == 409:
                    pass  # already mirrored (retry overlap): landed
                elif isinstance(e, KubeApiError) and 400 <= e.status < 500:
                    # Permanent rejection (e.g. stricter Event validation):
                    # SKIP it — a poison event must not head-of-line block
                    # every later event forever.
                    self._record_error(f"event publish (skipped): {e}")
                else:
                    self._record_error(f"event publish: {e}")
                    break  # transient: retry from here next push
            landed += 1
        return landed

    def sync_cluster_topology(self, topology) -> bool:
        """Create/update the cluster-scoped ClusterTopology CR from the
        operator config (the reference's startup sync,
        `internal/clustertopology/clustertopology.go:39-51`; CR name
        `grove-topology` per DefaultClusterTopologyName). Best-effort: a
        cluster without the CRD returns False and the operator runs on its
        in-memory topology."""
        path = "/apis/grove.io/v1alpha1/clustertopologies/grove-topology"
        levels = topology.levels_doc()
        body = {
            "apiVersion": "grove.io/v1alpha1",
            "kind": "ClusterTopology",
            "metadata": {"name": "grove-topology"},
            "spec": {"levels": levels},
        }
        try:
            try:
                cur = self._request("GET", path)
            except KubeApiError as e:
                if e.status != 404:
                    raise
                self._request(
                    "POST", "/apis/grove.io/v1alpha1/clustertopologies", body
                )
                return True
            cur["spec"] = body["spec"]
            self._request("PUT", path, cur)
            return True
        except (KubeApiError, OSError, ValueError) as e:
            self._record_error(f"ClusterTopology sync: {e}")
            return False

    def sync_webhook_ca(self, ca_pem: bytes, app: str = "grove-tpu-operator") -> bool:
        """Write the webhook serving cert into the Mutating/Validating
        WebhookConfigurations' clientConfig.caBundle — the cert-controller
        rotator's job in the reference (cert.go:66-93): deploy renders the
        configs with an empty bundle, the running operator completes them so
        the apiserver can verify the TLS it is told to call. Best-effort: a
        cluster without the configs (webhook disabled at deploy) returns
        False."""
        bundle = base64.b64encode(ca_pem).decode()
        ok = True
        for kind in ("mutatingwebhookconfigurations", "validatingwebhookconfigurations"):
            path = f"/apis/admissionregistration.k8s.io/v1/{kind}/{app}"
            try:
                cur = self._request("GET", path)
                changed = False
                for wh in cur.get("webhooks", []) or []:
                    cc = wh.setdefault("clientConfig", {})
                    if cc.get("caBundle") != bundle:
                        cc["caBundle"] = bundle
                        changed = True
                if changed:
                    self._request("PUT", path, cur)
            except (KubeApiError, OSError, ValueError) as e:
                self._record_error(f"webhook caBundle sync ({kind}): {e}")
                ok = False
        return ok

    def delete_workload(self, name: str) -> bool:
        """Delete the PodCliqueSet CR (an operator-API delete must also
        remove the CR, or the next relist re-emits ADDED and resurrects the
        workload). 404 = already gone = success."""
        try:
            self._request("DELETE", f"{self._pcs_path}/{name}")
        except (KubeApiError, OSError, ValueError) as e:
            if isinstance(e, KubeApiError) and e.status == 404:
                return True
            self._record_error(f"delete workload CR {name}: {e}")
            return False
        return True

    def publish_workload_status(self, name: str, status: dict):
        """Write reconciled status back to the PodCliqueSet CR's status
        subresource (the reference persists status the same way,
        reconcilestatus.go). GET-then-PUT with the live resourceVersion.

        Returns True on success, None when no such CR exists at the
        apiserver (a store-only workload applied via the operator's own
        HTTP API — nothing to write to; the caller must NOT retry until
        the status changes, or every tick pays a doomed GET), and False on
        transient failures (conflict/wire) that should retry next tick."""
        try:
            cur = self._request("GET", f"{self._pcs_path}/{name}")
            cur["status"] = status
            self._request("PUT", f"{self._pcs_path}/{name}/status", cur)
        except (KubeApiError, OSError, ValueError) as e:
            if isinstance(e, KubeApiError) and e.status == 404:
                return None
            if not (isinstance(e, KubeApiError) and e.status == 409):
                self._record_error(f"status write {name}: {e}")
            return False
        return True

    def list_node_capacities(self) -> Optional[list]:
        """One-shot node LIST for boot-time preflights (the accelerator
        preflight checks the slice resource is visible SOMEWHERE before the
        manager commits to auto-slice injection). Returns each node's
        capacity dict, or None when the apiserver is unreachable — a
        transient outage must not fail a boot the watch loop would heal."""
        try:
            doc = self._request("GET", "/api/v1/nodes")
        except (KubeApiError, OSError, ValueError) as e:
            self._record_error(f"node preflight list: {e}")
            return None
        return [
            node_payload(item).get("capacity", {})
            for item in (doc or {}).get("items", []) or []
        ]

    def observe_deletion(self, pod_name: str, now: float) -> bool:
        try:
            self._request("DELETE", f"{self._pods_path}/{pod_name}")
        except (KubeApiError, OSError, ValueError) as e:
            if isinstance(e, KubeApiError) and e.status == 404:
                return True  # already gone is success
            self._record_error(f"delete pod {pod_name}: {e}")
            return False  # retry next tick or the cluster pod runs forever
        return True

    # ---- list+watch loop ------------------------------------------------------------

    def _run_watch(self, rw: _ResourceWatch) -> None:
        """One resource's informer loop: list (seeding ADDED events), then
        stream the watch from the list's resourceVersion. A clean stream end
        (server timeout/close) RESUMES the watch from the last-seen
        resourceVersion — no relist, no error; only a wire error or a 410
        Gone forces the relist (the real informer contract)."""
        known: set[str] = set()
        while not self._stop.is_set():
            try:
                rv, names = self._list(rw, known)
                rw._missing_logged = False
                rw.retry.note_healthy()
                known = names
                while not self._stop.is_set():
                    rv = self._stream_watch(rw, rv, known)
            except (OSError, KubeApiError, json.JSONDecodeError) as e:
                if isinstance(e, KubeApiError) and e.status == 404:
                    # Resource type absent (CRD not installed): long
                    # backoff, one log line — not a hot loop that drowns
                    # real Node/Pod errors out of the 20-entry buffer.
                    if not rw._missing_logged:
                        rw._missing_logged = True
                        self._record_error(
                            f"{rw.kind} watch: resource absent at the "
                            f"apiserver (404); retrying every "
                            f"{rw.missing_backoff_s:.0f}s"
                        )
                    if self._stop.wait(rw.missing_backoff_s):
                        return
                    continue
                if isinstance(e, KubeApiError) and e.status == 410:
                    # resourceVersion expired while we were away: the
                    # relist above IS the full resync (ghost DELETEDs
                    # synthesized); count it — silent resyncs hide a
                    # chronically-lagging informer.
                    rw.retry.note_resync()
                self._record_error(f"{rw.kind} watch: {e}")
                # Capped decorrelated-jitter resubscribe (counted): fast
                # after one blip, spread out under a flapping apiserver.
                if self._stop.wait(rw.retry.next_delay()):
                    return

    def _list(self, rw: _ResourceWatch, known: set[str]) -> tuple[str, set[str]]:
        qs = {"labelSelector": rw.selector} if rw.selector else {}
        doc = self._request("GET", rw.list_path, query=qs)
        rv = (doc.get("metadata", {}) or {}).get("resourceVersion", "")
        seen: set[str] = set()
        for obj in doc.get("items", []) or []:
            name = obj["metadata"]["name"]
            seen.add(name)
            self._emit(EventType.ADDED, rw.kind, name, obj)
        # Objects that vanished between watch interruptions would otherwise
        # be ghosts forever: synthesize their DELETED on relist.
        for name in known - seen:
            self._emit(EventType.DELETED, rw.kind, name, {})
        return rv, seen

    def _stream_watch(self, rw: _ResourceWatch, rv: str, known: set[str]) -> str:
        """Stream one watch request; returns the last-seen resourceVersion
        so the caller can RESUME without relisting. The server is asked to
        close the stream (timeoutSeconds) just before our socket timeout
        would fire, so an idle-but-healthy cluster cycles cleanly instead of
        raising and relisting every read-timeout."""
        qs = {
            "watch": "1",
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(max(1, int(self._watch_read_timeout_s))),
        }
        if rv:
            qs["resourceVersion"] = rv
        if rw.selector:
            qs["labelSelector"] = rw.selector
        # Fault site: a dropped watch stream (network partition, apiserver
        # restart) surfaces as OSError here; the informer loop resubscribes
        # with capped backoff and resyncs on 410 — the path this site tests.
        faults_mod.active().maybe_raise(
            "watch.disconnect",
            resource=rw.kind,
            exc_factory=lambda s: KubeApiError(s, "injected watch fault"),
        )
        # Stream initiation counts against the bucket (long-lived reads do
        # not — the server's timeoutSeconds already paces re-establishment).
        self.limiter.acquire()
        conn = self._connect(timeout=self._watch_read_timeout_s + 5.0)
        try:
            conn.request(
                "GET",
                f"{rw.list_path}?{urllib.parse.urlencode(qs)}",
                headers=self._headers(),
            )
            resp = conn.getresponse()
            if resp.status == 410:
                raise KubeApiError(410, "resourceVersion too old; relisting")
            if resp.status != 200:
                raise KubeApiError(resp.status, resp.read(2048).decode("utf-8", "replace"))
            while not self._stop.is_set():
                try:
                    line = resp.readline()
                except TimeoutError:
                    return rv  # idle stream; resume from the same rv
                if not line:
                    return rv  # server closed cleanly; resume
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                etype, obj = ev.get("type"), ev.get("object", {}) or {}
                if isinstance(obj, dict):
                    new_rv = (obj.get("metadata", {}) or {}).get("resourceVersion")
                    if new_rv:
                        rv = new_rv
                if etype == "BOOKMARK":
                    continue
                if etype == "ERROR":
                    code = (obj.get("code") or 0) if isinstance(obj, dict) else 0
                    raise KubeApiError(int(code) or 500, "watch ERROR event")
                if etype not in ("ADDED", "MODIFIED", "DELETED"):
                    continue
                name = obj["metadata"]["name"]
                if etype == "DELETED":
                    known.discard(name)
                else:
                    known.add(name)
                self._emit(EventType(etype), rw.kind, name, obj)
            return rv
        finally:
            conn.close()

    def _emit(self, etype: EventType, kind: str, name: str, obj: dict) -> None:
        payload: dict = {}
        if etype != EventType.DELETED:
            if kind == "Node":
                payload = node_payload(obj)
            elif kind == "Pod":
                payload = pod_payload(obj)
            else:  # PodCliqueSet: the raw CR — the admission chain parses it
                payload = obj
        self._queue.put(WatchEvent(etype, kind, name, payload))

    # ---- HTTP plumbing --------------------------------------------------------------

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        return _open_connection(self.ctx, timeout)

    def _headers(self) -> dict:
        return _auth_headers(self.ctx)

    def _request(
        self, method: str, path: str, body: Optional[dict] = None,
        query: Optional[dict] = None,
    ):
        """One apiserver call over a thread-confined persistent connection
        (binding an N-pod gang is 2N calls per tick — a fresh TLS handshake
        each would tax both sides). Transport failures retry up to
        `transport_retries` times paced by decorrelated-jitter backoff
        (utils/backoff — the shared policy; the first retry is immediate-ish
        for the common stale-keep-alive case); real API errors propagate as
        KubeApiError — write idempotency is the CALLER's contract (binding
        treats 409 as success, deletes treat 404 as success), so blind
        status-code retries here would be unsafe. Every attempt pays the
        QPS/Burst token bucket first. The `kube.request` fault site injects
        409/5xx/transport errors at the top — the whole retry/rollback
        machinery above this call is exercised by it."""
        faults_mod.active().maybe_raise(
            "kube.request",
            method=method,
            path=path.split("?")[0],
            exc_factory=lambda s: KubeApiError(s, "injected apiserver fault"),
        )
        if query:
            path = f"{path}?{urllib.parse.urlencode(query)}"
        headers = self._headers()
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        backoff = Backoff(self._backoff_base_s, self._backoff_cap_s)
        attempt = 0
        while True:
            self.limiter.acquire()
            conn = getattr(self._local, "conn", None)
            if conn is None:
                conn = self._connect(timeout=self._request_timeout_s)
                self._local.conn = conn
            try:
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (OSError, http.client.HTTPException):
                conn.close()
                self._local.conn = None
                if attempt >= self.transport_retries:
                    raise
                attempt += 1
                if attempt > 1:
                    # First retry immediate (stale keep-alive is the common
                    # case and a fresh connection fixes it); later ones pace.
                    backoff.sleep()
                continue
            if resp.status >= 300:
                raise KubeApiError(resp.status, raw[:2048].decode("utf-8", "replace"))
            return json.loads(raw) if raw else None

    def _record_error(self, msg: str) -> None:
        self.errors.append(msg)
        del self.errors[:-20]


# ---------------------------------------------------------------------------------
# Apiserver-backed leader election (coordination.k8s.io/v1 Lease)
# ---------------------------------------------------------------------------------


class KubeLease:
    """Leader election over a k8s Lease object — the reference's actual
    mechanism (`operator/api/config/v1alpha1/types.go:73-104` rides
    controller-runtime's Lease-based election). Same try_acquire/release
    interface as runtime.lease.FileLease, so the Manager swaps them by
    cluster source: with a live apiserver the lease lives where every
    replica can see it, making multi-replica Deployments honest (a file
    lease only coordinates processes sharing a filesystem).

    Concurrency control is the apiserver's optimistic resourceVersion: the
    renewing PUT carries the GET's resourceVersion; a 409 means another
    replica won the race and this one stands down.
    """

    def __init__(
        self,
        ctx: KubeContext,
        name: str = "grove-tpu-operator-leader",
        lease_duration_seconds: float = 15.0,
        renew_deadline_seconds: Optional[float] = None,
        identity: Optional[str] = None,
        request_timeout_s: float = 5.0,
    ):
        import uuid

        self.ctx = ctx
        self.name = name
        self.lease_duration_seconds = lease_duration_seconds
        self.renew_deadline_seconds = renew_deadline_seconds
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self._request_timeout_s = request_timeout_s
        self._last_renew: Optional[float] = None
        ns = urllib.parse.quote(ctx.namespace)
        self._path = f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"

    # -- wire helpers ---------------------------------------------------------------

    def _req(self, method: str, path: str, body: Optional[dict] = None):
        # Fresh connection per call: one call per reconcile tick, so
        # handshake cost is irrelevant here (unlike the binding path).
        conn = _open_connection(self.ctx, timeout=self._request_timeout_s)
        try:
            data = json.dumps(body).encode() if body is not None else None
            headers = _auth_headers(self.ctx)
            if data is not None:
                headers["Content-Type"] = "application/json"
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 300:
                raise KubeApiError(resp.status, raw[:1024].decode("utf-8", "replace"))
            return json.loads(raw) if raw else None
        finally:
            conn.close()

    @staticmethod
    def _micro_time(now: float) -> str:
        import datetime

        dt = datetime.datetime.fromtimestamp(now, tz=datetime.timezone.utc)
        return dt.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"

    @staticmethod
    def _parse_micro_time(s: str) -> float:
        import datetime

        return (
            datetime.datetime.strptime(s, "%Y-%m-%dT%H:%M:%S.%fZ")
            .replace(tzinfo=datetime.timezone.utc)
            .timestamp()
        )

    # -- FileLease-compatible surface -----------------------------------------------

    def try_acquire(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        # Renew-deadline stand-down first (types.go semantics): an overslept
        # holder must stop leading BEFORE the lease could be stolen.
        if (
            self.renew_deadline_seconds is not None
            and self._last_renew is not None
            and now - self._last_renew > self.renew_deadline_seconds
        ):
            self._last_renew = None
            self.release()
            return False
        try:
            return self._acquire_or_renew(now)
        except (KubeApiError, OSError, ValueError):
            # Apiserver unreachable: WITHOUT a renewed lease we cannot lead.
            self._last_renew = None
            return False

    def _acquire_or_renew(self, now: float) -> bool:
        try:
            cur = self._req("GET", f"{self._path}/{self.name}")
        except KubeApiError as e:
            if e.status != 404:
                raise
            body = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self.name, "namespace": self.ctx.namespace},
                "spec": {
                    "holderIdentity": self.identity,
                    "leaseDurationSeconds": int(self.lease_duration_seconds),
                    "acquireTime": self._micro_time(now),
                    "renewTime": self._micro_time(now),
                    "leaseTransitions": 0,
                },
            }
            try:
                self._req("POST", self._path, body)
            except KubeApiError as e2:
                if e2.status == 409:  # another replica created it first
                    return False
                raise
            self._last_renew = now
            return True
        spec = cur.get("spec", {}) or {}
        holder = spec.get("holderIdentity")
        renew_raw = spec.get("renewTime")
        expired = True
        if renew_raw:
            try:
                renewed = self._parse_micro_time(renew_raw)
                expired = now - renewed >= self.lease_duration_seconds
            except ValueError:
                expired = True
        if holder != self.identity and not expired:
            self._last_renew = None
            return False
        transitions = int(spec.get("leaseTransitions", 0) or 0)
        if holder != self.identity:
            transitions += 1
            spec["acquireTime"] = self._micro_time(now)
        spec.update(
            holderIdentity=self.identity,
            leaseDurationSeconds=int(self.lease_duration_seconds),
            renewTime=self._micro_time(now),
            leaseTransitions=transitions,
        )
        cur["spec"] = spec
        try:
            self._req("PUT", f"{self._path}/{self.name}", cur)
        except KubeApiError as e:
            if e.status == 409:  # lost the optimistic-concurrency race
                self._last_renew = None
                return False
            raise
        self._last_renew = now
        return True

    def release(self) -> None:
        try:
            cur = self._req("GET", f"{self._path}/{self.name}")
            if (cur.get("spec", {}) or {}).get("holderIdentity") == self.identity:
                # Preconditioned delete: between the GET and the DELETE a
                # successor may have stolen an expired lease — deleting
                # unconditionally would evict THEIR active lease and open a
                # two-leader window. The resourceVersion precondition makes
                # the apiserver reject (409) the stale delete.
                rv = (cur.get("metadata", {}) or {}).get("resourceVersion")
                self._req(
                    "DELETE",
                    f"{self._path}/{self.name}",
                    {"preconditions": {"resourceVersion": rv}} if rv else None,
                )
        except (KubeApiError, OSError, ValueError):
            pass  # releasing best-effort; expiry reclaims it anyway


# ---------------------------------------------------------------------------------
# Pod manifest rendering (store Pod -> corev1.Pod the apiserver accepts)
# ---------------------------------------------------------------------------------


def render_pod_manifest(pod) -> dict:
    """Our store Pod -> a minimal corev1.Pod manifest. The reference's pod
    component builds the same object in Go (`podclique/components/pod/
    pod.go:135-172,232-269`): labels, GROVE_* env, stable hostname +
    subdomain, resource requests. Scheduling is OURS: the pod is created
    with spec.schedulerName=grove-tpu so kube-scheduler leaves it alone,
    and placement arrives via the binding subresource."""
    from grove_tpu_torch.api.quantity import format_quantity

    def _container_doc(c) -> dict:
        env = [{"name": k, "value": v} for k, v in {**c.env, **pod.env}.items()]
        env += [
            {"name": k, "valueFrom": v} for k, v in c.env_value_from.items()
        ]
        cdoc: dict = {"name": c.name, "image": c.image}
        if c.command:
            cdoc["command"] = list(c.command)
        if c.args:
            cdoc["args"] = list(c.args)
        if env:
            cdoc["env"] = env
        res: dict = {}
        if c.requests:
            res["requests"] = {
                k: format_quantity(v) for k, v in c.requests.items()
            }
        if c.limits:
            res["limits"] = {k: format_quantity(v) for k, v in c.limits.items()}
        if res:
            cdoc["resources"] = res
        if c.ports:
            cdoc["ports"] = [{"containerPort": p} for p in c.ports]
        if c.volume_mounts:
            # e.g. the injected initc's SA-token mount — dropping it would
            # leave the agent credential-less on a real cluster.
            cdoc["volumeMounts"] = [dict(vm) for vm in c.volume_mounts]
        return cdoc

    spec: dict = {
        "containers": [_container_doc(c) for c in pod.spec.containers],
        "schedulerName": "grove-tpu",
        "restartPolicy": pod.spec.restart_policy,
    }
    if pod.spec.init_containers:
        # Startup ordering rides on the injected initc container
        # (expansion.py; the reference injects the same way,
        # initcontainer.go:98-126) — dropping it would silently void the
        # startsAfter guarantee on real clusters.
        spec["initContainers"] = [
            _container_doc(c) for c in pod.spec.init_containers
        ]
    if pod.spec.hostname or pod.hostname:
        spec["hostname"] = pod.spec.hostname or pod.hostname
    if pod.spec.subdomain:
        spec["subdomain"] = pod.spec.subdomain
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.tolerations:
        spec["tolerations"] = list(pod.spec.tolerations)
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    if pod.spec.volumes:
        # Declared volumes (the initc token secret volume among them).
        spec["volumes"] = [dict(v) for v in pod.spec.volumes]
    annotations = dict(pod.annotations)
    for rc in pod.spec.resource_claims:
        # The store-level ICI-slice claim shape is OUR analog, not valid
        # corev1 PodResourceClaim (which requires resourceClaimName/
        # ...TemplateName backed by DRA objects) — rendering it verbatim
        # would 422 every MNNVL-annotated pod create. Carry the intent as
        # annotations until real DRA wiring exists; the node runtime /
        # device plugin reads them.
        src = rc.get("source", {}) or {}
        if src.get("iciDomain"):
            annotations[api_constants.ANNOTATION_ICI_DOMAIN] = src["iciDomain"]
    spec["terminationGracePeriodSeconds"] = (
        pod.spec.termination_grace_period_seconds
    )
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "labels": dict(pod.labels),
            "annotations": annotations,
        },
        "spec": spec,
    }
