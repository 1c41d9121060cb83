"""The Manager: one config file boots the whole control plane
(grove_tpu/runtime/manager.py counterpart).

Mirror of `operator/internal/controller/manager.go:53-121` +
`operator/cmd/main.go:46-128`: from a validated OperatorConfiguration it
wires the logger, the metrics registry + HTTP exposition, health/readiness
probes, leader election, the store + reconcile loop (with flow.go requeue
semantics), optional control-plane persistence, and optionally hosts the
scheduler-backend gRPC sidecar in-process.

The store is fed by the simulator, the watch driver
(grove_tpu_torch/cluster/watch.py — KWOK fake or a live kube-apiserver), or
backend RPCs. Admission runs in-process at every apply path AND as inbound
AdmissionReview webhooks on a dedicated HTTPS port (servers.webhookPort;
api/webhook.py) whose caBundle the manager patches into the rendered
webhook configurations at boot — the cert-controller rotator analog.

The port's manager solves on the card: `device` (None = the card, raising
without one; "cpu" = the plain PyTorch versions, asked for by the caller)
goes to its GroveController and its hosted sidecar, and start() builds the
CUDA kernels and the C renderer before it serves, failing loudly when a
build fails.
"""

from __future__ import annotations

import math
import http.server
import json
import threading
import time
from typing import Optional

from grove_tpu_torch.api import constants
from grove_tpu_torch.api.admission import AdmissionChain, Authorizer
from grove_tpu_torch.api.types import PodCliqueSet
from grove_tpu_torch.orchestrator.controller import GroveController
from grove_tpu_torch.orchestrator.queues import parse_queue_config
from grove_tpu_torch.orchestrator.store import Cluster
from grove_tpu_torch.runtime.config import OperatorConfiguration
from grove_tpu_torch.runtime.flow import (
    FlowOutcome,
    ReconcileStepResult,
    continue_reconcile,
    run_reconcile_flow,
)
from grove_tpu_torch.utils.errors import GroveError
from grove_tpu_torch.runtime.lease import FileLease
from grove_tpu_torch.utils.logging import Logger, new_logger
from grove_tpu_torch.utils.metrics import Registry


class _ProbeHandler(http.server.BaseHTTPRequestHandler):
    manager: "Manager"  # set per server instance

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._respond(200, "ok")
        elif self.path == "/readyz":
            ready = self.manager.ready
            self._respond(200 if ready else 503, "ok" if ready else "not ready")
        elif self.path == "/metrics":
            self._respond(200, self.manager.metrics.render_text())
        elif self.path == "/statusz":
            self._respond(200, json.dumps(self.manager.statusz()), "application/json")
        elif self.path.startswith("/api/v1/podcliques/"):
            # apiserver analog the grove-initc agent polls (initc/agent.py).
            # Readiness definition is store_fetch — the simulator's agent gate
            # and this endpoint must never diverge. This handler runs on an
            # HTTP thread while the reconcile thread mutates the pod dict;
            # retry the (GIL-atomic-per-step, but not per-iteration) scan on
            # the rare mid-iteration resize.
            from grove_tpu_torch.initc.agent import store_fetch

            fqn = self.path[len("/api/v1/podcliques/"):]
            clique = self.manager.cluster.podcliques.get(fqn)
            # Auth first: an unauthenticated caller must not learn which
            # clique FQNs exist (404 only after a valid credential).
            if not self._authorized(clique):
                self._respond(401, "unauthorized")
            elif clique is None:
                self._respond(404, "not found")
            else:
                fetch = store_fetch(self.manager.cluster)
                for _ in range(8):
                    try:
                        ready, _exists = fetch(fqn)
                        break
                    except RuntimeError:  # dict changed size during iteration
                        continue
                else:
                    self._respond(503, "store busy")
                    return
                self._respond(
                    200,
                    json.dumps(
                        {
                            "name": fqn,
                            "minAvailable": clique.min_available,
                            "ready": ready,
                        }
                    ),
                    "application/json",
                )
        elif self.path == "/profilez":
            # pprof analog (manager.go:42-44,114-119): reconcile-step timing
            # breakdown; only served when servers.profilingEnabled.
            if self.manager.config.servers.profiling_enabled:
                self._respond(200, json.dumps(self.manager.profilez()), "application/json")
            else:
                self._respond(404, "profiling disabled")
        elif self.path.startswith("/api/v1/"):
            # Same credential gate as the initc endpoint: with the authorizer
            # on, the WHOLE object API requires a valid workload token (the
            # apiserver-authn analog) — otherwise pod names would leak the
            # clique FQNs the 401-before-404 design protects.
            if not self._authorized(None):
                self._respond(401, "unauthorized")
            else:
                self._api_get(self.path[len("/api/v1/"):])
        else:
            self._respond(404, "not found")

    # ---- object API (typed-client surface; generated-clientset analog) ----------

    _COLLECTIONS = {
        "podcliquesets": "podcliquesets",
        # Cliques/PCSGs are LIST-only here (by-name GET on
        # /api/v1/podcliques/<fqn> is the initc readiness endpoint, matched
        # earlier in do_GET; by-name PCSG is blocked for symmetry). With the
        # authorizer on, these listings are scoped to the presented token's
        # OWNING PCS — the per-PCS RBAC discipline of the readiness
        # endpoint. (Pod listings stay namespace-wide for any valid token:
        # the reference's workload SA Role can list all pods too,
        # initc/internal/wait.go informers.)
        "podcliques": "podcliques",
        "podcliquescalinggroups": "scaling_groups",
        "podgangs": "podgangs",
        "pods": "pods",
        "nodes": "nodes",
        "services": "services",
        "hpas": "hpas",
        "events": None,  # special-cased
    }

    def _api_get(self, rest: str) -> None:
        from grove_tpu_torch.utils import serde

        rest, _, query = rest.partition("?")
        parts = [p for p in rest.split("/") if p]
        if not parts or parts[0] not in self._COLLECTIONS:
            self._respond(404, "not found")
            return
        kind = parts[0]
        c = self.manager.cluster
        if kind == "events":
            self._respond(
                200,
                json.dumps([list(e) for e in c.recent_events(constants.EVENTS_BUFFER)]),
                "application/json",
            )
            return
        coll = getattr(c, self._COLLECTIONS[kind])
        scoped = kind in ("podcliques", "podcliquescalinggroups")
        if scoped and len(parts) > 1:
            self._respond(404, "not found")  # LIST-only collections
            return
        if scoped and self.manager.config.authorizer.enabled:
            owner = self._token_pcs()
            coll = {
                name: obj
                for name, obj in coll.items()
                if getattr(obj, "pcs_name", None) == owner
            }
        if len(parts) == 1:
            if query == "full=1":
                # Bulk listing: one response with every object, so table
                # clients (the CLI) don't do N+1 round trips at scale. Same
                # mid-iteration-resize retry as the initc endpoint above —
                # this thread races the reconcile thread's dict mutations.
                for _ in range(8):
                    try:
                        doc = {
                            name: serde.encode(obj)
                            for name, obj in sorted(coll.items())
                        }
                        break
                    except RuntimeError:
                        continue
                else:
                    self._respond(503, "store busy")
                    return
                self._respond(200, json.dumps(doc), "application/json")
                return
            self._respond(200, json.dumps(sorted(coll)), "application/json")
            return
        obj = coll.get("/".join(parts[1:]))
        if obj is None:
            self._respond(404, "not found")
            return
        self._respond(200, json.dumps(serde.encode(obj)), "application/json")

    def do_POST(self):  # noqa: N802 (stdlib API)
        """Apply a PodCliqueSet through the admission chain (kubectl-apply
        analog). Body: YAML or JSON PCS document. Also accepts HPA metrics
        pushes on /api/v1/metrics (the metrics-server feed)."""
        if self.path == "/api/v1/metrics":
            if not self._authorized(None):
                self._respond(401, "unauthorized")
                return
            length = int(self.headers.get("Content-Length", "0"))
            try:
                doc = json.loads(self.rfile.read(length).decode())
                if not isinstance(doc, dict):
                    raise ValueError("metrics body must be a JSON object")
                update = {str(k): float(v) for k, v in doc.items()}
                # json.loads admits the NaN/Infinity literals; a non-finite
                # ratio would make autoscale's ceil() raise on every tick.
                bad = [k for k, v in update.items() if not math.isfinite(v)]
                if bad:
                    raise ValueError(f"non-finite utilization for {bad}")
            except (ValueError, TypeError) as e:
                self._respond(400, json.dumps({"errors": [str(e)]}), "application/json")
                return
            self.manager.hpa_metrics.update(update)
            self._respond(200, json.dumps({"targets": len(update)}), "application/json")
            return
        if self.path == "/api/v1/scale":
            # kubectl-scale analog: {"target": <pclq|pcsg FQN>, "replicas": N}
            # writes the scale subresource (same path the HPA drives).
            if not self._authorized(None):
                self._respond(401, "unauthorized")
                return
            length = int(self.headers.get("Content-Length", "0"))
            actor = self.headers.get("X-Grove-Actor", "user")
            try:
                doc = json.loads(self.rfile.read(length).decode())
                if not isinstance(doc, dict) or "target" not in doc or "replicas" not in doc:
                    raise ValueError('body must be {"target": ..., "replicas": N}')
                target = str(doc["target"])
                replicas = doc["replicas"]
                if not isinstance(replicas, int) or isinstance(replicas, bool):
                    raise ValueError("replicas must be an integer")
                previous = self.manager.scale_target(target, replicas, actor=actor)
            except KeyError as e:
                self._respond(
                    404, json.dumps({"errors": [f"unknown scale target {e}"]}),
                    "application/json",
                )
                return
            except (ValueError, TypeError) as e:
                self._respond(400, json.dumps({"errors": [str(e)]}), "application/json")
                return
            self._respond(
                200,
                json.dumps({"target": target, "replicas": replicas, "previous": previous}),
                "application/json",
            )
            return
        if self.path != "/api/v1/podcliquesets":
            self._respond(404, "not found")
            return
        if not self._authorized(None):
            self._respond(401, "unauthorized")
            return
        import yaml as _yaml

        from grove_tpu_torch.api.admission import AdmissionError
        from grove_tpu_torch.api.types import PodCliqueSet

        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length).decode()
        actor = self.headers.get("X-Grove-Actor", "user")
        try:
            doc = _yaml.safe_load(body)
            pcs = self.manager.apply_podcliqueset(
                PodCliqueSet.from_dict(doc), actor=actor
            )
        except AdmissionError as e:
            self._respond(
                422,
                json.dumps({"errors": [str(x) for x in e.errors]}),
                "application/json",
            )
            return
        except Exception as e:  # malformed body is a client error, not a crash
            self._respond(400, json.dumps({"errors": [str(e)]}), "application/json")
            return
        self._respond(200, json.dumps({"name": pcs.metadata.name}), "application/json")

    def do_DELETE(self):  # noqa: N802 (stdlib API)
        prefix = "/api/v1/podcliquesets/"
        if not self.path.startswith(prefix):
            self._respond(404, "not found")
            return
        if not self._authorized(None):
            self._respond(401, "unauthorized")
            return
        name = self.path[len(prefix):]
        actor = self.headers.get("X-Grove-Actor", "user")
        if name not in self.manager.cluster.podcliquesets:
            self._respond(404, "not found")
            return
        self.manager.delete_podcliqueset(name, actor=actor)
        self._respond(200, json.dumps({"deleted": name}), "application/json")

    def _token_pcs(self):
        """The PCS whose initc token secret matches the presented bearer
        credential, or None — the per-PCS scope for clique/PCSG listings."""
        import hmac

        from grove_tpu_torch.api import naming

        auth = self.headers.get("Authorization", "")
        for pcs_name in list(self.manager.cluster.podcliquesets):
            secret = self.manager.cluster.secrets.get(
                naming.initc_sa_token_secret_name(pcs_name)
            )
            if secret is not None and hmac.compare_digest(
                auth, f"Bearer {secret.token}"
            ):
                return pcs_name
        return None

    def _authorized(self, clique) -> bool:
        """SA-token check (satokensecret component made real): when the
        authorizer is on, the initc credential for the OWNING PCS must be
        presented as a bearer token — the RBAC scope is per-PCS, so one
        workload's token cannot read another's cliques. Unknown cliques
        require SOME valid token (any PCS's) so existence isn't probeable
        without a credential."""
        if not self.manager.config.authorizer.enabled:
            return True
        import hmac

        from grove_tpu_torch.api import naming

        auth = self.headers.get("Authorization", "")
        if clique is None:
            return any(
                hmac.compare_digest(auth, f"Bearer {s.token}")
                for s in self.manager.cluster.secrets.values()
            )
        secret = self.manager.cluster.secrets.get(
            naming.initc_sa_token_secret_name(clique.pcs_name)
        )
        if secret is None:
            return False
        return hmac.compare_digest(auth, f"Bearer {secret.token}")

    def _respond(self, code: int, body: str, ctype: str = "text/plain"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass


def _serve_admission_review(handler: "_ProbeHandler") -> None:
    """Inbound AdmissionReview v1 endpoints — the apiserver-facing webhook
    surface (webhook/register.go:34-62 analog). Served ONLY on the dedicated
    webhook port: these are called BY the apiserver, which authenticates the
    operator via the serving cert, not a bearer token — putting them on the
    (possibly plaintext, token-guarded) API port would expose an
    unauthenticated admission oracle to every workload pod."""
    from grove_tpu_torch.api.webhook import handle_authorize, handle_mutate, handle_validate

    length = int(handler.headers.get("Content-Length", "0"))
    try:
        review = json.loads(handler.rfile.read(length).decode())
        if not isinstance(review, dict):
            raise ValueError("AdmissionReview body must be a JSON object")
    except (ValueError, TypeError) as e:
        handler._respond(400, json.dumps({"errors": [str(e)]}), "application/json")
        return
    if handler.path.endswith("authorize"):
        out = handle_authorize(
            review,
            handler.manager.admission,
            handler.manager.operator_users(),
            # Parent-PCS resolution for the disable-protection annotation
            # bypass (handler.go:89-93) — the store is the PCS cache here.
            pcs_lookup=handler.manager.cluster.podcliquesets.get,
        )
    elif handler.path.endswith("default"):
        out = handle_mutate(review, handler.manager.admission)
    else:
        out = handle_validate(review, handler.manager.admission)
    handler._respond(200, json.dumps(out), "application/json")


class _WebhookHandler(_ProbeHandler):
    """The dedicated webhook server's handler: AdmissionReview POSTs plus a
    bare /healthz — nothing else from the API surface leaks onto the
    apiserver-facing port (the reference's webhook server is likewise
    separate from metrics/health, manager.go:90-121)."""

    def do_GET(self):  # noqa: N802
        if self.path == "/healthz":
            self._respond(200, "ok")
        else:
            self._respond(404, "not found")

    def do_POST(self):  # noqa: N802
        if self.path in (
            "/webhook/v1/default",
            "/webhook/v1/validate",
            "/webhook/v1/authorize",
        ):
            _serve_admission_review(self)
        else:
            self._respond(404, "not found")

    def do_DELETE(self):  # noqa: N802
        self._respond(404, "not found")


def _require_self_signed(cert_file: str) -> None:
    """Raise CertError when a manual webhook cert is CA-issued but no
    tlsCaFile was given (issuer != subject means the leaf cannot serve as
    its own trust root in caBundle). openssl-unavailable => skip the check
    (same best-effort posture as cert generation)."""
    import subprocess

    from grove_tpu_torch.runtime.certs import CertError

    try:
        out = subprocess.run(
            ["openssl", "x509", "-noout", "-issuer", "-subject", "-in", cert_file],
            capture_output=True,
            text=True,
        )
    except OSError:
        return
    if out.returncode != 0:
        return
    fields = dict(
        line.split("=", 1) for line in out.stdout.splitlines() if "=" in line
    )
    issuer = fields.get("issuer", "").strip()
    subject = fields.get("subject", "").strip()
    if issuer and subject and issuer != subject:
        raise CertError(
            "servers.tlsCertFile is CA-issued (issuer != subject) but "
            "servers.tlsCaFile is unset: the webhook caBundle patch would "
            "install an unverifiable leaf as trust root; set tlsCaFile to "
            "the issuing CA bundle"
        )


class _EventDeduper:
    """One control-plane event per (object, reason) per window.

    The heal paths (`_apply_child_scale_event`, `_apply_workload_event`)
    used to rely on last-value/last-spec guards alone: an external writer
    FLAPPING between two distinct bad values defeated those and re-evented
    on every relist echo. The window dedupe closes that: however the bad
    value churns, one (object, reason) pair emits at most once per window —
    the event ring records the episode, not the flap frequency."""

    def __init__(self, window_seconds: float) -> None:
        self.window_seconds = float(window_seconds)
        self.suppressed = 0
        self._last: dict[tuple[str, str], float] = {}

    def should_emit(self, now: float, obj: str, reason: str) -> bool:
        if self.window_seconds <= 0:
            return True
        key = (obj, reason)
        last = self._last.get(key)
        # A clock that moved BACKWARD past the window (virtual-time tests,
        # wall-clock step) re-arms rather than suppressing forever.
        if last is not None and 0 <= now - last < self.window_seconds:
            self.suppressed += 1
            return False
        self._last[key] = now
        if len(self._last) > 4096:  # bound the memo on pathological churn
            cutoff = now - self.window_seconds
            self._last = {k: t for k, t in self._last.items() if t >= cutoff}
        return True

    def reset(self, obj: str, reason: str) -> None:
        """End the episode early: the heal landed (echo confirmed / apply
        succeeded), so the NEXT bad write is a new episode and must event
        even inside the window."""
        self._last.pop((obj, reason), None)


class Manager:
    """Boots and runs the control plane from one OperatorConfiguration."""

    def __init__(
        self,
        config: OperatorConfiguration,
        cluster: Optional[Cluster] = None,
        log: Optional[Logger] = None,
        device=None,
    ):
        from grove_tpu_torch.solver.core import resolve_device

        self.config = config
        # Resolved once: a missing card raises here, before anything starts.
        self.device = resolve_device(device)
        self.log = log or new_logger(config.log.level, config.log.format)
        self.metrics = Registry()
        self.cluster = cluster or Cluster()
        self.topology = config.cluster_topology()
        self.controller = GroveController(
            cluster=self.cluster,
            topology=self.topology,
            solver_params=config.solver.solver_params(),
            priority_classes=dict(config.scheduling.priority_classes),
            queues=parse_queue_config(config.scheduling.queues) or {},
            tas_enabled=config.topology_aware_scheduling.enabled,
            max_groups=config.solver.max_groups,
            max_sets=config.solver.max_sets,
            max_pods=config.solver.max_pods,
            pad_gangs_to=config.solver.pad_gangs_to,
            portfolio=config.solver.portfolio,
            portfolio_escalation=config.solver.portfolio_escalation,
            pruning=config.solver.pruning_config(),
            mesh_cfg=config.solver.mesh_config(),
            auto_slice_enabled=config.network_acceleration.auto_slice_enabled,
            slice_resource_name=config.network_acceleration.slice_resource_name,
            initc_server_url=config.servers.advertise_url,
            initc_mode=config.cluster.initc_mode,
            defrag_enabled=config.defrag.enabled,
            defrag_threshold=config.defrag.threshold,
            defrag_interval_seconds=config.defrag.interval_seconds,
            defrag_max_concurrent=config.defrag.max_concurrent_migrations,
            defrag_cooldown_seconds=config.defrag.gang_cooldown_seconds,
            defrag_max_moves=config.defrag.max_moves_per_plan,
            defrag_min_efficiency=config.defrag.min_efficiency,
            rollout_enabled=config.rollout.enabled,
            rollout_surge_racks=config.rollout.surge_racks,
            rollout_backoff_base_seconds=config.rollout.backoff_base_seconds,
            rollout_backoff_cap_seconds=config.rollout.backoff_cap_seconds,
            rollout_deadline_seconds=config.rollout.deadline_seconds,
            revocation_eviction_lead_seconds=(
                config.cluster.revocable_eviction_lead_seconds
            ),
            tenancy_enabled=config.tenancy.enabled,
            tenancy_aging_half_life_seconds=config.tenancy.aging_half_life_seconds,
            tenancy_aging_max_boost=config.tenancy.aging_max_boost,
            device=self.device,
        )
        # Bounded event ring (controllers.eventsBuffer): long soaks must not
        # leak; overflow drops oldest + counts (grove_events_dropped_total).
        self.cluster.set_events_maxlen(config.controllers.events_buffer)
        # Heal-event window dedupe (controllers.healEventDedupeSeconds): one
        # event per (object, reason) episode, whatever the relist cadence.
        self._heal_dedupe = _EventDeduper(
            config.controllers.heal_event_dedupe_seconds
        )
        # Decision flight recorder (config section `trace`): journals solve
        # waves + disruptive actions for deterministic replay and what-if
        # counterfactuals (grove_tpu_torch/trace; docs/design.md).
        self.trace_recorder = None
        if config.trace.enabled:
            from grove_tpu_torch.trace.recorder import TraceRecorder

            self.trace_recorder = TraceRecorder(
                config.trace.path,
                max_records_per_file=config.trace.max_records_per_file,
                max_files=config.trace.max_files,
                queue_size=config.trace.queue_size,
                flush_interval_seconds=config.trace.flush_interval_seconds,
            )
            self.controller.recorder = self.trace_recorder
        # Deterministic fault injection (config section `faults`, env
        # override GROVE_FAULTS): installed process-wide at start() so the
        # named sites across the stack see it; every fire is journaled as a
        # flight-recorder action record and counted.
        from grove_tpu_torch import faults as faults_mod

        self.fault_injector = faults_mod.from_config(
            config.faults, recorder=self.trace_recorder
        )
        # Graceful-degradation ladder (config section `resilience`): shared
        # control-plane state — the per-tick solves, the bind commit path,
        # and any stream/drain driver handed controller.resilience all see
        # the same breaker states. Transitions journal + log (never silent).
        self.resilience_ladder = None
        if config.resilience.enabled:
            from grove_tpu_torch.solver.resilience import DegradationLadder

            def _ladder_event(event: str, subsystem: str) -> None:
                self.log.info(
                    f"degradation ladder {event}", subsystem=subsystem
                )
                if self.trace_recorder is not None:
                    try:
                        self.trace_recorder.capture_action(
                            time.time(), f"resilience.{event}", subsystem
                        )
                    except Exception:  # noqa: BLE001
                        pass

            self.resilience_ladder = DegradationLadder(
                config.resilience.resilience_config(), on_event=_ladder_event
            )
            self.controller.resilience = self.resilience_ladder
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._http_servers: list[http.server.ThreadingHTTPServer] = []
        # FileLease, or cluster.kubernetes.KubeLease when source=kubernetes
        # (same try_acquire/release surface).
        self._lease: Optional[FileLease] = None
        self._is_leader = not config.leader_election.enabled
        # Cellular control plane (config cells section): the partition plan
        # (grove_tpu_torch/cells/partition.py) and the per-cell named leases
        # (runtime/lease.LeaseSet — independent renewal clocks). Built by
        # start() when cells.enabled; renewed each run-loop tick.
        self.cell_plan = None
        self.cell_leases = None
        self._backend_server = None
        self.backend_port: Optional[int] = None
        self.health_port: Optional[int] = None
        self._started = False
        self._prewarm_thread: Optional[threading.Thread] = None
        self._next_requeue: Optional[float] = None
        self.persistence = None  # wired by start() when enabled
        self.metrics_port: Optional[int] = None
        self.webhook_port: Optional[int] = None
        self._tls_paths: Optional[tuple[str, str]] = None  # (cert, key) once ensured
        self._webhook_tls_paths: Optional[tuple[str, str]] = None
        self._webhook_ca_pending = False  # boot patch failed; retry in reconcile
        self._operator_users: Optional[frozenset] = None  # cached (static)
        # Child-CR scale values already rejected (ceilings): name -> value.
        # Guards against per-replay event spam until the healing PUT lands.
        self._rejected_child_scales: dict[str, int] = {}
        # /profilez state: per-step cumulative seconds + call counts.
        self._profile: dict[str, dict[str, float]] = {}
        # Watch driver (cluster integration path): attached via attach_watch;
        # pumped before and pushed after every reconcile pass.
        self.watch = None
        # gRPC client the manager itself created (kwok node-forwarding) and
        # must close at stop(); caller-supplied clients stay caller-owned.
        self._owned_backend_client = None
        # Live-apiserver watch source (cluster.source: kubernetes); its
        # reader threads are stopped at manager stop().
        self._kube_source = None
        # Rejected-CR dedupe: name -> repr of the last spec the admission
        # chain rejected (one event per distinct bad spec, not per echo).
        self._rejected_workload_specs: dict[str, str] = {}
        # HPA utilization feed (metrics-server analog): target FQN -> current
        # average utilization normalized to the target (1.0 == at target).
        # Pushed via POST /api/v1/metrics; consumed by the autoscale step.
        self.hpa_metrics: dict[str, float] = {}
        # Admission chain (webhook analog): defaulting + validation +
        # authorizer-protected managed resources (config.authorizer).
        self.admission = AdmissionChain(
            topology=self.topology,
            authorizer=Authorizer(
                enabled=config.authorizer.enabled,
                exempt_actors=tuple(config.authorizer.exempt_actors),
            ),
            known_queues=frozenset(config.scheduling.queues),
            auto_slice_enabled=config.network_acceleration.auto_slice_enabled,
            slice_resource_name=config.network_acceleration.slice_resource_name,
        )

        self._m_reconciles = self.metrics.counter(
            "grove_reconcile_total", "Reconcile passes run"
        )
        self._m_reconcile_errors = self.metrics.counter(
            "grove_reconcile_errors_total", "Reconcile step errors"
        )
        self._m_reconcile_seconds = self.metrics.histogram(
            "grove_reconcile_duration_seconds", "Reconcile pass duration"
        )
        self._m_leader = self.metrics.gauge(
            "grove_leader", "1 when this process holds the leader lease"
        )
        # Cellular control plane (grove_tpu_torch/cells): plan size plus per-cell
        # lease holdership and queue-pin counts, labeled by cell name.
        self._m_cell_count = self.metrics.gauge(
            "grove_cell_count", "Reconcile cells in the partition plan"
        )
        self._m_cell_lease_held = self.metrics.gauge(
            "grove_cell_lease_held",
            "1 when this process holds the named cell lease",
        )
        self._m_cell_queues = self.metrics.gauge(
            "grove_cell_queues", "Queues pinned to the cell by the plan"
        )
        self._m_gangs_admitted = self.metrics.counter(
            "grove_gangs_admitted_total", "Gangs admitted by the solver"
        )
        self._m_queue_used = self.metrics.gauge(
            "grove_queue_used", "Bound resource usage per capacity queue"
        )
        # Solve-wave dispositions (controller.solve_pass_counts): how often
        # the damper turned a reconcile into a skip or an arrivals-only
        # delta instead of a full encode+solve. A real Counter (rate()
        # works, OpenMetrics _total convention holds); the refresh incs
        # the delta against the last exported snapshot.
        self._m_solve_passes = self.metrics.counter(
            "grove_solve_passes_total",
            "Solve waves by disposition (full | delta | skipped)",
        )
        self._solve_passes_exported = {"full": 0, "delta": 0, "skipped": 0}
        # GREP-244 "TAS metrics" direction: PlacementScore distribution of
        # admitted gangs (scheduler podgang.go:176-178; 1.0 = optimal).
        # Buckets cover the score's [0,1] range, dense near the top where
        # placement-quality regressions show first.
        self._m_placement_score = self.metrics.histogram(
            "grove_placement_score",
            "PlacementScore of gangs at first admission (1.0 = optimal)",
            buckets=(0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0),
        )
        # Defragmentation loop observability (GREP-244 metrics direction):
        # the fragmentation score is a gauge (sampled each defrag tick), the
        # per-level stranded fractions carry level+resource labels, and the
        # migration counters export as real Counters (delta-tracked against
        # controller.defrag_counts, same discipline as solve passes).
        self._m_frag_score = self.metrics.gauge(
            "grove_fragmentation_score",
            "Cluster fragmentation score (1 - best domain free / ideal)",
        )
        self._m_frag_stranded = self.metrics.gauge(
            "grove_fragmentation_stranded",
            "Stranded free-capacity fraction per topology level and resource",
        )
        self._m_defrag_plans = self.metrics.counter(
            "grove_defrag_plans_total", "Migration plans executed"
        )
        self._m_defrag_migrations = self.metrics.counter(
            "grove_defrag_migrations_total", "Gang migrations started by defrag"
        )
        self._m_defrag_pods = self.metrics.counter(
            "grove_defrag_pods_migrated_total", "Pods rebound by defrag migrations"
        )
        self._m_defrag_migrating = self.metrics.gauge(
            "grove_defrag_migrating", "Gangs currently mid-migration"
        )
        self._defrag_exported = {"plans": 0, "migrations": 0, "pods_migrated": 0}
        # Fleet lifecycle (rollout + revocable capacity) counters, exported
        # as deltas from controller.rollout_counts / revocation_counts; the
        # gauge samples replicas currently mid-replacement.
        self._m_rollout_cutovers = self.metrics.counter(
            "grove_rollout_cutovers_total",
            "Make-before-break replica cutovers committed",
        )
        self._m_rollout_retries = self.metrics.counter(
            "grove_rollout_retries_total",
            "Deferred-replica retries scheduled by the rollout backoff",
        )
        self._m_rollout_fallbacks = self.metrics.counter(
            "grove_rollout_fallbacks_total",
            "Replicas that fell back to delete-then-recreate (deadline spent)",
        )
        self._m_rollout_replacing = self.metrics.gauge(
            "grove_rollout_replacing",
            "Rolling-update replicas currently mid-replacement",
        )
        self._m_revocation_notices = self.metrics.counter(
            "grove_revocation_notices_total", "Revocation notices observed"
        )
        self._m_revocation_migrated = self.metrics.counter(
            "grove_revocation_migrations_total",
            "Gangs rescued off revocation-pending nodes by migration",
        )
        self._m_revocation_evicted = self.metrics.counter(
            "grove_revocation_evictions_total",
            "Gangs evicted ahead of a revocation deadline (SLO-rank order)",
        )
        self._rollout_exported = {"cutovers": 0, "retries": 0, "fallbacks": 0}
        self._revocation_exported = {"notices": 0, "migrated": 0, "evicted": 0}
        # Tenancy fairness surfaces (grove_tpu_torch/tenancy): counters are
        # delta-exported from the ledger totals (same discipline as defrag),
        # gauges sample the ledger/budget each reconcile.
        self._m_tenancy_admitted = self.metrics.counter(
            "grove_tenancy_admitted_total", "Gangs first-admitted (tenancy view)"
        )
        self._m_tenancy_borrowed = self.metrics.counter(
            "grove_tenancy_admitted_borrowing_total",
            "Admissions that rode borrowed queue capacity",
        )
        self._m_tenancy_preemptions = self.metrics.counter(
            "grove_tenancy_preemptions_total", "Gangs preempted (tenancy view)"
        )
        self._m_tenancy_reclaims = self.metrics.counter(
            "grove_tenancy_reclaims_total", "Gangs evicted by quota reclaim"
        )
        self._m_tenancy_reclaim_deferred = self.metrics.counter(
            "grove_tenancy_reclaim_deferred_total",
            "Reclaims deferred by the shared disruption budget",
        )
        self._m_tenancy_aging = self.metrics.counter(
            "grove_tenancy_aging_boosts_total", "Aging-ladder steps granted"
        )
        self._m_tenancy_tenants = self.metrics.gauge(
            "grove_tenancy_tenants", "Tenants (queues) seen by the ledger"
        )
        self._m_tenancy_disrupted = self.metrics.gauge(
            "grove_tenancy_disrupted",
            "Gangs counted against the shared disruption budget right now",
        )
        self._tenancy_exported = {
            "admitted": 0,
            "admitted_borrowing": 0,
            "preemptions": 0,
            "reclaims": 0,
            "reclaim_deferred": 0,
            "aging_boosts": 0,
        }
        # Placement-quality gauges (quality/report.py consumers): the last
        # non-empty solve wave's aggregate view, refreshed each reconcile —
        # the live-serving counterpart of the bench's quality report, so a
        # quality regression shows on /metrics before any bench run does.
        self._m_quality_admitted_ratio = self.metrics.gauge(
            "grove_placement_quality_admitted_ratio",
            "Admitted / schedulable gangs in the last non-empty solve wave",
        )
        self._m_quality_score = self.metrics.gauge(
            "grove_placement_quality_score",
            "Mean PlacementScore of gangs admitted by the last solve wave",
        )
        self._m_quality_pref = self.metrics.gauge(
            "grove_placement_quality_preferred_fraction",
            "Mean preferred-domain fraction implied by the last wave's scores",
        )
        # Flight recorder + event-ring observability (trace subsystem):
        # journal records written/dropped (delta-exported from the recorder
        # counters), replay divergences found by replay_verify (every
        # divergence is a solver-nondeterminism regression), and events the
        # bounded ring dropped.
        self._m_trace_records = self.metrics.counter(
            "grove_trace_records_total", "Flight-recorder records journaled"
        )
        self._m_trace_dropped = self.metrics.counter(
            "grove_trace_dropped_total",
            "Flight-recorder records dropped (bounded queue full)",
        )
        self._m_replay_divergence = self.metrics.counter(
            "grove_replay_divergence_total",
            "Plan divergences found by deterministic replay verification",
        )
        self._m_events_dropped = self.metrics.counter(
            "grove_events_dropped_total",
            "Control-plane events dropped by the bounded event ring",
        )
        self._trace_exported = {"recorded": 0, "dropped": 0}
        self._events_dropped_exported = 0
        # Kube wire-client throttling (cluster.kubeQps/kubeBurst token
        # bucket): requests that had to wait for a token.
        self._m_kube_throttled = self.metrics.counter(
            "grove_kube_client_throttled_total",
            "Apiserver requests delayed by the QPS/Burst token bucket",
        )
        self._kube_throttled_exported = 0
        # Candidate-pruning observability (solver/pruning.py): the last
        # pruned solve's candidate-axis size (gauge) and the exactness-
        # escalation counter (lossy rejection -> dense re-solve; delta-
        # exported from warm.prune, same discipline as solve passes).
        self._m_candidate_nodes = self.metrics.gauge(
            "grove_solver_candidate_nodes",
            "Candidate-axis size of the last pruned solve (0 = dense)",
        )
        # Mesh-shard fallback ledger (parallel/mesh.py): solves that wanted
        # a multi-device layout but ran unsharded — the observable side of
        # the solve_layout_for no-divisible-split path.
        self._m_shard_fallbacks = self.metrics.counter(
            "grove_solver_shard_fallbacks_total",
            "Solver mesh-layout negotiations that fell back to unsharded",
        )
        self._shard_fallbacks_exported = 0
        self._m_candidate_escalations = self.metrics.counter(
            "grove_solver_candidate_escalations_total",
            "Pruned-solve rejections re-verified by a dense re-solve",
        )
        self._prune_escalations_exported = 0
        # Host<->device round-trip ledger (solver/drain.DrainStats): every
        # drain/stream feeds the warm path's cumulative dispatch/harvest
        # counters through record_drain regardless of harvest discipline,
        # so the deltas here never miss a drain between scrapes. The scan
        # discipline's whole point is this counter: O(shape classes +
        # escalations) instead of O(waves).
        self._m_drain_roundtrips = self.metrics.counter(
            "grove_drain_device_roundtrips_total",
            "Host-blocking device harvest syncs across all drains/streams",
        )
        self._m_drain_dispatches = self.metrics.counter(
            "grove_drain_dispatches_total",
            "Solve programs dispatched across all drains/streams "
            "(a scanned chunk counts once)",
        )
        self._roundtrips_exported = 0
        self._dispatches_exported = 0
        # Streaming-drain observability (solver/stream.py): pipeline depth
        # and steady-state throughput of the last streaming run (gauges cut
        # from warm.last_stream), and the measured per-gang enqueue->bound
        # distribution (samples drained from the warm path's bounded queue
        # each refresh — a stream outrunning the scrape loses oldest
        # samples, never memory).
        self._m_stream_depth = self.metrics.gauge(
            "grove_stream_depth",
            "Pipeline depth of the last streaming drain (0 = serial)",
        )
        self._m_stream_gps = self.metrics.gauge(
            "grove_stream_gangs_per_sec",
            "Steady-state admitted gangs/sec of the last streaming drain",
        )
        self._m_stream_ttb = self.metrics.histogram(
            "grove_stream_time_to_bind_seconds",
            "Per-gang enqueue->bound seconds under streaming admission",
        )
        # Host-stage timing ledger (solver/drain.DrainStats.host_stages):
        # per-stage host seconds of the last drain/stream — the measurable
        # side of the host hot-path vectorization (encode/prefilter/decode/
        # bind must stay flat as the fleet grows).
        self._m_host_stage = self.metrics.gauge(
            "grove_host_stage_seconds",
            "Host seconds by stage of the last drain/stream "
            "(encode|prefilter|dispatch|harvest|decode|bind|journal|"
            "total|hotPath)",
        )
        # Failure-domain hardening observability (faults + resilience
        # sections): ladder transitions per subsystem, injected faults,
        # bind rollbacks / stale-plan requeues / bind push retries, watch
        # reconnects+resyncs, recorder write failures. All real Counters,
        # delta-exported each reconcile against the underlying monotonic
        # sources — same discipline as the solve-pass counters.
        self._m_degradation_down = self.metrics.counter(
            "grove_degradation_step_downs_total",
            "Degradation-ladder rungs stepped down (breaker opened)",
        )
        self._m_degradation_up = self.metrics.counter(
            "grove_degradation_step_ups_total",
            "Degradation-ladder rungs stepped back up (probation passed)",
        )
        self._degradation_exported: dict = {}
        self._m_faults_injected = self.metrics.counter(
            "grove_faults_injected_total",
            "Faults fired by the deterministic injection registry",
        )
        self._faults_exported = 0
        self._m_bind_rollbacks = self.metrics.counter(
            "grove_bind_rollbacks_total",
            "Gang binds rolled back (all-or-nothing commit failed mid-gang)",
        )
        self._m_stale_requeues = self.metrics.counter(
            "grove_stale_plan_requeues_total",
            "Gangs requeued at bind time because a target node died",
        )
        self._resilience_exported = {
            "bind_rollbacks": 0,
            "stale_plan_requeues": 0,
            "solve_degraded_retries": 0,
        }
        self._m_solve_degraded = self.metrics.counter(
            "grove_solve_degraded_retries_total",
            "Serving solves retried fully degraded after a solve failure",
        )
        self._m_watch_reconnects = self.metrics.counter(
            "grove_watch_reconnects_total",
            "Watch streams resubscribed after a disconnect",
        )
        self._m_watch_resyncs = self.metrics.counter(
            "grove_watch_resyncs_total",
            "Full watch resyncs forced by resourceVersion expiry (410)",
        )
        self._m_bind_push_retries = self.metrics.counter(
            "grove_bind_retries_total",
            "Kube bind pushes retried in-call with backoff",
        )
        self._watch_exported = {"reconnects": 0, "resyncs": 0, "bindRetries": 0}
        self._m_recorder_write_errors = self.metrics.counter(
            "grove_recorder_write_errors_total",
            "Flight-recorder segment writes that failed (counting-drops mode)",
        )
        self._recorder_write_errors_exported = 0
        # Every (queue, resource) series ever emitted — re-zeroed each pass
        # when usage disappears (gauge values persist otherwise).
        self._queue_metric_keys: dict[str, set] = {}

    # --- object apply surface (admission-gated; kubectl-apply analog) -------------

    def apply_podcliqueset(self, pcs: PodCliqueSet, actor: str = "user") -> PodCliqueSet:
        """Create/update a PCS through the admission chain (defaulting +
        validation + update immutability); raises AdmissionError on reject."""
        old = self.cluster.podcliquesets.get(pcs.metadata.name)
        pcs = self.admission.admit_podcliqueset(pcs, old=old)
        self.cluster.podcliquesets[pcs.metadata.name] = pcs
        return pcs

    def delete_podcliqueset(self, name: str, actor: str = "user") -> None:
        self.cluster.delete_pcs_cascade(name)
        # CR-backed workloads must ALSO be deleted at the apiserver, or the
        # next watch relist re-emits ADDED and resurrects the workload.
        if self._kube_source is not None and actor != "apiserver":
            self._kube_source.delete_workload(name)

    def scale_target(
        self,
        target: str,
        replicas: int,
        actor: str = "user",
        now: float | None = None,
    ) -> int:
        """kubectl-scale analog: write the scale subresource of a PodClique
        or PodCliqueScalingGroup — the SAME surface the HPA component writes
        (reference: `scale` subresource on the CRs, podcliqueset.go:27;
        HPA ScaleTargetRef, components/hpa/hpa.go:249-259). Returns the
        previous effective value. Raises KeyError for an unknown target,
        ValueError for a bad count."""
        c = self.cluster
        if target in c.podcliques:
            pclq = c.podcliques[target]
            if pclq.pcsg_name:
                # Members scale WITH their group (the reference forbids
                # individual autoscaling for them, validation/podcliqueset.
                # go:240-246; expansion takes member replicas from the
                # template). Accepting this would silently do nothing and
                # leave an externally-scaled CR diverged forever.
                raise ValueError(
                    f"{target} is a scaling-group member; scale the "
                    f"PodCliqueScalingGroup {pclq.pcsg_name} instead"
                )
            spec_replicas = pclq.spec.replicas
        elif target in c.scaling_groups:
            spec_replicas = c.scaling_groups[target].spec.replicas
        else:
            raise KeyError(target)
        if replicas < 0:
            raise ValueError("replicas must be >= 0")
        # Ceiling: the HPA's user-declared max when one targets this object,
        # else the control-plane sanity bound — one reconcile materializes a
        # Pod object per replica, so an unbounded request is an OOM lever.
        ceiling = constants.MAX_SCALE_REPLICAS
        hpa = c.hpas.get(f"{target}-hpa")
        if hpa is not None:
            ceiling = min(ceiling, hpa.max_replicas)
        if replicas > ceiling:
            raise ValueError(f"replicas must be <= {ceiling} for {target}")
        previous = c.scale_overrides.get(target, spec_replicas)
        c.scale_overrides[target] = int(replicas)
        # `now` keeps virtual-time callers (tests, simulator) on one event
        # timeline; the HTTP path has no virtual clock and takes wall time.
        c.record_event(
            time.time() if now is None else now,
            target,
            f"scaled {previous} -> {replicas} (by {actor})",
        )
        return previous

    def mutate_managed(self, actor: str, kind: str, name: str, fn) -> None:
        """Apply `fn(cluster)` as `actor` touching managed resource kind/name.
        The authorizer (when enabled) blocks everyone but the operator and
        exempt actors (authorization/handler.go:60-80)."""
        self.admission.admit_managed_mutation(actor, kind, name)
        fn(self.cluster)

    def _apply_child_scale_event(self, ev, now: float) -> None:
        """PodClique/PCSG CR watch event -> the scale subresource path.

        The child CRs are operator-owned projections, but their spec.replicas
        is the reference's public scale surface (HPA ScaleTargetRef,
        hpa.go:249-259; kubectl scale pclq): an external value becomes a
        scale_target() call — the SAME path the in-process HPA and the CLI
        scale verb use (ceilings included).

        External-vs-echo is decided against what THIS process last PUSHED to
        the apiserver (source.last_projected_replicas), not against store
        state: a pending override makes the store disagree with the wire, so
        a relist replaying our own stale projection would otherwise read as
        an external write and revert a just-applied scale. A replica count
        equal to our last push is indistinguishable from our own echo (the
        inherent limit of a level-based watch) and is ignored; after an
        operator restart nothing has been pushed yet, so a CR value
        differing from the freshly-expanded spec is re-adopted — an external
        scale survives the restart."""
        if ev.type.value == "DELETED":
            return  # our own GC, or an out-of-band delete the sync heals
        spec = (ev.obj or {}).get("spec", {}) or {}
        reps = spec.get("replicas")
        if not isinstance(reps, int) or isinstance(reps, bool):
            return
        c = self.cluster
        cur = c.podcliques.get(ev.name) or c.scaling_groups.get(ev.name)
        if cur is None:
            return  # projection of an object the store no longer owns
        last = (
            self._kube_source.last_projected_replicas(ev.name)
            if self._kube_source is not None
            else None
        )
        if last is not None:
            if reps == last:
                # Our own write (live echo or relist replay). Seeing the CR
                # back at the pushed value also proves a heal PUT landed —
                # clear the rejected-value guard so a SECOND genuine write
                # of the same out-of-range value records and heals again
                # instead of being silently ignored forever. The dedupe
                # window resets with it: the landed heal ENDS the episode,
                # so the next rejection events even inside the window.
                self._rejected_child_scales.pop(ev.name, None)
                self._heal_dedupe.reset(ev.name, "cr-scale-rejected")
                return
        elif cur.spec.replicas == reps:
            return  # nothing pushed yet and the CR agrees with the store
        if c.scale_overrides.get(ev.name) == reps:
            return  # already requested; projection just hasn't caught up
        if self._rejected_child_scales.get(ev.name) == reps:
            return  # already rejected this exact value; no event spam
        try:
            self.scale_target(ev.name, reps, actor="apiserver", now=now)
            self._rejected_child_scales.pop(ev.name, None)
        except (KeyError, ValueError) as e:
            # Out-of-range external scale: surface once, don't crash the
            # pump — and heal the wire: invalidate the projection cache so
            # the next sync re-PUTs the effective manifest (the external
            # write changed the CR behind the cache's back; without this
            # kubectl would show the rejected value forever). The event is
            # additionally window-deduped per (object, reason): the value
            # guard above only stops IDENTICAL replays, so a writer flapping
            # between two bad values would otherwise event on every flip.
            self._rejected_child_scales[ev.name] = reps
            if self._heal_dedupe.should_emit(now, ev.name, "cr-scale-rejected"):
                c.record_event(now, ev.name, f"CR scale rejected: {e}")
            if self._kube_source is not None:
                self._kube_source.invalidate_child_projection(ev.name)

    def _apply_workload_event(self, ev, now: float) -> None:
        """PodCliqueSet watch event -> admission-gated apply / cascade
        delete. Rejections surface as control-plane events (the CR stays in
        the cluster; its status never progresses) rather than crashing the
        pump loop. `now` comes from the pump so CR events share the one
        event timeline (virtual time in tests, wall time in production)."""
        from grove_tpu_torch.api import default_podcliqueset
        from grove_tpu_torch.api.admission import AdmissionError

        name = ev.name
        if ev.type.value == "DELETED":
            if name in self.cluster.podcliquesets:
                self.delete_podcliqueset(name, actor="apiserver")
                self.cluster.record_event(
                    now, name, "workload CR deleted (apiserver watch)"
                )
            return
        try:
            # Default BEFORE the echo comparison: the stored spec is the
            # defaulted one, so comparing against the raw CR would never
            # match and every echo would take the full re-apply path.
            incoming = default_podcliqueset(PodCliqueSet.from_dict(ev.obj))
            existing = self.cluster.podcliquesets.get(name)
            if existing is not None and existing.spec == incoming.spec:
                # Status-only MODIFIED — usually the echo of our own status
                # write-back. Re-applying would replace the stored object
                # and wipe the status we just computed (write loop).
                return
            spec_key = repr(incoming.spec)
            if self._rejected_workload_specs.get(name) == spec_key:
                return  # already rejected this exact spec; don't re-event
            applied = self.apply_podcliqueset(incoming, actor="apiserver")
            self._rejected_workload_specs.pop(name, None)
            # A successful apply ends any rejection episode for this CR.
            self._heal_dedupe.reset(name, "cr-rejected")
            self._heal_dedupe.reset(name, "cr-unparseable")
            if existing is not None:
                # CR status is OURS (the operator is the status writer);
                # a spec update must not reset reconciled state.
                applied.status = existing.status
        except AdmissionError as e:
            # Async-validation reality: the reference rejects at the
            # apiserver door (inbound webhook); our chain runs in-process
            # AFTER etcd accepted the object, so a rejected edit leaves the
            # CR and the store diverged until the user fixes the CR. Record
            # ONE event per distinct rejected spec — the status write-back
            # echo would otherwise re-emit it every tick — and at most one
            # per (object, reason) window: distinct bad specs arriving in
            # quick succession are one heal episode, not an event flood.
            self._rejected_workload_specs[name] = spec_key
            if self._heal_dedupe.should_emit(now, name, "cr-rejected"):
                self.cluster.record_event(
                    now, name,
                    f"workload CR rejected: {'; '.join(str(x) for x in e.errors)}",
                )
        except Exception as e:  # malformed CR must not kill the pump
            if self._heal_dedupe.should_emit(now, name, "cr-unparseable"):
                self.cluster.record_event(
                    now, name, f"workload CR unparseable: {e}"
                )

    def attach_watch(self, source, backend=None) -> "object":
        """Feed the store from an external cluster's watch stream
        (grove_tpu_torch/cluster/watch.py). Returns the WatchDriver."""
        from grove_tpu_torch.cluster.watch import WatchDriver

        self.watch = WatchDriver(cluster=self.cluster, source=source, backend=backend)
        return self.watch

    # --- lifecycle ---------------------------------------------------------------

    @property
    def ready(self) -> bool:
        """readyz: started, and (when electing) leadership state known."""
        return self._started

    def profilez(self) -> dict:
        """Reconcile-step timing breakdown (pprof analog, profilingEnabled)."""
        return {
            "steps": {
                name: dict(rec) for name, rec in sorted(self._profile.items())
            }
        }

    def statusz(self) -> dict:
        from grove_tpu_torch.version import build_info

        queues = {}
        qtree = self.controller.queue_tree
        if qtree is not None:
            # HTTP thread vs reconcile thread: queue_usage iterates the pod
            # dict, so retry the rare mid-iteration resize (same discipline
            # as the object-API bulk reads).
            for _ in range(8):
                try:
                    usage = self.controller.queue_usage()
                    break
                except RuntimeError:
                    continue
            else:
                usage = {}
            husage = qtree.hierarchical_usage(usage)
            desc = qtree.describe()
            queues = {
                qname: {
                    **doc,
                    "depth": qtree.depth(qname),
                    # Hierarchical: a parent's `used` includes descendants.
                    "used": dict(husage.get(qname, {})),
                }
                for qname, doc in desc.items()
            }
        return {
            "build": build_info(),
            "queues": queues,
            # Damper effectiveness: solve waves by disposition.
            "solvePasses": dict(self.controller.solve_pass_counts),
            # Warm-path caches (solver/warm.py): AOT executable hits/misses/
            # lowerings + prewarm count, device-resident tensor reuse,
            # per-gang encode-row reuse, candidate-pruning counters, and the
            # last drain's measured wave-harvest latencies — the measurable
            # side of the compile-amortization discipline.
            "warmPath": self.controller.warm.stats(),
            # Candidate-pruning view (solver/pruning.py): effective config +
            # the counters the grove_solver_candidate_* metrics are cut from.
            "solver": self.solver_status(),
            # Defrag loop state: last fragmentation report, plan summary,
            # in-flight migrations, monotonic counters (what `grove-tpu get
            # defrag` renders).
            "defrag": self.controller.defrag_status(),
            "rollout": self.controller.rollout_status(),
            # Tenancy: per-tenant fairness ledger, aging state, shared
            # disruption-budget view (`grove-tpu get tenancy` renders this).
            "tenancy": self.controller.tenancy_status(),
            # Cellular control plane: partition plan + per-cell lease
            # holdership and journal paths (`grove-tpu get cells` renders
            # this; grove_cell_* metrics are cut from the same state).
            "cells": self.cells_status(),
            # Placement quality of live serving solves (quality/report.py
            # discipline — what `grove-tpu get quality` renders).
            "quality": self.controller.quality_status(),
            # Flight recorder state (trace config section): journal path,
            # records written/dropped, queue depth — what `grove-tpu trace
            # info` points at and the grove_trace_* metrics are cut from.
            "trace": self.trace_status(),
            # Failure-domain hardening state (faults + resilience sections):
            # ladder breaker states + step counters, injected-fault ledger,
            # bind rollback/stale-requeue counts, watch reconnects — what
            # `grove-tpu get resilience` renders and the grove_degradation_*
            # metrics are cut from.
            "resilience": self.resilience_status(),
            # The effective ClusterTopology (config TAS levels + auto host
            # level) — what `grove-tpu get topology` renders (kubectl get
            # clustertopology analog; the kubernetes source also syncs it
            # as a CR at boot).
            "topology": self.topology.levels_doc(),
            "leader": self._is_leader,
            "backend_port": self.backend_port,
            "objects": {
                "podcliquesets": len(self.cluster.podcliquesets),
                "podcliques": len(self.cluster.podcliques),
                "podgangs": len(self.cluster.podgangs),
                "pods": len(self.cluster.pods),
                "nodes": len(self.cluster.nodes),
            },
        }

    def cells_status(self) -> dict:
        """JSON-able cellular-control-plane view for /statusz "cells" and
        `grove-tpu get cells`: the partition plan (which cell owns which
        root subtrees/queues), per-cell lease holdership, and where each
        cell's journal lives (the tail a replacement cell replays)."""
        import os as _os

        cfg = self.config.cells
        doc: dict = {"enabled": bool(cfg.enabled)}
        if not cfg.enabled or self.cell_plan is None:
            return doc
        held = self.cell_leases.held() if self.cell_leases is not None else {}
        doc.update(
            count=len(self.cell_plan.cells),
            shardBy=cfg.shard_by,
            journalRoot=cfg.journal_root,
            plan=self.cell_plan.to_doc(),
            cells={
                name: {
                    "queues": self.cell_plan.queues_of(name),
                    "domains": self.cell_plan.domains_of(name),
                    "leaseHeld": bool(held.get(name, False)),
                    "journal": _os.path.join(cfg.journal_root, name),
                }
                for name in self.cell_plan.cells
            },
        )
        return doc

    def solver_status(self) -> dict:
        """JSON-able solver view for /statusz "solver" and `grove-tpu get
        solver`: the effective pruning configuration plus its counters and
        the last drain's wave-harvest latencies (warm.stats carries the
        same counters flat; this section adds the config context)."""
        pruning = self.controller.pruning
        doc: dict = {
            "pruning": {
                "enabled": bool(pruning is not None),
            }
        }
        if pruning is not None:
            doc["pruning"].update(
                maxCandidates=int(pruning.max_candidates),
                padLadder=[int(x) for x in pruning.pad_ladder],
                minPad=int(pruning.min_pad),
                minFleet=int(pruning.min_fleet),
            )
        doc["pruning"].update(self.controller.warm.prune.stats())
        # Mesh-sharded solve view (parallel/mesh.py): the effective
        # solver.mesh block, with an enabled one the node-axis shards the
        # last solve ran across (shardDevices, 0 = unsharded), plus the
        # shard-fallback ledger (solves that wanted a multi-device layout but
        # ran unsharded — never silent).
        mcfg = self.controller.mesh_cfg
        doc["mesh"] = {
            "enabled": bool(getattr(mcfg, "enabled", False)),
        }
        if mcfg is not None and getattr(mcfg, "enabled", False):
            doc["mesh"].update(
                minNodes=int(mcfg.min_nodes),
                maxDevices=int(mcfg.max_devices),
                shardDevices=int(self.controller.last_shard_devices),
            )
        try:
            from grove_tpu_torch.parallel.mesh import shard_fallbacks

            doc["mesh"]["shardFallbacks"] = shard_fallbacks()
        except Exception:  # noqa: BLE001 — status must never fail a scrape
            pass
        # Streaming-drain view (solver/stream.py): the effective
        # solver.streaming block plus the last streaming run's throughput
        # and measured time-to-bind percentiles (source of the
        # grove_stream_* metrics and the `get solver` stream rows).
        scfg = self.config.solver.streaming_config()
        doc["streaming"] = {
            "depth": int(scfg.depth),
            "waveSize": int(scfg.wave_size),
            "maxWaitS": float(scfg.max_wait_s),
            "pollS": float(scfg.poll_s),
        }
        # On-device fused drain view (solver/drain.py harvest="scan"): the
        # effective solver.scan block plus the cumulative round-trip ledger
        # (source of the grove_drain_device_roundtrips_total counter — the
        # number the scan discipline exists to shrink).
        kcfg = self.config.solver.scan_config()
        doc["scan"] = {
            "enabled": bool(kcfg.enabled),
            "maxScanLen": int(kcfg.max_scan_len),
            "minWavesPerClass": int(kcfg.min_waves_per_class),
            "affinityLookahead": int(kcfg.affinity_lookahead),
            "deviceResident": bool(kcfg.device_resident),
            "dispatchesTotal": int(
                self.controller.warm.drain_dispatches_total
            ),
            "deviceRoundtripsTotal": int(
                self.controller.warm.drain_device_roundtrips_total
            ),
        }
        if self.controller.warm.last_stream:
            doc["lastStream"] = dict(self.controller.warm.last_stream)
        if self.controller.warm.last_drain:
            doc["lastDrain"] = dict(self.controller.warm.last_drain)
        # Serving-path host-stage split of the last solve pass (encode /
        # solve / decode wall seconds) — the per-tick slice of the drain's
        # host-stage ledger.
        if self.controller.last_host_stages:
            doc["hostStages"] = dict(self.controller.last_host_stages)
        # Where the solves run and the kernel launches this process has made,
        # by variant: the port's own section (the JAX package has none).
        doc["device"] = self.device_status()
        return doc

    def device_status(self) -> dict:
        """{"type": "cuda" | "cpu", "name": the card's name or "cpu",
        "launches": the CUDA kernel launches by variant} for /statusz."""
        from grove_tpu_torch.kernels.place_wave import place_wave

        name = "cpu"
        if self.device.type == "cuda":
            import torch

            index = self.device.index if self.device.index is not None else 0
            name = torch.cuda.get_device_name(index)
        return {"type": self.device.type, "name": name,
                "launches": dict(place_wave.variant_launches)}

    def resilience_status(self) -> dict:
        """JSON-able failure-domain view for /statusz "resilience" and
        `grove-tpu get resilience`: the degradation ladder's breaker states
        and step counters, the fault injector's per-site fire ledger, the
        bind-path hardening counters, the watch reconnect/resync counters,
        and the recorder's counting-drops state."""
        doc: dict = {"enabled": self.resilience_ladder is not None}
        if self.resilience_ladder is not None:
            cfg = self.config.resilience
            doc["watchdogSeconds"] = float(cfg.watchdog_seconds)
            doc["probationSeconds"] = float(cfg.probation_seconds)
            doc["ladder"] = self.resilience_ladder.stats()
        doc["binds"] = dict(self.controller.resilience_counts)
        if self.fault_injector is not None:
            doc["faults"] = self.fault_injector.stats()
        ws = getattr(self._kube_source, "watch_stats", None)
        if ws is not None:
            doc["watch"] = ws()
        if self.trace_recorder is not None:
            doc["recorder"] = {
                "degraded": self.trace_recorder.degraded,
                "writeErrors": self.trace_recorder.write_errors,
            }
        return doc

    def trace_status(self) -> dict:
        """JSON-able flight-recorder state for /statusz "trace"."""
        if self.trace_recorder is None:
            return {"enabled": False}
        return {
            "enabled": True,
            **self.trace_recorder.stats(),
            "healEventsSuppressed": self._heal_dedupe.suppressed,
        }

    def replay_verify(self) -> Optional[dict]:
        """Replay this manager's own journal through the controller's warm
        path and assert bitwise plan equivalence — the in-process
        nondeterminism self-check. Divergences increment
        grove_replay_divergence_total; returns the replay report doc (None
        when tracing is off or the journal is empty). Re-solves every
        journaled wave: an operator action (`grove-tpu trace replay`, tests,
        a canary cron), not a per-reconcile step."""
        if self.trace_recorder is None:
            return None
        from grove_tpu_torch.trace.recorder import read_journal
        from grove_tpu_torch.trace.replay import replay_journal

        self.trace_recorder.flush()
        try:
            records = read_journal(self.trace_recorder.path)
        except FileNotFoundError:
            return None
        report = replay_journal(records, warm_path=self.controller.warm, device=self.device)
        if report.divergence_count:
            self._m_replay_divergence.inc(float(report.divergence_count))
            self.log.error(
                "replay divergence: solver nondeterminism regression",
                divergences=report.divergence_count,
            )
        return report.to_doc()

    def _kube_ctx(self):
        """Memoized kube connection material (shared by the lease and the
        watch source so both target the same cluster/namespace)."""
        if getattr(self, "_kube_ctx_cache", None) is None:
            from grove_tpu_torch.cluster.kubernetes import load_kube_context

            cfg = self.config.cluster
            self._kube_ctx_cache = load_kube_context(
                cfg.kubeconfig or None,
                cfg.kube_context or None,
                cfg.kube_namespace or None,
            )
        return self._kube_ctx_cache

    def _build_device_code(self) -> None:
        """Build what the solves run before anything serves: the CUDA
        kernels (on the card) and the C renderer of the flight recorder,
        into grove_tpu_torch/_build/. A failed build raises: there is no
        fallback to the plain versions."""
        from grove_tpu_torch.kernels import build
        from grove_tpu_torch.utils import serde

        t0 = time.perf_counter()
        built = []
        if self.device.type == "cuda":
            build.compile_source("place_wave")
            built.append("place_wave")
        if self.trace_recorder is not None:
            serde.load_renderer()
            built.append("serde_render")
        if built:
            self.log.info(
                "device code built",
                modules=",".join(built),
                seconds=round(time.perf_counter() - t0, 3),
            )

    def start(self) -> None:
        """Start servers + background loops (mgr.Start analog); idempotent."""
        if self._started:
            return
        cfg = self.config
        # The port's counterpart of the persistent XLA compilation cache:
        # the kernels build into _build/ (keyed by a digest of source and
        # flags, so a restart loads them), before the first solve.
        self._build_device_code()
        # Warm-path startup: record solver shape buckets to the history file
        # and prewarm the top-K historical ones on a background thread, so
        # the first solve_pending after a restart never blocks on XLA (the
        # persistent compile cache above makes those prewarm compiles disk
        # loads after the first boot on a machine).
        if cfg.solver.shape_history_path:
            self.controller.warm.executables.history_path = (
                cfg.solver.shape_history_path
            )
        if cfg.solver.prewarm_top_k > 0:
            # Non-daemon + stop-event-aware (a daemon thread killed inside an
            # XLA compile at interpreter exit aborts the process); stop()
            # joins it, waiting out at most one in-flight compile.
            self._prewarm_thread = self.controller.warm.executables.start_prewarm_thread(
                cfg.solver.prewarm_top_k, stop=self._stop, device=self.device
            )
            if self._prewarm_thread is not None:
                self.log.info(
                    "solver prewarm started", top_k=cfg.solver.prewarm_top_k
                )
        if self.trace_recorder is not None:
            # Flight-recorder writer thread (bounded queue drains to atomic
            # journal segments); stop() joins it after a final flush.
            self.trace_recorder.start()
            self.log.info("trace recorder started", path=cfg.trace.path)
        if self.fault_injector is not None:
            # Process-wide install: the named sites (solver dispatch, bind
            # commit, kube wire, watch stream, recorder writes) all consult
            # faults.active(). stop() clears it.
            from grove_tpu_torch import faults as faults_mod

            faults_mod.install(self.fault_injector)
            self.log.info(
                "FAULT INJECTION ACTIVE",
                sites=",".join(sorted(self.fault_injector.specs)),
                seed=self.fault_injector.seed,
            )
        if cfg.leader_election.enabled:
            if cfg.cluster.source == "kubernetes":
                # Apiserver-backed Lease: the only store EVERY replica of a
                # k8s Deployment can see — a file lease would leave two
                # active managers on separate filesystems (the reference's
                # election is apiserver-backed too, types.go:73-104).
                from grove_tpu_torch.cluster.kubernetes import KubeLease

                self._lease = KubeLease(
                    self._kube_ctx(),
                    lease_duration_seconds=cfg.leader_election.lease_duration_seconds,
                    renew_deadline_seconds=cfg.leader_election.renew_deadline_seconds,
                )
            else:
                self._lease = FileLease(
                    path=cfg.leader_election.lease_file,
                    lease_duration_seconds=cfg.leader_election.lease_duration_seconds,
                    renew_deadline_seconds=cfg.leader_election.renew_deadline_seconds,
                )
            self._is_leader = self._lease.try_acquire()
        self._m_leader.set(1.0 if self._is_leader else 0.0)
        if cfg.cells.enabled:
            # Cellular control plane: partition along QueueTree root-subtree
            # seams (shard_by queue; "topology" leaves queues unpinned) and
            # acquire one named lease per cell — independent renewal clocks,
            # so one stalled cell stands down alone (runtime/lease.LeaseSet).
            from grove_tpu_torch.cells import partition_tree
            from grove_tpu_torch.runtime.lease import LeaseSet

            tree = (
                self.controller.queue_tree
                if cfg.cells.shard_by == "queue"
                else None
            )
            self.cell_plan = partition_tree(tree, cfg.cells.count)
            self.cell_leases = LeaseSet(
                cfg.cells.lease_dir,
                lease_duration_seconds=cfg.cells.lease_duration_seconds,
                renew_deadline_seconds=cfg.cells.renew_deadline_seconds,
            )
            self._m_cell_count.set(float(len(self.cell_plan.cells)))
            for cell_name in self.cell_plan.cells:
                held = self.cell_leases.try_acquire(cell_name)
                self._m_cell_lease_held.set(1.0 if held else 0.0, cell=cell_name)
                self._m_cell_queues.set(
                    float(len(self.cell_plan.queues_of(cell_name))), cell=cell_name
                )
            self.log.info(
                "cellular control plane enabled",
                cells=len(self.cell_plan.cells),
                shardBy=cfg.cells.shard_by,
                journalRoot=cfg.cells.journal_root,
            )

        if cfg.servers.health_port >= 0:
            self.health_port = self._serve_http(cfg.servers.health_port)
        if cfg.servers.metrics_port >= 0:
            # Dedicated metrics bind (manager.go:94-96); same handler class,
            # so /metrics is the canonical path on this port.
            self.metrics_port = self._serve_http(cfg.servers.metrics_port)
        if cfg.servers.webhook_port >= 0:
            self.webhook_port = self._serve_webhook(cfg.servers.webhook_port)
        if cfg.backend.enabled:
            from grove_tpu_torch.backend.service import create_server

            # create_server builds AND starts the gRPC server; the solver
            # section configures its bucketing + portfolio defaults.
            self._backend_server, self.backend_port = create_server(
                port=cfg.backend.port,
                max_workers=cfg.backend.max_workers,
                solver_config=cfg.solver,
                priority_classes=cfg.scheduling.priority_classes,
                metrics=self.metrics,  # sidecar solves surface on /metrics
                device=self.device,
            )
            self.log.info("backend sidecar listening", port=self.backend_port)
        if cfg.persistence.enabled:
            from grove_tpu_torch.runtime.persistence import StatePersistence

            self.persistence = StatePersistence(
                cfg.persistence.path,
                snapshot_interval_seconds=cfg.persistence.snapshot_interval_seconds,
            )
            restored = self.persistence.restore(self.cluster)
            if restored:
                self.log.info("restored control-plane state", path=cfg.persistence.path)
        if cfg.cluster.source in ("kwok", "kubernetes"):
            # External fleets flow in through the watch path. Nodes also
            # forward to the backend sidecar when it is hosted here, so
            # external Solve RPCs see the same fleet.
            backend_client = None
            if self.backend_port is not None:
                from grove_tpu_torch.backend.client import BackendClient

                backend_client = BackendClient(f"127.0.0.1:{self.backend_port}")
                # Manager-created, so manager-closed at stop(); a client the
                # CALLER passed to attach_watch stays the caller's to close.
                self._owned_backend_client = backend_client
        if cfg.cluster.source == "kwok":
            # Config-fabricated KWOK fleet — the binary is then a
            # self-contained e2e rig (kind-up.sh KWOK analog).
            from grove_tpu_torch.cluster.kwok import kwok_fleet_from_config

            # Fabricated at now=0.0 so the bootstrap node events are visible
            # to the first pump under BOTH clocks: production's wall time and
            # the tests' virtual time (reconcile_once(now=0.0)).
            fleet = kwok_fleet_from_config(
                cfg.cluster, cfg.cluster_topology(), now=0.0
            )
            self.attach_watch(fleet, backend=backend_client)
            self.log.info("kwok fleet attached", nodes=cfg.cluster.kwok_nodes)
        elif cfg.cluster.source == "kubernetes":
            # Live apiserver via the list/watch wire protocol; solver
            # placements go back as pod creates + binding subresource POSTs
            # (cluster/kubernetes.py).
            from grove_tpu_torch.cluster.kubernetes import (
                KubernetesWatchSource,
                render_pod_manifest,
            )

            ctx = self._kube_ctx()

            def _manifest(name: str):
                pod = self.cluster.pods.get(name)
                return render_pod_manifest(pod) if pod is not None else None

            source = KubernetesWatchSource(
                ctx,
                pod_label_selector=cfg.cluster.pod_label_selector or None,
                pod_manifest_for=_manifest,
                watch_workloads=cfg.cluster.watch_workloads,
                initc_kube_tokens=cfg.cluster.initc_mode == "kubernetes",
                qps=cfg.cluster.kube_qps,
                burst=cfg.cluster.kube_burst,
                # Bind retry + shared backoff pacing (resilience.* block):
                # in-call decorrelated-jitter retries on the bind push; the
                # WatchDriver's cross-tick retry set remains the outer loop.
                bind_retry_attempts=(
                    cfg.resilience.bind_max_attempts
                    if cfg.resilience.enabled
                    else 1
                ),
                backoff_base_s=cfg.resilience.backoff_base_seconds,
                backoff_cap_s=cfg.resilience.backoff_cap_seconds,
            )
            source.start()
            self._kube_source = source
            # Startup topology sync (clustertopology.go:39-51): publish the
            # config's ClusterTopology as a CR so cluster users can kubectl
            # get it; best-effort — a CRD-less cluster just logs.
            if not source.sync_cluster_topology(self.topology):
                self.log.info("ClusterTopology CR sync unavailable")
            if self.webhook_port is not None:
                # Complete the webhook configs deploy rendered with an empty
                # caBundle (the cert-controller rotator analog). Failure is
                # NOT terminal here — reconcile_once retries until it lands
                # (failurePolicy Fail means an unpatched config is a
                # cluster-wide PCS write outage).
                ca = self.webhook_ca_bundle()
                self._webhook_ca_pending = ca is None or not source.sync_webhook_ca(ca)
                if self._webhook_ca_pending:
                    self.log.error(
                        "webhook caBundle patch failed; retrying each reconcile"
                    )
            driver = self.attach_watch(source, backend=backend_client)
            # Workload CRs from the apiserver (kubectl apply -> watch ->
            # admission -> store; SURVEY §3.2-3.3) — the same chain the
            # HTTP apply path runs, so watch events can't bypass admission.
            driver.workload_sink = self._apply_workload_event
            driver.child_scale_sink = self._apply_child_scale_event
            self.log.info(
                "kubernetes cluster attached",
                server=ctx.server,
                namespace=ctx.namespace,
            )
        # Accelerator preflight AFTER the cluster source attached: a boot
        # that promises auto-slice injection against a fleet with no slice
        # resource anywhere must fail HERE, not strand gangs at solve time.
        self._accelerator_preflight()
        self._started = True
        self.log.info(
            "manager started",
            leader=self._is_leader,
            health_port=self.health_port,
            backend_port=self.backend_port,
            webhook_port=self.webhook_port,
        )

    def _accelerator_preflight(self) -> None:
        """Hard boot-time failure when networkAcceleration.autoSliceEnabled
        is set but no visible node exposes the slice resource — the MNNVL
        preflight analog (a GPU fleet without ComputeDomains fails the
        operator boot rather than silently scheduling nothing). Sources
        whose nodes only arrive later (externally-fed store with nothing in
        it yet, apiserver momentarily unreachable) skip: there is nothing
        visible to falsify, and the knob stays honest once nodes flow in."""
        na = self.config.network_acceleration
        if not na.auto_slice_enabled:
            return
        res = na.slice_resource_name
        caps: list | None = None
        if self.config.cluster.source == "kwok" and self.watch is not None:
            # The fabricated fleet's bootstrap events sit at t=0 (see
            # start()); pumping them in makes the fleet inspectable now.
            self.watch.pump(0.0)
            caps = [n.capacity for n in self.cluster.nodes.values()]
        elif self._kube_source is not None:
            caps = self._kube_source.list_node_capacities()
        elif self.cluster.nodes:
            caps = [n.capacity for n in self.cluster.nodes.values()]
        if not caps:
            return
        if not any(float(c.get(res, 0) or 0) > 0 for c in caps):
            raise RuntimeError(
                "networkAcceleration.autoSliceEnabled: no visible node "
                f"exposes the slice resource {res!r} ({len(caps)} nodes "
                "checked) — fix the fleet's device plugin or disable "
                "autoSliceEnabled"
            )

    def _bind_server(
        self, port: int, handler_base: type, tls_paths: Optional[tuple[str, str]]
    ) -> int:
        """Bind + start one HTTP(S) server: the single copy of the
        socket-wrap/bookkeeping logic both surfaces share."""
        import ssl

        cfg = self.config.servers
        handler = type("Handler", (handler_base,), {"manager": self})
        server = http.server.ThreadingHTTPServer((cfg.bind_address, port), handler)
        if tls_paths is not None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(*tls_paths)
            # Handshake lazily in the per-connection handler thread
            # (do_handshake_on_connect=False): a slow client must not park
            # the accept loop and starve /healthz for everyone else.
            server.socket = ctx.wrap_socket(
                server.socket, server_side=True, do_handshake_on_connect=False
            )
        self._http_servers.append(server)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        return server.server_address[1]

    def _serve_http(self, port: int) -> int:
        cfg = self.config.servers
        if cfg.tls_mode != "disabled" and self._tls_paths is None:
            # Cert management (cert.go:46-98 analog): certs are ensured
            # BEFORE the port binds — a CertError fails the boot without
            # leaking a bound socket, and nothing ever serves plaintext.
            from grove_tpu_torch.runtime.certs import ensure_serving_certs

            self._tls_paths = ensure_serving_certs(
                cfg.tls_mode,
                cfg.tls_cert_dir,
                cert_file=cfg.tls_cert_file,
                key_file=cfg.tls_key_file,
            )
        tls = self._tls_paths if cfg.tls_mode != "disabled" else None
        return self._bind_server(port, _ProbeHandler, tls)

    def _serve_webhook(self, port: int) -> int:
        """The dedicated AdmissionReview server. Always HTTPS — the
        apiserver refuses plaintext webhooks — with certs independent of
        the API surface's tlsMode: manual reuses its files, anything else
        self-signs into tlsCertDir/webhook with the configured SANs (the
        cert-controller rotator analog, cert.go:66-93)."""
        import os as _os

        from grove_tpu_torch.runtime.certs import ensure_serving_certs

        cfg = self.config.servers
        if self._webhook_tls_paths is None:
            if cfg.tls_mode == "manual":
                self._webhook_tls_paths = ensure_serving_certs(
                    "manual",
                    cfg.tls_cert_dir,
                    cert_file=cfg.tls_cert_file,
                    key_file=cfg.tls_key_file,
                )
                if not cfg.tls_ca_file:
                    # A CA-issued leaf without tlsCaFile would be patched
                    # into caBundle as a trust root the apiserver cannot
                    # chain — with failurePolicy Fail that is a silent
                    # cluster-wide PCS write outage. Fail the boot instead.
                    _require_self_signed(cfg.tls_cert_file)
            else:
                self._webhook_tls_paths = ensure_serving_certs(
                    "auto",
                    _os.path.join(cfg.tls_cert_dir, "webhook"),
                    common_name="grove-tpu-webhook",
                    san_dns=tuple(cfg.webhook_sans),
                )
        return self._bind_server(port, _WebhookHandler, self._webhook_tls_paths)

    def operator_users(self) -> frozenset:
        """Identities the authorizer webhook treats as the reconciler
        (handler.go's reconcilerServiceAccountUserName): the in-process
        actor name plus the operator's own in-cluster ServiceAccount
        username (derived from the SA mount when running in a pod, else
        the deploy renderer's default namespace). Static for the process:
        computed once — this sits on the apiserver's failurePolicy-Fail
        admission path."""
        if self._operator_users is None:
            ns = "grove-system"
            try:
                with open(
                    "/var/run/secrets/kubernetes.io/serviceaccount/namespace"
                ) as f:
                    ns = f.read().strip() or ns
            except OSError:
                pass
            from grove_tpu_torch.api.admission import OPERATOR_ACTOR

            self._operator_users = frozenset(
                {OPERATOR_ACTOR, f"system:serviceaccount:{ns}:grove-tpu-operator"}
            )
        return self._operator_users

    def webhook_ca_bundle(self) -> Optional[bytes]:
        """PEM bundle apiserver clients should trust for the webhook server
        — what the boot-time caBundle patch writes into the webhook configs.
        Auto mode: the self-signed serving cert doubles as the CA. Manual
        mode with a CA-issued cert: tlsCaFile names the issuing CA (a leaf
        installed as trust root verifies nothing); without it the manual
        cert is assumed self-signed."""
        if self._webhook_tls_paths is None:
            return None
        cfg = self.config.servers
        src = (
            cfg.tls_ca_file
            if cfg.tls_mode == "manual" and cfg.tls_ca_file
            else self._webhook_tls_paths[0]
        )
        try:
            with open(src, "rb") as f:
                return f.read()
        except OSError as e:
            # Must not escape: start() and the reconcile retry both treat
            # None as "still pending" — an uncaught raise here would kill
            # the run loop instead.
            self.log.error("webhook CA bundle unreadable", path=src, err=str(e))
            return None

    def reconcile_once(self, now: Optional[float] = None) -> FlowOutcome:
        """One full reconcile pass through the flow runner (testable unit).

        Steps mirror the reference's ordered component sync
        (podcliqueset/reconcilespec.go:206-221), expressed as flow.go steps;
        errors land in each PCS's status.last_errors via the recorder.
        """
        now = time.time() if now is None else now
        if self.watch is not None:
            # Same containment discipline as flow steps: a flaky watch source
            # or sidecar must degrade to a retry, never kill the run loop.
            try:
                self.watch.pump(now)
            except Exception as e:  # noqa: BLE001
                self._m_reconcile_errors.inc()
                self.log.error("watch pump failed", err=str(e))
        if self._webhook_ca_pending and self._kube_source is not None:
            # The rendered webhook configs carry failurePolicy Fail: until
            # the caBundle lands, every PCS write in the cluster bounces —
            # so the boot-time patch retries here until it succeeds (the
            # cert-controller rotator reconciles continuously; one-shot
            # best-effort would leave a cluster-wide outage behind an info
            # log).
            ca = self.webhook_ca_bundle()
            if ca is not None and self._kube_source.sync_webhook_ca(ca):
                self._webhook_ca_pending = False
                self.log.info("webhook caBundle patched")
        ctrl = self.controller

        def _timed(name, body):
            def run():
                t = time.perf_counter()
                try:
                    return body()
                finally:
                    rec = self._profile.setdefault(name, {"calls": 0, "seconds": 0.0, "last_seconds": 0.0})
                    dt = time.perf_counter() - t
                    rec["calls"] += 1
                    rec["seconds"] += dt
                    rec["last_seconds"] = dt

            return run

        def _step(name, fn):
            def body():
                fn(now)
                return continue_reconcile()

            return _timed(name, body)

        def _sync_workloads():
            """Expansion in parallel (slow-start, concurrentSyncs workers),
            store mutation serial — the store stays single-writer."""
            pcs_list = list(self.cluster.podcliquesets.values())
            workers = self.config.controllers.concurrent_syncs
            if workers > 1 and len(pcs_list) > 1:
                from random import Random

                from grove_tpu_torch.utils.concurrent import run_concurrently_with_slow_start

                tasks = [
                    (lambda p=pcs: ctrl.compute_desired(p, rng=Random(hash(p.metadata.name) & 0xFFFF)))
                    for pcs in pcs_list
                ]
                results = run_concurrently_with_slow_start(
                    tasks, max_workers=workers, stop_on_error=False
                )
                # Apply every healthy expansion first — one poisoned PCS must
                # not starve the rest — then record failures WITHOUT stopping
                # the flow (continue_reconcile=True): solve/status/termination
                # must still run for the healthy PCSes this pass.
                errors = []
                for r in results:
                    if r.error is not None:
                        errors.append(
                            GroveError(
                                code="ERR_SYNC_RESOURCE",
                                operation="sync_workloads",
                                message=f"{pcs_list[r.index].metadata.name}: {r.error}",
                                cause=r.error,
                            )
                        )
                        continue
                    ctrl.sync_workload(pcs_list[r.index], now, desired=r.value)
                if errors:
                    return ReconcileStepResult(
                        continue_reconcile=True,
                        requeue_after_seconds=5.0,
                        errors=errors,
                    )
            else:
                for pcs in pcs_list:
                    ctrl.sync_workload(pcs, now)
            return continue_reconcile()

        def _solve():
            ctrl.solve_pending(now)
            return continue_reconcile()

        def _record(errors):
            msgs = [str(e) for e in errors]
            for pcs in self.cluster.podcliquesets.values():
                pcs.status.last_errors = list(msgs)

        t0 = time.perf_counter()
        def _autoscale(now=now):
            # metrics-server analog: utilization pushed to /api/v1/metrics
            # feeds the HPA objects; scale_overrides land in the NEXT
            # sync_workloads expansion (HPA -> scale subresource flow).
            # Consume-once: the ratio scales the CURRENT replica count, so
            # re-applying one stale push every tick would compound
            # geometrically to max/min replicas — each push is one
            # evaluation, like HPA refusing to act on stale metrics.
            if self.hpa_metrics:
                # Atomic swap, not copy-then-clear: an HTTP push landing
                # between the two would be 200-acknowledged yet discarded.
                self.hpa_metrics, metrics = {}, self.hpa_metrics
                ctrl.autoscale(metrics, now)
            return continue_reconcile()

        steps = [
            ("autoscale", _timed("autoscale", _autoscale)),
            ("sync_workloads", _timed("sync_workloads", _sync_workloads)),
            ("rolling_updates", _step("rolling_updates", ctrl.rolling_updates)),
            ("solve_pending", _timed("solve_pending", _solve)),
            ("update_statuses", _step("update_statuses", ctrl.update_statuses)),
            ("gang_termination", _step("gang_termination", ctrl.gang_termination)),
            # Defrag background loop (config section `defrag`): interval-
            # gated inside maybe_defrag, so this runs as a cheap no-op on
            # every other pass and a score/plan/execute cycle when due.
            ("defrag", _step("defrag", ctrl.maybe_defrag)),
        ]
        if self.trace_recorder is not None:
            # Trace flow step: nudge the writer to persist this pass's
            # records now — journal staleness is then bounded by the
            # reconcile cadence, not only the flush interval (a crashed
            # operator loses at most one pass of decisions).
            steps.append(
                ("trace", _step("trace", lambda _now: self.trace_recorder.request_flush()))
            )
        outcome = run_reconcile_flow(steps, error_recorder=_record)
        self._m_reconciles.inc()
        self._m_reconcile_seconds.observe(time.perf_counter() - t0)
        if outcome.has_errors:
            self._m_reconcile_errors.inc(len(outcome.errors))
            for e in outcome.errors:
                self.log.error("reconcile step failed", step=e.operation, err=str(e))
        # last_admission_scores is the ground truth of first admissions this
        # pass (both waves; solve_pending's int return counts the floors wave
        # only) — driving BOTH metrics from it keeps
        # grove_gangs_admitted_total == grove_placement_score_count by
        # construction, even when an extras wave first-admits a gang whose
        # floor was already met (stale-status edge).
        if ctrl.last_admission_scores:
            self._m_gangs_admitted.inc(len(ctrl.last_admission_scores))
            for score in ctrl.last_admission_scores:
                self._m_placement_score.observe(score)
            # Consume-once: a later pass that short-circuits before
            # solve_pending (which resets the list) must not re-observe.
            ctrl.last_admission_scores = []
        self._next_requeue = outcome.requeue_after_seconds
        for kind, count in self.controller.solve_pass_counts.items():
            delta = count - self._solve_passes_exported[kind]
            if delta > 0:
                self._m_solve_passes.inc(float(delta), kind=kind)
                self._solve_passes_exported[kind] = count
        if self.controller.defrag_enabled:
            last = self.controller.defrag_last
            if last:
                self._m_frag_score.set(float(last.get("score", 0.0)))
                for entry in last.get("report", {}).get("levels", []):
                    self._m_frag_stranded.set(
                        float(entry.get("stranded", 0.0)),
                        level=str(entry.get("level", "")),
                        resource=str(entry.get("resource", "")),
                    )
            self._m_defrag_migrating.set(
                float(len(self.controller._defrag_migrating))
            )
            counts = self.controller.defrag_counts
            for key, metric in (
                ("plans", self._m_defrag_plans),
                ("migrations", self._m_defrag_migrations),
                ("pods_migrated", self._m_defrag_pods),
            ):
                delta = counts[key] - self._defrag_exported[key]
                if delta > 0:
                    metric.inc(float(delta))
                    self._defrag_exported[key] = counts[key]
        for key, metric in (
            ("cutovers", self._m_rollout_cutovers),
            ("retries", self._m_rollout_retries),
            ("fallbacks", self._m_rollout_fallbacks),
        ):
            delta = self.controller.rollout_counts[key] - self._rollout_exported[key]
            if delta > 0:
                metric.inc(float(delta))
                self._rollout_exported[key] = self.controller.rollout_counts[key]
        self._m_rollout_replacing.set(
            float(len(self.controller._rollout_replacing))
        )
        for key, metric in (
            ("notices", self._m_revocation_notices),
            ("migrated", self._m_revocation_migrated),
            ("evicted", self._m_revocation_evicted),
        ):
            delta = (
                self.controller.revocation_counts[key]
                - self._revocation_exported[key]
            )
            if delta > 0:
                metric.inc(float(delta))
                self._revocation_exported[key] = self.controller.revocation_counts[key]
        if self.controller.tenancy_enabled:
            ledger = self.controller.tenancy_ledger
            for key, metric in (
                ("admitted", self._m_tenancy_admitted),
                ("admitted_borrowing", self._m_tenancy_borrowed),
                ("preemptions", self._m_tenancy_preemptions),
                ("reclaims", self._m_tenancy_reclaims),
                ("reclaim_deferred", self._m_tenancy_reclaim_deferred),
                ("aging_boosts", self._m_tenancy_aging),
            ):
                delta = ledger.totals[key] - self._tenancy_exported[key]
                if delta > 0:
                    metric.inc(float(delta))
                    self._tenancy_exported[key] = ledger.totals[key]
            self._m_tenancy_tenants.set(float(len(ledger.tenants)))
            self._m_tenancy_disrupted.set(
                float(self.controller.disrupted_now())
            )
        prune = self.controller.warm.prune
        self._m_candidate_nodes.set(float(prune.last_candidate_nodes))
        delta = prune.escalations - self._prune_escalations_exported
        if delta > 0:
            self._m_candidate_escalations.inc(float(delta))
            self._prune_escalations_exported = prune.escalations
        try:
            from grove_tpu_torch.parallel.mesh import shard_fallbacks

            sf = shard_fallbacks()
            if sf > self._shard_fallbacks_exported:
                self._m_shard_fallbacks.inc(
                    float(sf - self._shard_fallbacks_exported)
                )
                self._shard_fallbacks_exported = sf
        except Exception:  # noqa: BLE001 — metrics must never break reconcile
            pass
        warm = self.controller.warm
        delta = warm.drain_device_roundtrips_total - self._roundtrips_exported
        if delta > 0:
            self._m_drain_roundtrips.inc(float(delta))
            self._roundtrips_exported = warm.drain_device_roundtrips_total
        delta = warm.drain_dispatches_total - self._dispatches_exported
        if delta > 0:
            self._m_drain_dispatches.inc(float(delta))
            self._dispatches_exported = warm.drain_dispatches_total
        if warm.last_stream:
            self._m_stream_depth.set(float(warm.last_stream.get("depth", 0)))
            self._m_stream_gps.set(
                float(warm.last_stream.get("gangsPerSec", 0.0))
            )
        # Host-stage ledger gauges, cut from the last recorded run (streams
        # take precedence when both surfaces are populated — the always-on
        # serving shape; drain_backlog fills last_drain in batch recovery).
        stage_src = warm.last_stream or warm.last_drain
        if stage_src:
            for stage, key in (
                ("encode", "hostEncodeS"),
                ("prefilter", "hostPrefilterS"),
                ("dispatch", "hostDispatchS"),
                ("harvest", "hostHarvestS"),
                ("decode", "hostDecodeS"),
                ("bind", "hostBindS"),
                ("journal", "hostJournalS"),
                ("total", "hostTotalS"),
                ("hotPath", "hostHotPathS"),
            ):
                if key in stage_src:
                    self._m_host_stage.set(
                        float(stage_src[key]), stage=stage
                    )
        samples = warm.stream_bind_samples
        if samples:
            # Drain-once: the deque is the warm path's hand-off buffer; each
            # sample lands in the histogram exactly once.
            while True:
                try:
                    self._m_stream_ttb.observe(samples.popleft())
                except IndexError:
                    break
        quality = self.controller.quality_last
        if quality:
            self._m_quality_admitted_ratio.set(
                float(quality.get("admittedRatio", 0.0))
            )
            self._m_quality_score.set(
                float(quality.get("meanPlacementScore", 0.0))
            )
            self._m_quality_pref.set(
                float(quality.get("preferredFraction", 0.0))
            )
        # Bounded-ring + flight-recorder counters (delta-exported, same
        # discipline as the solve-pass and defrag counters).
        delta = self.cluster.events_dropped - self._events_dropped_exported
        if delta > 0:
            self._m_events_dropped.inc(float(delta))
            self._events_dropped_exported = self.cluster.events_dropped
        if self.trace_recorder is not None:
            for key, metric in (
                ("recorded", self._m_trace_records),
                ("dropped", self._m_trace_dropped),
            ):
                cur = getattr(self.trace_recorder, key)
                delta = cur - self._trace_exported[key]
                if delta > 0:
                    metric.inc(float(delta))
                    self._trace_exported[key] = cur
        limiter = getattr(self._kube_source, "limiter", None)
        if limiter is not None:
            delta = limiter.throttled - self._kube_throttled_exported
            if delta > 0:
                self._m_kube_throttled.inc(float(delta))
                self._kube_throttled_exported = limiter.throttled
        # Failure-domain counters (ladder, injector, bind path, watch,
        # recorder) — delta-exported like every other monotonic source.
        if self.resilience_ladder is not None:
            for subsystem, counts in self.resilience_ladder.counters().items():
                prev = self._degradation_exported.setdefault(
                    subsystem, {"stepDowns": 0, "stepUps": 0}
                )
                for key, metric in (
                    ("stepDowns", self._m_degradation_down),
                    ("stepUps", self._m_degradation_up),
                ):
                    delta = counts[key] - prev[key]
                    if delta > 0:
                        metric.inc(float(delta), subsystem=subsystem)
                        prev[key] = counts[key]
        if self.fault_injector is not None:
            fired = self.fault_injector.total_fired()
            if fired > self._faults_exported:
                self._m_faults_injected.inc(float(fired - self._faults_exported))
                self._faults_exported = fired
        rc = self.controller.resilience_counts
        for key, metric in (
            ("bind_rollbacks", self._m_bind_rollbacks),
            ("stale_plan_requeues", self._m_stale_requeues),
            ("solve_degraded_retries", self._m_solve_degraded),
        ):
            delta = rc[key] - self._resilience_exported[key]
            if delta > 0:
                metric.inc(float(delta))
                self._resilience_exported[key] = rc[key]
        watch_stats = getattr(self._kube_source, "watch_stats", None)
        if watch_stats is not None:
            wstats = watch_stats()
            for key, metric in (
                ("reconnects", self._m_watch_reconnects),
                ("resyncs", self._m_watch_resyncs),
                ("bindRetries", self._m_bind_push_retries),
            ):
                delta = wstats[key] - self._watch_exported[key]
                if delta > 0:
                    metric.inc(float(delta))
                    self._watch_exported[key] = wstats[key]
        if self.trace_recorder is not None:
            we = self.trace_recorder.write_errors
            if we > self._recorder_write_errors_exported:
                self._m_recorder_write_errors.inc(
                    float(we - self._recorder_write_errors_exported)
                )
                self._recorder_write_errors_exported = we
        qtree = self.controller.queue_tree
        if qtree is not None:
            # Per-queue usage gauges (GREP-244 metrics direction): refreshed
            # per pass so /metrics mirrors the quota filter's view — every
            # tree level, usage hierarchical (a parent includes its
            # descendants). Every series ever emitted is re-set each pass
            # (zero when usage is gone) — gauges are persistent, so
            # skip-when-absent would freeze a drained queue at its last
            # nonzero value forever.
            husage = qtree.hierarchical_usage(self.controller.queue_usage())
            for qname, spec in qtree.specs.items():
                keys = set(spec.resources) | set(husage.get(qname, {}))
                self._queue_metric_keys.setdefault(qname, set()).update(keys)
                for rname in self._queue_metric_keys[qname]:
                    self._m_queue_used.set(
                        husage.get(qname, {}).get(rname, 0.0),
                        queue=qname,
                        resource=rname,
                    )
        if self.watch is not None:
            try:
                self.watch.push(now)
            except Exception as e:  # noqa: BLE001
                self._m_reconcile_errors.inc()
                self.log.error("watch push failed", err=str(e))
        if self.persistence is not None:
            self.persistence.maybe_snapshot(self.cluster, now)
        return outcome

    def run(self, stop_after_seconds: Optional[float] = None) -> None:
        """The hot loop: lease renewal + periodic reconcile until stopped."""
        self.start()
        cfg = self.config
        deadline = (
            time.time() + stop_after_seconds if stop_after_seconds is not None else None
        )
        while not self._stop.is_set():
            now = time.time()
            if deadline is not None and now >= deadline:
                break
            if self._lease is not None:
                self._is_leader = self._lease.try_acquire(now)
                self._m_leader.set(1.0 if self._is_leader else 0.0)
            if self.cell_leases is not None:
                # Per-cell renewal, one clock each: a cell that oversleeps
                # its renew deadline stands down alone, the others renew on.
                for cell_name in self.cell_plan.cells:
                    held = self.cell_leases.try_acquire(cell_name, now)
                    self._m_cell_lease_held.set(
                        1.0 if held else 0.0, cell=cell_name
                    )
            if self._is_leader:
                self.reconcile_once(now)
                interval = cfg.controllers.reconcile_interval_seconds
                if self._next_requeue is not None:
                    interval = min(interval, max(0.05, self._next_requeue))
            else:
                # Non-leaders retry acquisition on the retry period, not the
                # reconcile cadence (leaderElection.retryPeriodSeconds).
                interval = cfg.leader_election.retry_period_seconds
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
        if self.fault_injector is not None:
            # Clear the process-wide injector so a later manager (tests run
            # several per process) starts fault-free unless it asks.
            from grove_tpu_torch import faults as faults_mod

            faults_mod.install(None)
        if self.trace_recorder is not None:
            # Final flush + join BEFORE servers go down, so a stop-triggered
            # journal read (tests, postmortems) sees every record.
            self.trace_recorder.stop()
        if getattr(self, "_prewarm_thread", None) is not None:
            self._prewarm_thread.join()
            self._prewarm_thread = None
        if self._kube_source is not None:
            self._kube_source.stop()
            self._kube_source = None
        if self._owned_backend_client is not None:
            self._owned_backend_client.close()
            self._owned_backend_client = None
        if self._backend_server is not None:
            self._backend_server.stop(grace=1.0)
        for server in self._http_servers:
            server.shutdown()
        if self._lease is not None:
            self._lease.release()
        if self.cell_leases is not None:
            self.cell_leases.release_all()
        if self.persistence is not None:
            self.persistence.snapshot(self.cluster)
        self.log.info("manager stopped")
