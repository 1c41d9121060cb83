"""Deployment manifest rendering — the Helm-chart analog (L9;
grove_tpu/deploy.py counterpart).

The reference ships a Helm chart (`operator/charts/templates/*.yaml`:
deployment, services, RBAC, priorityclass, operator ConfigMap). This module
renders the equivalent Kubernetes manifests for the GPU stack straight from
a validated OperatorConfiguration, so one config file is both the runtime
input and the deployment source of truth:

    python -m grove_tpu_torch.deploy --config examples/operator-config.yaml [--out dir]

Rendered objects: Namespace, ConfigMap (the operator config, mounted at
/etc/grove/config.yaml), operator ServiceAccount + minimal RBAC, Deployment
(manager container, `python -m grove_tpu_torch.runtime`, with one NVIDIA card
as its limit: the port's manager solves on the card and refuses to start
without one; the scheduler-backend sidecar runs in-process when
backend.enabled — GREP-375's sidecar model), and Services for the
health/metrics/backend ports.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys

import yaml

from grove_tpu_torch.runtime.config import OperatorConfiguration, load_operator_config

APP = "grove-tpu-operator"
IMAGE = "grove-tpu/operator:latest"
# The extended resource the NVIDIA device plugin advertises: the manager
# container's one card.
GPU_RESOURCE = "nvidia.com/gpu"


def render_crd() -> dict:
    """The PodCliqueSet CustomResourceDefinition (reference: generated CRDs
    in `operator/api/core/v1alpha1/crds/`, shipped by the chart).

    Deliberately a STRUCTURAL schema with preserve-unknown-fields rather
    than a generated 10k-line OpenAPI dump: validation authority lives in
    the operator's admission chain (api/validation.py), which the CR watch
    runs for every object — the apiserver schema only needs to admit the
    shape. Status and scale subresources mirror the reference
    (`podcliqueset.go:27`): scale points at spec.replicas/status.replicas
    with status.selector for HPA compatibility."""
    preserve = {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "podcliquesets.grove.io", "labels": _labels()},
        "spec": {
            "group": "grove.io",
            "names": {
                "kind": "PodCliqueSet",
                "listKind": "PodCliqueSetList",
                "plural": "podcliquesets",
                "singular": "podcliqueset",
                "shortNames": ["pcs"],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": "v1alpha1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": preserve,
                                "status": preserve,
                            },
                        }
                    },
                    "subresources": {
                        "status": {},
                        "scale": {
                            "specReplicasPath": ".spec.replicas",
                            "statusReplicasPath": ".status.replicas",
                            "labelSelectorPath": ".status.selector",
                        },
                    },
                    "additionalPrinterColumns": [
                        {
                            "name": "Available",
                            "type": "integer",
                            "jsonPath": ".status.availableReplicas",
                        },
                        {
                            "name": "Age",
                            "type": "date",
                            "jsonPath": ".metadata.creationTimestamp",
                        },
                    ],
                }
            ],
        },
    }


def render_child_crds() -> list[dict]:
    """PodClique + PodCliqueScalingGroup CRDs: the operator-owned child
    objects are projected to the apiserver as CRs with live status
    (`kubectl get pclq,pcsg` — the reference materializes the same kinds).
    Status is operator-owned, but spec.replicas via the SCALE subresource is
    a public surface (reference: HPA ScaleTargetRef targets PCLQ/PCSG scale,
    components/hpa/hpa.go:249-259): the operator watches these CRs and turns
    external replica writes into the same scale path its own HPA step and
    the CLI scale verb use — so `kubectl scale pclq/pcsg` and cluster HPAs
    work."""
    preserve = {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    out = []
    for kind, plural, singular, short in (
        ("PodClique", "podcliques", "podclique", "pclq"),
        (
            "PodCliqueScalingGroup",
            "podcliquescalinggroups",
            "podcliquescalinggroup",
            "pcsg",
        ),
    ):
        out.append(
            {
                "apiVersion": "apiextensions.k8s.io/v1",
                "kind": "CustomResourceDefinition",
                "metadata": {"name": f"{plural}.grove.io", "labels": _labels()},
                "spec": {
                    "group": "grove.io",
                    "names": {
                        "kind": kind,
                        "listKind": f"{kind}List",
                        "plural": plural,
                        "singular": singular,
                        "shortNames": [short],
                    },
                    "scope": "Namespaced",
                    "versions": [
                        {
                            "name": "v1alpha1",
                            "served": True,
                            "storage": True,
                            "schema": {
                                "openAPIV3Schema": {
                                    "type": "object",
                                    "properties": {
                                        "spec": preserve,
                                        "status": preserve,
                                    },
                                }
                            },
                            "subresources": {
                                "status": {},
                                "scale": {
                                    "specReplicasPath": ".spec.replicas",
                                    "statusReplicasPath": ".status.replicas",
                                    "labelSelectorPath": ".status.selector",
                                },
                            },
                        }
                    ],
                },
            }
        )
    return out


def render_topology_crd() -> dict:
    """The cluster-scoped ClusterTopology CRD (`grove.io_clustertopologies`
    upstream; name `grove-topology`, short name `ct`) — the operator writes
    it at startup from the config's TAS levels (cluster/kubernetes.py
    sync_cluster_topology)."""
    preserve = {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "clustertopologies.grove.io", "labels": _labels()},
        "spec": {
            "group": "grove.io",
            "names": {
                "kind": "ClusterTopology",
                "listKind": "ClusterTopologyList",
                "plural": "clustertopologies",
                "singular": "clustertopology",
                "shortNames": ["ct"],
            },
            "scope": "Cluster",
            "versions": [
                {
                    "name": "v1alpha1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {"spec": preserve},
                        }
                    },
                }
            ],
        },
    }


def _labels() -> dict:
    return {"app.kubernetes.io/name": APP, "app.kubernetes.io/managed-by": "grove-tpu"}


def render_manifests(
    cfg: OperatorConfiguration,
    config_yaml: str,
    *,
    namespace: str = "grove-system",
    image: str = IMAGE,
    replicas: int | None = None,
) -> list[dict]:
    """OperatorConfiguration -> list of Kubernetes manifest documents."""
    # HA honesty (round-3 finding): leader election protects multi-replica
    # Deployments ONLY when the lease lives somewhere every replica can see.
    # The file lease coordinates one filesystem; in a Deployment each pod has
    # its own, so two replicas would both lead. Only the apiserver-backed
    # lease (cluster.source: kubernetes -> KubeLease) makes replicas>1 safe.
    ha_capable = (
        cfg.leader_election.enabled and cfg.cluster.source == "kubernetes"
    )
    webhook_enabled = cfg.servers.webhook_port >= 0
    if replicas is None:
        replicas = 2 if ha_capable and not webhook_enabled else 1
    elif replicas > 1 and not ha_capable:
        raise ValueError(
            "replicas > 1 requires leaderElection.enabled AND cluster.source: "
            "kubernetes (apiserver-backed lease); the file lease cannot "
            "coordinate pods on separate filesystems"
        )
    if webhook_enabled and replicas > 1:
        # Each replica self-signs its own webhook cert into its container
        # filesystem, but caBundle can only hold one trust root and the
        # webhook Service load-balances across pods — the apiserver would
        # fail TLS on whichever pod lost the boot-time patch race. Until
        # certs are Secret-shared, webhooks mean one replica.
        raise ValueError(
            "servers.webhookPort with replicas > 1 would intermittently fail "
            "apiserver TLS verification (per-pod self-signed webhook certs, "
            "one caBundle); run a single replica or disable the webhook"
        )

    if cfg.servers.bind_address.startswith("127.") or cfg.servers.bind_address in (
        "localhost", "::1",
    ):
        # Probes and Services reach the POD IP; a loopback bind would render
        # manifests whose probes can never connect.
        raise ValueError(
            "servers.bindAddress is loopback; set 0.0.0.0 (or a pod-routable "
            "address) before rendering deployment manifests"
        )
    ports = []
    for name, port, enabled in (
        ("health", cfg.servers.health_port, cfg.servers.health_port >= 0),
        ("metrics", cfg.servers.metrics_port, cfg.servers.metrics_port >= 0),
        ("webhook", cfg.servers.webhook_port, cfg.servers.webhook_port >= 0),
        ("backend", cfg.backend.port, cfg.backend.enabled),
    ):
        if not enabled:
            continue
        if port == 0:
            # 0 = auto-assign, fine for local runs but unroutable in a
            # manifest: probes and Services would point at a port the
            # manager never binds. Fail loudly instead of rendering lies.
            raise ValueError(
                f"{name} port is 0 (auto-assign); set an explicit port in the "
                "config before rendering deployment manifests"
            )
        ports.append({"name": name, "containerPort": port})

    # TLS-enabled managers serve HTTPS on every port; probes must say so or
    # the kubelet handshakes plaintext and the pod never goes Ready.
    probe_scheme = {"scheme": "HTTPS"} if cfg.servers.tls_mode != "disabled" else {}
    # Manual TLS: the cert/key must arrive via a Secret volume; require paths
    # under the mount so the rendered pod can actually read them.
    TLS_MOUNT = "/etc/grove/tls"
    TLS_SECRET = f"{APP}-tls"
    extra_volumes: list[dict] = []
    extra_mounts: list[dict] = []
    if cfg.servers.tls_mode == "manual":
        for label, path in (
            ("tlsCertFile", cfg.servers.tls_cert_file),
            ("tlsKeyFile", cfg.servers.tls_key_file),
        ):
            if not path.startswith(TLS_MOUNT + "/"):
                raise ValueError(
                    f"servers.{label} must live under {TLS_MOUNT} (delivered by "
                    f"Secret {TLS_SECRET!r}) for deployment rendering; got {path!r}"
                )
        extra_volumes.append(
            {"name": "tls", "secret": {"secretName": TLS_SECRET}}
        )
        extra_mounts.append({"name": "tls", "mountPath": TLS_MOUNT, "readOnly": True})

    # Content-addressed ConfigMap: a config change renames the ConfigMap,
    # which changes the pod template, which rolls the Deployment — the
    # checksum-annotation pattern charts use, compatible with immutability.
    config_hash = hashlib.sha256(config_yaml.encode()).hexdigest()[:8]
    configmap_name = f"{APP}-config-{config_hash}"

    if cfg.cluster.source == "kubernetes" and cfg.cluster.initc_mode == "operator":
        # Remote pods run the injected initc against --server: the URL must
        # exist (else pods poll localhost in their own netns), the serving
        # port must actually be enabled, and the scheme must be one the
        # agent can speak (no CA distribution to workload pods yet, so the
        # advertised surface must be plaintext; terminate TLS in front if
        # needed). Each failure here would otherwise be silent gang pods
        # gating until init timeout. initcMode kubernetes escapes ALL of
        # this: the agent talks to the apiserver with the mirrored SA token
        # and the operator URL never enters the pod.
        if cfg.servers.health_port < 0:
            raise ValueError(
                "servers.healthPort must be enabled for cluster.source: "
                "kubernetes deployments — the workload API the injected "
                "grove-initc polls is served there"
            )
        if not cfg.servers.advertise_url:
            raise ValueError(
                "servers.advertiseUrl is required for cluster.source: "
                "kubernetes deployments (the injected grove-initc polls it); "
                f"set e.g. http://{APP}.{namespace}.svc:{cfg.servers.health_port}"
            )
        if cfg.servers.tls_mode != "disabled":
            raise ValueError(
                "cluster.source: kubernetes deployments require servers."
                "tlsMode: disabled for now — the injected grove-initc has no "
                "CA distribution, so an HTTPS workload API would fail cert "
                "verification in every pod; terminate TLS in front of the "
                "operator instead"
            )
        if not cfg.servers.advertise_url.startswith("http://"):
            raise ValueError(
                "servers.advertiseUrl must be a plaintext http:// URL (the "
                "injected grove-initc has no CA material for https)"
            )

    webhook_svc_dns = f"{APP}-webhook.{namespace}.svc"
    if webhook_enabled:
        if cfg.cluster.source != "kubernetes":
            raise ValueError(
                "servers.webhookPort requires cluster.source: kubernetes — "
                "the running operator must patch the rendered webhook "
                "configs' caBundle via the apiserver"
            )
        # NB: rendered webhook certs are always auto-generated — webhooks
        # require cluster.source kubernetes (above), which in turn requires
        # tlsMode disabled (below), so the manual-cert path cannot reach
        # this renderer and webhookSans always governs the real cert.
        if webhook_svc_dns not in cfg.servers.webhook_sans:
            # The apiserver verifies the webhook serving cert against the
            # Service DNS name; a cert without it fails every admission call
            # (failurePolicy Fail => cluster-wide PCS write outage).
            raise ValueError(
                f"servers.webhookSans must include {webhook_svc_dns!r} so the "
                "auto-generated webhook cert verifies against the rendered "
                "Service"
            )

    docs: list[dict] = []
    # PriorityClasses from scheduling.priorityClasses (the chart's
    # priorityclass.yaml analog): cluster-scoped, consumed by pod specs'
    # priorityClassName and the solver's preemption ordering.
    for pc_name, value in sorted(cfg.scheduling.priority_classes.items()):
        docs.append(
            {
                "apiVersion": "scheduling.k8s.io/v1",
                "kind": "PriorityClass",
                "metadata": {"name": pc_name, "labels": _labels()},
                "value": int(value),
                "globalDefault": False,
                "description": "grove-tpu workload priority "
                "(scheduling.priorityClasses)",
            }
        )
    if cfg.cluster.source == "kubernetes":
        # The topology CR is written at startup regardless of the workload
        # watch; its CRD ships with every kubernetes-source deployment.
        docs.append(render_topology_crd())
    if cfg.cluster.source == "kubernetes":
        # Child CR projections (kubectl get pclq,pcsg) ship their CRDs too.
        docs.extend(render_child_crds())
    if cfg.cluster.source == "kubernetes" and cfg.cluster.watch_workloads:
        # The CR watch needs the grove.io CRD installed; ship it with the
        # operator exactly as the reference chart ships its generated CRDs.
        docs.append(render_crd())
    docs += [
        {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {"name": namespace, "labels": _labels()},
        },
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {
                "name": configmap_name,
                "namespace": namespace,
                "labels": _labels(),
            },
            "immutable": True,  # safe: a config change renames the ConfigMap
            "data": {"config.yaml": config_yaml},
        },
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": APP, "namespace": namespace, "labels": _labels()},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "Role",
            "metadata": {"name": APP, "namespace": namespace, "labels": _labels()},
            "rules": [
                {
                    "apiGroups": [""],
                    # pods/binding: the solver's placements land through the
                    # scheduler binding subresource (cluster/kubernetes.py).
                    "resources": ["pods", "pods/binding", "services", "secrets"],
                    "verbs": ["get", "list", "watch", "create", "update", "delete"],
                },
                {
                    "apiGroups": [""],
                    # Control-plane events mirror to corev1 Events
                    # (kubectl get events; publish_events).
                    "resources": ["events"],
                    "verbs": ["create"],
                },
            ]
            + (
                [
                    {
                        # initcMode kubernetes: the operator mirrors per-PCS
                        # SA/Role/RoleBinding so the service-account-token
                        # Secret resolves to a real apiserver credential
                        # (sync_rbac). Escalation-safe: everything granted
                        # is a subset of the operator's own permissions.
                        "apiGroups": [""],
                        "resources": ["serviceaccounts"],
                        "verbs": ["get", "list", "create", "update", "delete"],
                    },
                    {
                        "apiGroups": ["rbac.authorization.k8s.io"],
                        "resources": ["roles", "rolebindings"],
                        "verbs": ["get", "list", "create", "update", "delete"],
                    },
                ]
                if cfg.cluster.initc_mode == "kubernetes"
                else []
            )
            + [
                {
                    "apiGroups": ["grove.io"],
                    # The CR watch + status write-back (status subresource);
                    # delete: an operator-API delete must remove the CR too
                    # or the next relist resurrects the workload. Child CR
                    # projections (podcliques/pcsgs) are created and GC'd by
                    # the operator outright.
                    "resources": [
                        "podcliquesets",
                        "podcliquesets/status",
                        "podcliques",
                        "podcliques/status",
                        "podcliquescalinggroups",
                        "podcliquescalinggroups/status",
                    ],
                    "verbs": [
                        "get", "list", "watch", "create", "update", "patch",
                        "delete",
                    ],
                },
                {
                    "apiGroups": ["coordination.k8s.io"],
                    "resources": ["leases"],
                    # delete: KubeLease.release() removes the lease on
                    # graceful stop so handover is immediate, not a full
                    # leaseDurationSeconds of leaderless downtime.
                    "verbs": ["get", "create", "update", "delete"],
                },
            ],
        },
        {
            # Nodes are cluster-scoped: a namespaced Role cannot grant them
            # (listing them there is silently dead RBAC) — the node watch
            # needs a ClusterRole.
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            # Namespace-qualified: cluster-scoped names collide across
            # installs — a second install must not rewrite the first's
            # binding subjects and revoke its node access.
            "metadata": {"name": f"{APP}-{namespace}-nodes", "labels": _labels()},
            "rules": [
                {
                    "apiGroups": [""],
                    "resources": ["nodes"],
                    "verbs": ["get", "list", "watch"],
                },
                {
                    "apiGroups": ["grove.io"],
                    # Startup topology sync writes this cluster-scoped CR.
                    "resources": ["clustertopologies"],
                    "verbs": ["get", "create", "update"],
                },
            ]
            + (
                [
                    {
                        # Boot-time caBundle patch (sync_webhook_ca): the
                        # configs are cluster-scoped; scope the grant to
                        # exactly our two objects.
                        "apiGroups": ["admissionregistration.k8s.io"],
                        "resources": [
                            "mutatingwebhookconfigurations",
                            "validatingwebhookconfigurations",
                        ],
                        "resourceNames": [APP],
                        "verbs": ["get", "update"],
                    }
                ]
                if webhook_enabled
                else []
            ),
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": f"{APP}-{namespace}-nodes", "labels": _labels()},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": f"{APP}-{namespace}-nodes",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": APP,
                    "namespace": namespace,
                }
            ],
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {"name": APP, "namespace": namespace, "labels": _labels()},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "Role",
                "name": APP,
            },
            "subjects": [
                {"kind": "ServiceAccount", "name": APP, "namespace": namespace}
            ],
        },
        {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": APP, "namespace": namespace, "labels": _labels()},
            "spec": {
                "replicas": replicas,
                "selector": {"matchLabels": {"app.kubernetes.io/name": APP}},
                "template": {
                    "metadata": {"labels": _labels()},
                    "spec": {
                        "serviceAccountName": APP,
                        "containers": [
                            {
                                "name": "manager",
                                "image": image,
                                "command": [
                                    "python",
                                    "-m",
                                    "grove_tpu_torch.runtime",
                                    "--config",
                                    "/etc/grove/config.yaml",
                                ],
                                "resources": {"limits": {GPU_RESOURCE: 1}},
                                "ports": ports,
                                "volumeMounts": [
                                    {"name": "config", "mountPath": "/etc/grove"}
                                ] + extra_mounts,
                                **(
                                    {
                                        "readinessProbe": {
                                            "httpGet": {
                                                "path": "/readyz",
                                                "port": "health",
                                                **probe_scheme,
                                            }
                                        },
                                        "livenessProbe": {
                                            "httpGet": {
                                                "path": "/healthz",
                                                "port": "health",
                                                **probe_scheme,
                                            }
                                        },
                                    }
                                    if cfg.servers.health_port >= 0
                                    else {}
                                ),
                            }
                        ],
                        "volumes": [
                            {
                                "name": "config",
                                "configMap": {"name": configmap_name},
                            }
                        ] + extra_volumes,
                    },
                },
            },
        },
    ]
    if ports:
        docs.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {"name": APP, "namespace": namespace, "labels": _labels()},
                "spec": {
                    "selector": {"app.kubernetes.io/name": APP},
                    "ports": [
                        {
                            "name": p["name"],
                            "port": p["containerPort"],
                            "targetPort": p["name"],
                        }
                        for p in ports
                    ],
                },
            }
        )
    if webhook_enabled:
        docs.extend(
            _render_webhook_objects(namespace, authorizer=cfg.authorizer.enabled)
        )
    return docs


def _render_webhook_objects(namespace: str, authorizer: bool = False) -> list[dict]:
    """The inbound admission surface (webhook/register.go:34-62 analog): a
    dedicated webhook Service on 443 plus Mutating/Validating
    WebhookConfigurations for PodCliqueSet writes. caBundle is left empty;
    the running operator completes it at boot (sync_webhook_ca — the
    cert-controller rotator pattern, cert.go:66-93)."""

    def _client_config(path: str) -> dict:
        return {
            "service": {
                "name": f"{APP}-webhook",
                "namespace": namespace,
                "path": path,
                "port": 443,
            }
        }

    rules = [
        {
            "apiGroups": ["grove.io"],
            "apiVersions": ["v1alpha1"],
            "operations": ["CREATE", "UPDATE"],
            "resources": ["podcliquesets"],
            "scope": "Namespaced",
        }
    ]
    common = {
        "rules": rules,
        "failurePolicy": "Fail",
        "sideEffects": "None",
        "admissionReviewVersions": ["v1"],
        "matchPolicy": "Equivalent",
        "timeoutSeconds": 10,
    }
    return [
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"{APP}-webhook",
                "namespace": namespace,
                "labels": _labels(),
            },
            "spec": {
                "selector": {"app.kubernetes.io/name": APP},
                "ports": [{"name": "webhook", "port": 443, "targetPort": "webhook"}],
            },
        },
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": APP, "labels": _labels()},
            "webhooks": [
                {
                    "name": "defaulting.pcs.grove.io",
                    "clientConfig": _client_config("/webhook/v1/default"),
                    **common,
                }
            ],
        },
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": APP, "labels": _labels()},
            "webhooks": [
                {
                    "name": "validation.pcs.grove.io",
                    "clientConfig": _client_config("/webhook/v1/validate"),
                    **common,
                }
            ]
            + (
                [
                    {
                        # Authorizer webhook (authorization/handler.go:60-135):
                        # only the operator (and exempt actors) may mutate
                        # managed resources. objectSelector scopes the
                        # apiserver's calls to grove-managed objects so an
                        # operator outage cannot block unrelated writes.
                        # Pod DELETE is deliberately NOT registered: the
                        # kubelet's completion deletes and the GC's
                        # owner-reference cascade are system identities no
                        # exempt list could enumerate (the handler also
                        # allows them as defense in depth, handler.go:
                        # 121-124).
                        **common,
                        "name": "authorization.pcs.grove.io",
                        "clientConfig": _client_config("/webhook/v1/authorize"),
                        "rules": [
                            {
                                "apiGroups": ["grove.io"],
                                "apiVersions": ["v1alpha1"],
                                "operations": ["CREATE", "UPDATE", "DELETE"],
                                # Status subresources listed explicitly:
                                # webhooks do not fire for unlisted
                                # subresources, and the operator-owned
                                # status projections are a write surface.
                                "resources": [
                                    "podcliques",
                                    "podcliques/status",
                                    "podcliquescalinggroups",
                                    "podcliquescalinggroups/status",
                                ],
                                "scope": "Namespaced",
                            },
                            {
                                "apiGroups": [""],
                                "apiVersions": ["v1"],
                                "operations": ["UPDATE"],
                                "resources": ["pods"],
                                "scope": "Namespaced",
                            },
                        ],
                        "objectSelector": {
                            "matchLabels": {
                                "app.kubernetes.io/managed-by": APP,
                            }
                        },
                    }
                ]
                if authorizer
                else []
            ),
        },
    ]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="grove-tpu-deploy")
    parser.add_argument("--config", required=True, help="operator config YAML")
    parser.add_argument("--namespace", default="grove-system")
    parser.add_argument("--image", default=IMAGE)
    parser.add_argument("--out", default="", help="directory for per-doc files; default stdout")
    args = parser.parse_args(argv)

    try:
        cfg = load_operator_config(args.config)
        config_yaml = pathlib.Path(args.config).read_text()
        docs = render_manifests(
            cfg, config_yaml, namespace=args.namespace, image=args.image
        )
    except ValueError as e:
        print(f"grove-tpu-deploy: {e}", file=sys.stderr)
        return 2
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        for doc in docs:
            name = f"{doc['kind'].lower()}-{doc['metadata']['name']}.yaml"
            (out / name).write_text(yaml.safe_dump(doc, sort_keys=False))
        print(f"wrote {len(docs)} manifests to {out}")
    else:
        print(yaml.safe_dump_all(docs, sort_keys=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
