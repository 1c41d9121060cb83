"""Shared label keys, environment variable names, conditions and finalizers.

Behavioral parity with the reference's common API helpers
(operator/api/common/labels.go:21-45, operator/api/common/constants/constants.go:32-122).

The port's copy of grove_tpu/api/constants.py, whole; it imports nothing of
the JAX package.
"""

# --- Label keys (labels.go:21-45) ------------------------------------------------

LABEL_MANAGED_BY = "app.kubernetes.io/managed-by"
LABEL_MANAGED_BY_VALUE = "grove-tpu-operator"
LABEL_PART_OF = "app.kubernetes.io/part-of"  # value: PodCliqueSet name
LABEL_COMPONENT = "app.kubernetes.io/component"

LABEL_PODCLIQUE = "grove.io/podclique"
LABEL_PODGANG = "grove.io/podgang"
LABEL_BASE_PODGANG = "grove.io/base-podgang"  # set on pods of *scaled* gangs
LABEL_PCS_REPLICA_INDEX = "grove.io/podcliqueset-replica-index"
LABEL_PCSG_REPLICA_INDEX = "grove.io/podcliquescalinggroup-replica-index"
LABEL_POD_TEMPLATE_HASH = "grove.io/pod-template-hash"
LABEL_PCS_GENERATION_HASH = "grove.io/podcliqueset-generation-hash"
LABEL_POD_GANG_NAME = LABEL_PODGANG
LABEL_SCALING_GROUP = "grove.io/podcliquescalinggroup"
LABEL_POD_INDEX = "grove.io/pod-index"

# Component values used to select managed resources per kind.
COMPONENT_PCLQ_POD = "pclq-pod"
COMPONENT_HEADLESS_SERVICE = "pcs-headless-service"
COMPONENT_HPA = "pcs-hpa"
COMPONENT_PODGANG = "pcs-podgang"
COMPONENT_PODCLIQUE = "pcs-podclique"
COMPONENT_PCSG = "pcs-podcliquescalinggroup"
COMPONENT_SERVICE_ACCOUNT = "pcs-service-account"
COMPONENT_ROLE = "pcs-role"
COMPONENT_ROLE_BINDING = "pcs-role-binding"
COMPONENT_SA_TOKEN_SECRET = "pcs-sa-token-secret"
COMPONENT_COMPUTE_DOMAIN = "pcs-compute-domain"

# --- Scheduling gate (podclique/components/pod/pod.go:68) ------------------------

POD_GANG_SCHEDULING_GATE = "grove.io/podgang-pending-creation"

# --- Environment variables injected into pods (constants/constants.go:53-67) -----

ENV_PCS_NAME = "GROVE_PCS_NAME"
ENV_PCS_INDEX = "GROVE_PCS_INDEX"
ENV_PCLQ_NAME = "GROVE_PCLQ_NAME"
ENV_PCLQ_POD_INDEX = "GROVE_PCLQ_POD_INDEX"
ENV_HEADLESS_SERVICE = "GROVE_HEADLESS_SERVICE"
ENV_PCSG_NAME = "GROVE_PCSG_NAME"
ENV_PCSG_INDEX = "GROVE_PCSG_INDEX"

# --- Condition types (constants/constants.go:88-122) -----------------------------

CONDITION_MIN_AVAILABLE_BREACHED = "MinAvailableBreached"
CONDITION_POD_CLIQUE_SCHEDULED = "PodCliqueScheduled"
CONDITION_UPDATE_IN_PROGRESS = "UpdateInProgress"

# PodGang conditions (scheduler/api/core/v1alpha1/podgang.go:155-168)
PODGANG_CONDITION_SCHEDULED = "Scheduled"
PODGANG_CONDITION_READY = "Ready"
PODGANG_CONDITION_UNHEALTHY = "Unhealthy"
PODGANG_CONDITION_DISRUPTION_TARGET = "DisruptionTarget"

# --- Finalizers (constants/constants.go:32-39) -----------------------------------

FINALIZER_PCS = "grove.io/podcliqueset-protection"
FINALIZER_PCLQ = "grove.io/podclique-protection"
FINALIZER_PCSG = "grove.io/podcliquescalinggroup-protection"

# --- Annotations -----------------------------------------------------------------

ANNOTATION_MNNVL = "grove.io/network-acceleration"  # analog: TPU slice acceleration
ANNOTATION_ICI_DOMAIN = "grove.io/ici-domain"  # TPU-native: pin gang to ICI domain
# Per-workload TPU-slice injection opt-in/out (the grove.io/auto-mnnvl
# analog, mnnvl/helpers.go:29-34): defaulted to "enabled" at admission when
# the feature is on and a clique requests the slice resource; users may
# pre-set it to either value (webhook.go:33-66).
ANNOTATION_AUTO_SLICE = "grove.io/auto-slice"
AUTO_SLICE_ENABLED = "enabled"
AUTO_SLICE_DISABLED = "disabled"
# The ONE default for the TPU-slice device resource name (the GPU-request
# analog, mnnvl/helpers.go hasGPURequirement): config, admission chain, and
# the config-less CLI dry run must agree or they check different resources.
DEFAULT_SLICE_RESOURCE = "google.com/tpu"
# Capacity queue this workload's gangs draw quota from (the KAI Queue
# analog, e2e/yaml/queues.yaml; scheduling.queues in the operator config).
ANNOTATION_QUEUE = "grove.io/queue"
# Set "true" on a PodCliqueSet to bypass the authorizer's managed-resource
# protection for its children (constants.go:43-45).
ANNOTATION_DISABLE_PROTECTION = "grove.io/disable-managed-resource-protection"
# Per-PCS rolling-update strategy (docs/design.md "Fleet lifecycle"):
# "make-before-break" plans the replacement generation onto free capacity
# and cuts over atomically; "recreate" pins the delete-then-recreate seed
# behavior. Unset defers to the operator config's `rollout.enabled`.
ANNOTATION_ROLLOUT_STRATEGY = "grove.io/rollout-strategy"
ROLLOUT_STRATEGY_MAKE_BEFORE_BREAK = "make-before-break"
ROLLOUT_STRATEGY_RECREATE = "recreate"
ROLLOUT_STRATEGIES = (ROLLOUT_STRATEGY_MAKE_BEFORE_BREAK, ROLLOUT_STRATEGY_RECREATE)

# SLO classes (spec.template.sloClass; tenancy subsystem, docs/design.md
# "Multi-tenant SLO tiers"). The class maps to admission order, borrowing
# eligibility, and preemptibility: `latency` admits first and never borrows
# (so reclaim cannot name it off borrowed share), `batch-preemptible` is
# evicted first when an in-quota contender reclaims.
SLO_CLASS_LATENCY = "latency"
SLO_CLASS_STANDARD = "standard"
SLO_CLASS_BATCH = "batch-preemptible"
SLO_CLASSES = (SLO_CLASS_LATENCY, SLO_CLASS_STANDARD, SLO_CLASS_BATCH)
DEFAULT_SLO_CLASS = SLO_CLASS_STANDARD

# Default PodCliqueSet name budget: pod names must fit the 63-char DNS label after
# the operator appends `-<i>-[<pcsg>-<j>-]<pclq>-<5char suffix>`
# (webhook/admission/pcs/validation/podcliqueset.go:37-39,564).
MAX_PCS_NAME_LENGTH = 45
MAX_K8S_NAME_LENGTH = 63

# Control-plane event ring: the object API serves at most this many recent
# events; clients (CLI --tail) validate against the same bound.
EVENTS_BUFFER = 200

# Ceiling for the scale subresource (kubectl-scale analog): the operator
# materializes one in-memory Pod per replica, so an unbounded scale request
# could OOM the control plane in one reconcile. HPA maxReplicas (when an HPA
# targets the object) is the tighter, user-declared bound.
MAX_SCALE_REPLICAS = 10_000
