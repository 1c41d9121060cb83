"""OperatorConfiguration: the single YAML that boots the whole stack.

Mirror of `operator/api/config/v1alpha1/types.go:57-70` (+ defaults.go and
api/config/validation/): leader election (types.go:73-104), server binds
(types.go:120-151), per-controller concurrent syncs (types.go:180-208),
log config, authorizer (types.go:211-220), topology-aware scheduling
(types.go:223-230), network acceleration (types.go:233-240) — re-keyed for
the TPU-native stack: the scheduler backend sidecar and the JAX solver get
first-class sections, and network acceleration configures the TPU-slice (ICI
domain) resource injection instead of MNNVL.

Everything has a default; `validate_operator_config` returns a list of
field-path errors (empty = valid), matching the reference's
LoadAndValidateOperatorConfig boot contract (cmd/cli/cli.go).

The port's copy of grove_tpu/runtime/config.py, whole: the same sections,
fields, defaults and error strings, so one YAML configures either package.
The port's sidecar reads `solver` (SolverConfig) and its cells read
`cells`; fields that configure the JAX package's XLA compile cache are
parsed and validated here but read by nothing in the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from grove_tpu_torch.api import constants as api_constants
from grove_tpu_torch.api.types import ClusterTopology, DEFAULT_CLUSTER_TOPOLOGY

# Runtime state dir: on-disk caches that survive operator restarts (the
# persistent XLA compilation cache, the solver shape-bucket history the
# prewarm thread compiles from). Distinct from persistence.path, which is
# control-plane STATE — losing this dir only costs warm-up time.
RUNTIME_STATE_DIR = "/tmp/grove-tpu-state"


@dataclass
class LeaderElectionConfig:
    """types.go:73-104; lease-file analog of the k8s Lease object."""

    enabled: bool = False
    lease_file: str = "/tmp/grove-tpu-leader.lease"
    lease_duration_seconds: float = 15.0
    renew_deadline_seconds: float = 10.0
    retry_period_seconds: float = 2.0


@dataclass
class ServerConfig:
    """Bind addresses (types.go:120-151). Port 0 = auto-assign, -1 = disabled."""

    bind_address: str = "127.0.0.1"  # 0.0.0.0 for in-cluster deployments
    health_port: int = 2751
    metrics_port: int = 2752
    # URL WORKLOAD PODS reach the operator's HTTP API at (the injected
    # grove-initc agent's --server). "" = the agent's localhost default —
    # fine for single-host runs, wrong for real clusters, where this must
    # be the operator Service, e.g. http://grove-tpu-operator.grove-system.svc:2751
    advertise_url: str = ""
    profiling_enabled: bool = False  # pprof analog (manager.go:42-44)
    # TLS for the HTTP surface (cert mode auto/manual, types.go:154-169):
    # disabled | auto (self-signed into tlsCertDir) | manual (provided files).
    tls_mode: str = "disabled"
    tls_cert_dir: str = "/tmp/grove-tpu-certs"
    tls_cert_file: str = ""
    tls_key_file: str = ""
    # Manual mode only: the ISSUING CA bundle for tlsCertFile. Required for
    # the webhook caBundle patch when the manual cert is CA-issued — a leaf
    # installed as a trust root verifies nothing. Unset = the cert file
    # itself is the root (self-signed manual certs).
    tls_ca_file: str = ""
    # Inbound AdmissionReview webhook server (the controller-runtime webhook
    # server analog, manager.go:90-121 / register.go:34-62). -1 = disabled,
    # 0 = auto-assign (tests). ALWAYS HTTPS — the apiserver refuses plaintext
    # webhooks — with certs independent of tlsMode (auto self-signed into
    # tlsCertDir/webhook unless tlsMode is manual, which reuses its files).
    webhook_port: int = -1
    # Extra DNS SANs baked into the auto-generated webhook serving cert —
    # must include the webhook Service DNS name for in-cluster use (the
    # apiserver verifies the cert against clientConfig.service).
    webhook_sans: list[str] = field(default_factory=list)


@dataclass
class ControllerConfig:
    """Reconcile loop knobs (types.go:180-208)."""

    concurrent_syncs: int = 1
    reconcile_interval_seconds: float = 1.0
    # Control-plane event ring capacity (Cluster.events deque maxlen): an
    # unbounded ring leaks on long soaks, so overflow drops the oldest
    # event and counts it (grove_events_dropped_total).
    events_buffer: int = 4096
    # Heal-event dedupe window: repeated "rejected/unparseable CR" heal
    # events for one (object, reason) pair emit at most once per window —
    # an external writer flapping between bad values must not flood the
    # event ring every relist. 0 disables the window (every heal events).
    heal_event_dedupe_seconds: float = 60.0


@dataclass
class LogConfig:
    level: str = "info"  # debug|info|error
    format: str = "text"  # json|text


@dataclass
class AuthorizerConfig:
    """types.go:211-220: block mutation of managed resources by non-operators."""

    enabled: bool = False
    exempt_actors: list[str] = field(default_factory=list)


@dataclass
class TopologyAwareSchedulingConfig:
    """types.go:223-230: enable TAS + the level list (ClusterTopology source)."""

    enabled: bool = True
    # Each: {"domain": "rack", "nodeLabelKey": "topology.kubernetes.io/rack"}
    levels: list[dict] = field(default_factory=list)


@dataclass
class NetworkAccelerationConfig:
    """types.go:233-240 MNNVL analog: auto TPU-slice/ICI resource injection."""

    auto_slice_enabled: bool = False
    slice_resource_name: str = api_constants.DEFAULT_SLICE_RESOURCE


@dataclass
class SchedulingConfig:
    """Priority classes (the chart's priorityclass.yaml analog): name ->
    numeric priority consumed by the preemption pass and pending-sort.

    `queues` is the KAI Queue analog (the reference deploys KAI queues,
    e2e/setup/kai_scheduler.go:90): name -> {resource: quota}, quantity
    strings or -1 for unlimited. A PodCliqueSet opts in with the
    `grove.io/queue` annotation; its gangs' floors are admitted only while
    the queue's cumulative usage fits the quota (hard quota — KAI's
    over-quota fair-share borrowing is out of scope)."""

    priority_classes: dict[str, int] = field(default_factory=dict)
    queues: dict = field(default_factory=dict)


@dataclass
class SolverConfig:
    """The placement engine (no reference analog — the KAI replacement)."""

    # Portfolio width: >1 solves every batch under P score-weight variants
    # and keeps the winner (parallel/portfolio.py) — the multi-chip quality
    # knob; the variants shard across the device mesh when one is available.
    # (A `speculative` knob existed through round 3; the path was deleted
    # after losing to the sequential scan in every measured regime.)
    portfolio: int = 1
    # Rejection escalation: when a solve at `portfolio` width leaves valid
    # gangs rejected and this value is LARGER, re-solve that batch once at
    # this width and keep the winner (bounded, once per solve; the seeded
    # population is prefix-stable, so the wider winner can only admit
    # more). <= portfolio disables. Defaults ON so the default serving
    # path fixes packing-artifact rejections without paying the portfolio
    # cost on uncontended solves; the serving paths damp it to base cost
    # in an unchanged saturated steady state.
    portfolio_escalation: int = 4
    # Persistent XLA compilation cache dir ("" = off): solver warm-up
    # compiles (~20-40s on TPU) are reused across operator restarts.
    # Defaults ON under the runtime state dir — the cold-start compile tax
    # (BENCH_r05: compile_s=4.32 vs solve 0.85s) is paid once per
    # (code, shape, platform), not once per boot. Tests/processes can
    # override with the JAX_COMPILATION_CACHE_DIR env var (JAX reads it
    # natively) without touching config.
    compilation_cache_dir: str = RUNTIME_STATE_DIR + "/xla-cache"
    # Startup prewarm: a background thread AOT-compiles the top-K
    # historically hottest solver shape buckets (recorded per solve to
    # shapeHistoryPath) so the first drain/solve_pending after a restart
    # never blocks on XLA. 0 = off.
    prewarm_top_k: int = 4
    shape_history_path: str = RUNTIME_STATE_DIR + "/solve-shapes.json"
    max_groups: Optional[int] = None
    max_sets: Optional[int] = None
    max_pods: Optional[int] = None
    pad_gangs_to: Optional[int] = None
    # Score-weight overrides (SolverParams fields, camelCase: wTight, wPref,
    # wReuse, wReserve, wSpread). Unset fields keep their defaults.
    weights: dict = field(default_factory=dict)
    # Candidate-node pruning (solver/pruning.py): a cheap host pre-filter
    # gathers the nodes that could possibly serve any gang in the wave onto
    # a compact pow2 candidate axis, the unchanged batched solver runs on
    # the sub-fleet, and the AOT executable cache keys on the CANDIDATE pad
    # instead of the fleet pad (executables stop growing with fleet size).
    # Lossy rejections escalate to a dense re-solve — admitted sets match
    # the dense solver, escalations counted, never silent. Keys:
    #   enabled        bool, default false
    #   maxCandidates  int >= 1, candidate budget (default 8191 — pairs with
    #                  the 8192 bucket + the cap-anchor pad row)
    #   padLadder      list of increasing ints; [] = every pow2 from minPad
    #   minPad         int >= 2, smallest candidate bucket (default 64)
    #   minFleet       int >= 0, fleets below this never prune (default 256)
    pruning: dict = field(default_factory=dict)
    # Streaming drain (solver/stream.py): the double-buffered pipelined
    # admission loop under live arrival traffic — encode wave N+1 and
    # decode/bind wave N-1 on the host while wave N solves on device. Keys:
    #   depth     int >= 1, waves in flight before the host blocks on the
    #             oldest (default 2 — classic double buffering)
    #   waveSize  int >= 1, max gangs per formed arrival window (default 64;
    #             smaller binds sooner, larger amortizes dispatch better)
    #   maxWaitS  number >= 0, paced mode: how long the oldest queued gang
    #             waits for companions before a partial wave dispatches
    #             (default 0.05)
    #   pollS     number > 0, paced mode: idle poll granularity (default
    #             0.005)
    streaming: dict = field(default_factory=dict)
    # On-device fused drain (solver/drain.py harvest="scan"): an entire
    # shape-class of planned waves dispatches as ONE lax.scan program — the
    # free/ok_global carry threads between waves on device, verdict planes
    # accumulate as scan outputs, and the host pays O(shape classes +
    # escalations) round-trips instead of O(waves). Bitwise-equal admitted
    # sets vs the per-wave disciplines (test-pinned), so enabling it is a
    # pure host-overhead choice; the resilience ladder's first rung steps
    # scan -> pipelined on failure. Keys:
    #   enabled           bool, default true (the block gates callers that
    #                     request the scan discipline; serving paths still
    #                     choose harvest explicitly)
    #   maxScanLen        int >= 1, max waves fused into one scan chunk
    #                     (default 32; chunk lengths bucket to pow2)
    #   minWavesPerClass  int >= 1, runs shorter than this dispatch
    #                     per-wave — fusion overhead isn't worth one wave
    #                     (default 2)
    #   affinityLookahead int >= 0, stream saturated mode: planned waves
    #                     from up to this many windows ahead reorder by
    #                     (rank, shape class) before dispatch so same-
    #                     class runs form and fuse; 0 = strict window-at-
    #                     a-time dispatch order (default 4). Window
    #                     composition and admitted sets are unchanged.
    #   deviceResident    bool, default false: saturated stream drains
    #                     retire nothing until the trace is exhausted —
    #                     ONE batched harvest at the end, device round-
    #                     trips O(1 + escalations). First ladder rung
    #                     ("resident"), stepping down to scanned.
    scan: dict = field(default_factory=dict)
    # Mesh-sharded solve (parallel/mesh.py): distribute the single-variant
    # batched solve across the TPU mesh — node-axis tensors split over the
    # devices (GSPMD inserts the segment-reduction collectives), the free
    # carry chains node-sharded between waves, the AOT cache keys on the
    # mesh shape, and journaled waves record the mesh fingerprint for
    # replay. Bitwise-equal to the unsharded solve, so enabling it is a
    # pure throughput choice; negotiation fallbacks (no divisible layout)
    # solve unsharded and are counted (/statusz warmPath shardFallbacks).
    # Keys:
    #   enabled     bool, default false
    #   minNodes    int >= 0, fleets whose padded node axis is below this
    #               stay unsharded (default 512 — collectives would cost
    #               more than the split saves)
    #   maxDevices  int >= 0, devices the solve may occupy (default 0 =
    #               every visible device)
    mesh: dict = field(default_factory=dict)

    def solver_params(self):
        """SolverConfig.weights -> SolverParams (validated at config load)."""
        from grove_tpu_torch.solver.core import SolverParams

        snake = {_CAMEL_FIELDS.get(k, k): float(v) for k, v in self.weights.items()}
        return SolverParams(**snake)

    def pruning_config(self):
        """SolverConfig.pruning -> solver.pruning.PruningConfig, or None
        when pruning is disabled (validated at config load)."""
        p = self.pruning or {}
        if not p.get("enabled", False):
            return None
        from grove_tpu_torch.solver.pruning import PruningConfig

        kwargs = {}
        if "maxCandidates" in p:
            kwargs["max_candidates"] = int(p["maxCandidates"])
        if "padLadder" in p:
            kwargs["pad_ladder"] = tuple(int(x) for x in p["padLadder"])
        if "minPad" in p:
            kwargs["min_pad"] = int(p["minPad"])
        if "minFleet" in p:
            kwargs["min_fleet"] = int(p["minFleet"])
        return PruningConfig(enabled=True, **kwargs)

    def mesh_config(self):
        """SolverConfig.mesh -> parallel.mesh.MeshConfig (validated at
        config load; always returns a config — the enabled bit rides it)."""
        m = self.mesh or {}
        from grove_tpu_torch.parallel.mesh import MeshConfig

        kwargs = {}
        if "minNodes" in m:
            kwargs["min_nodes"] = int(m["minNodes"])
        if "maxDevices" in m:
            kwargs["max_devices"] = int(m["maxDevices"])
        return MeshConfig(enabled=bool(m.get("enabled", False)), **kwargs)

    def streaming_config(self):
        """SolverConfig.streaming -> solver.stream.StreamConfig (validated
        at config load; always returns a config — streaming has no enabled
        bit, the block only parameterizes callers of drain_stream)."""
        s = self.streaming or {}
        from grove_tpu_torch.solver.stream import StreamConfig

        kwargs = {}
        if "depth" in s:
            kwargs["depth"] = int(s["depth"])
        if "waveSize" in s:
            kwargs["wave_size"] = int(s["waveSize"])
        if "maxWaitS" in s:
            kwargs["max_wait_s"] = float(s["maxWaitS"])
        if "pollS" in s:
            kwargs["poll_s"] = float(s["pollS"])
        return StreamConfig(**kwargs)

    def scan_config(self):
        """SolverConfig.scan -> solver.drain.ScanConfig (validated at config
        load; always returns a config — the enabled bit rides it, default
        ON: a disabled block makes harvest="scan" requests fall back to
        pipelined)."""
        s = self.scan or {}
        from grove_tpu_torch.solver.drain import ScanConfig

        kwargs = {}
        if "maxScanLen" in s:
            kwargs["max_scan_len"] = int(s["maxScanLen"])
        if "minWavesPerClass" in s:
            kwargs["min_waves_per_class"] = int(s["minWavesPerClass"])
        if "affinityLookahead" in s:
            kwargs["affinity_lookahead"] = int(s["affinityLookahead"])
        if "deviceResident" in s:
            kwargs["device_resident"] = bool(s["deviceResident"])
        return ScanConfig(enabled=bool(s.get("enabled", True)), **kwargs)


@dataclass
class DefragConfig:
    """Defragmentation & rebalance loop (solver/defrag.py + the controller's
    defrag_tick): periodic fragmentation scoring over the cluster snapshot;
    when the score crosses `threshold`, the batched migration planner
    re-places movable gangs (through the same warm-path AOT executable
    cache as serving solves) and the controller executes the winning plan
    under a disruption budget with make-before-break ordering."""

    enabled: bool = False
    # Fragmentation score in [0, 1] at which planning kicks in (1 - best
    # domain free / ideal consolidated free, worst over levels+resources).
    threshold: float = 0.5
    # Evaluation cadence of the background loop.
    interval_seconds: float = 30.0
    # Disruption budget: max gangs migrating (rebound, not yet Ready again)
    # at any instant. Plan moves beyond it defer to later cycles.
    max_concurrent_migrations: int = 1
    # A migrated gang is immune to re-migration for this long.
    gang_cooldown_seconds: float = 300.0
    # Cap on gangs re-placed per plan (candidate prefix ladder top).
    max_moves_per_plan: int = 8
    # Minimum (capacity recovered / pods migrated) for a plan to execute;
    # units of the binding resource. 0 = any strict improvement runs.
    min_efficiency: float = 0.0


@dataclass
class RolloutConfig:
    """Make-before-break rolling updates (orchestrator/rollout.py;
    docs/design.md "Fleet lifecycle"): when enabled — globally here or
    per-PCS via the grove.io/rollout-strategy annotation — the current
    replica's new generation is planned onto capacity that is free WHILE the
    old placement still holds (plan_rescue with usage held), cut over
    atomically under the shared disruption budget, and deferred whole (with
    surge/next-replica what-if pricing journaled) when it does not fit.
    Off = the seed delete-then-recreate behavior exactly."""

    enabled: bool = False
    # "+surge racks" what-if size priced for parked replicas (0 disables
    # the surge scenario; the next-replica what-if always runs).
    surge_racks: int = 1
    # Decorrelated-jitter retry pacing for deferred replicas
    # (utils/backoff.py): first retry after base, capped growth after.
    backoff_base_seconds: float = 0.5
    backoff_cap_seconds: float = 30.0
    # Per-replica make-before-break deadline: once spent, the replica falls
    # back to the seed delete-then-recreate path (always makes progress).
    deadline_seconds: float = 600.0


@dataclass
class TraceConfig:
    """Decision flight recorder (grove_tpu/trace): journals every solve wave
    (snapshot digest, compact node/gang encodings, solver config fingerprint,
    resulting plan with per-gang rejection reasons, timings) plus preemption/
    defrag/rolling-update actions, off the hot path via a bounded queue and a
    writer thread with atomic segment rotation. Journals feed deterministic
    replay (`grove-tpu trace replay` — bitwise plan equivalence, divergence =
    solver-nondeterminism regression) and what-if counterfactuals
    (`grove-tpu trace whatif` — +N racks / different solver config scored
    with the placement-quality report)."""

    enabled: bool = False
    # Journal directory (segment files rotate inside it).
    path: str = RUNTIME_STATE_DIR + "/trace"
    # Segment rotation: records per segment file, and how many segment files
    # to keep (oldest pruned; every segment is self-contained for replay).
    max_records_per_file: int = 256
    max_files: int = 16
    # Bounded hand-off queue between the reconcile thread and the writer; a
    # full queue DROPS records (counted) rather than blocking a solve.
    queue_size: int = 2048
    # Writer flush cadence; the manager's trace flow step also requests a
    # flush each reconcile, so journal staleness is bounded by min(this,
    # reconcile interval).
    flush_interval_seconds: float = 1.0


@dataclass
class TuningConfig:
    """Offline config-sweep tuning (grove_tpu/tuning): `grove-tpu tune
    sweep` replays a recorded journal once while K candidate solver configs
    ride the solver's variant axis (one AOT executable per (wave shape
    bucket, K)), prunes losers by successive halving between trace chunks,
    and emits a recommended config validated two ways — bitwise agreement
    with a plain single-config replay, and admitted-ratio parity against
    the exact B&B reference on the seeded audit instances. This block only
    parameterizes the sweep; nothing in the serving path reads it."""

    # Config-grid size: the incumbent (recorded) config + gridK-1 candidates.
    grid_k: int = 16
    # Successive-halving rungs over the trace (1 = score the whole grid on
    # the whole trace, no halving).
    halving_rungs: int = 3
    # Log-normal weight-perturbation spread for the generated grid.
    spread: float = 0.5
    # Grid generation seed (the sweep is deterministic given the journal).
    seed: int = 0
    # Exact-audit instance seeds for winner validation; [] = the default
    # tier-1 audit set (quality/audit.AUDIT_SEEDS).
    audit_seeds: list = field(default_factory=list)


@dataclass
class FaultsConfig:
    """Deterministic fault injection (grove_tpu/faults): named sites
    threaded through the stack — solver dispatch/harvest, bind commit, the
    kube wire client, the watch stream, the recorder's segment writes, sim
    node death — fire on a seed-driven schedule so chaos runs replay
    bit-for-bit. Off by default and off in production; the `GROVE_FAULTS`
    env override ("site=kind:rate[:count[:after]];...") wins over this
    block outright. Every injected fault is journaled as a flight-recorder
    action record and counted (/statusz resilience.faults)."""

    enabled: bool = False
    # Site-schedule derivation seed (per-site streams are independent).
    seed: int = 0
    # site -> {kind, rate, count, after}; see faults.SITES / faults.KINDS.
    sites: dict = field(default_factory=dict)


@dataclass
class CellsConfig:
    """Cellular control plane (grove_tpu/cells; docs/design.md "Cellular
    control plane"). When enabled the manager partitions the control plane
    into `count` reconcile cells along QueueTree root-subtree seams (each
    root subtree is a self-contained borrow domain) and shards the fleet
    along `topologyLevel`; each cell runs its own drain/stream engine with
    its own journal (under journalRoot/<cell>) and its own named lease
    (runtime/lease.LeaseSet — losing one cell's lease never touches
    another's). A restarting cell recovers by replaying its journal tail
    bitwise (trace/replay) before admitting new work. Cross-cell traffic
    (spanning gangs, borrowed capacity, reclaim) routes through the
    coordinator only."""

    enabled: bool = False
    # How many cells to shard into (cell-0 .. cell-(count-1)).
    count: int = 2
    # Partition axis: "queue" pins gangs by QueueTree root subtree;
    # "topology" leaves queues unpinned (pure fleet sharding).
    shard_by: str = "queue"
    # TAS domain the fleet shards along (a domain's nodes land wholly in
    # one cell, so each engine sees a topologically coherent sub-snapshot).
    topology_level: str = "zone"
    # Per-cell journal directories: journalRoot/<cell-name>/.
    journal_root: str = RUNTIME_STATE_DIR + "/cells"
    # Per-cell named lease files: leaseDir/<cell-name>.lease.
    lease_dir: str = RUNTIME_STATE_DIR + "/cell-leases"
    lease_duration_seconds: float = 15.0
    renew_deadline_seconds: float = 10.0
    # Gangs per engine run between crash-fault checkpoints (cell.crash
    # fires only at chunk boundaries; families never split across chunks).
    crash_check_every: int = 128


@dataclass
class ResilienceConfig:
    """Graceful-degradation ladder + failure-domain hardening
    (solver/resilience.py). When enabled: a watchdog cancels and
    re-dispatches in-flight solve waves that hang; per-subsystem circuit
    breakers step the solve loop down mesh-sharded->unsharded,
    pruned->dense, pipelined->serial, portfolio->single (each rung
    admitted-set-preserving, pinned by the equivalence tests) and step back
    up after probation; kube binds retry with decorrelated-jitter backoff;
    gang binds commit all-or-nothing with rollback; and stale plans
    (target node died between solve and bind) requeue instead of binding.
    Every step-down/step-up is counted (grove_degradation_*), journaled,
    and surfaced on /statusz resilience + `grove-tpu get resilience` —
    never silent."""

    enabled: bool = False
    # In-flight wave watchdog: hung-solve deadline and re-dispatch budget.
    watchdog_seconds: float = 30.0
    max_wave_retries: int = 2
    # Circuit breakers: failures within the window that open a rung, and
    # how long it stays open before a half-open (trial) probe.
    breaker_threshold: int = 3
    breaker_window_seconds: float = 60.0
    probation_seconds: float = 30.0
    # Kube bind push: in-call retry attempts with decorrelated jitter
    # (utils/backoff.py; 1 = single shot, cross-tick retry set still applies).
    bind_max_attempts: int = 3
    backoff_base_seconds: float = 0.05
    backoff_cap_seconds: float = 2.0
    # Retire-time stale-plan revalidation (bind into live nodes only).
    stale_plan_revalidation: bool = True

    def resilience_config(self):
        """-> solver.resilience.ResilienceConfig (the solver-side value
        object; always returns one — the enabled bit rides it)."""
        from grove_tpu_torch.solver.resilience import (
            ResilienceConfig as SolverResilienceConfig,
        )

        return SolverResilienceConfig(
            enabled=bool(self.enabled),
            watchdog_seconds=float(self.watchdog_seconds),
            max_wave_retries=int(self.max_wave_retries),
            breaker_threshold=int(self.breaker_threshold),
            breaker_window_seconds=float(self.breaker_window_seconds),
            probation_seconds=float(self.probation_seconds),
            bind_max_attempts=int(self.bind_max_attempts),
            backoff_base_seconds=float(self.backoff_base_seconds),
            backoff_cap_seconds=float(self.backoff_cap_seconds),
            stale_plan_revalidation=bool(self.stale_plan_revalidation),
        )


@dataclass
class TenancyConfig:
    """Multi-tenant SLO tiers (grove_tpu/tenancy; docs/design.md
    "Multi-tenant SLO tiers"). When enabled: the workload sloClass
    (latency | standard | batch-preemptible) leads the admission order,
    `latency` gangs never ride borrowed queue capacity, starved pending
    gangs climb effective priority on a deterministic half-life-doubling
    aging ladder, quota-reclaim evictions draw from the defrag disruption
    budget (deferred — never partially applied — when over it), and a
    per-tenant fairness ledger feeds /statusz tenancy, the
    grove_tenancy_* metrics, and `grove-tpu get tenancy`. Disabled = the
    pre-tenancy scheduling behavior exactly."""

    enabled: bool = False
    # Aging ladder: boost step k unlocks after half_life*(2^k - 1) seconds
    # pending (tenancy/aging.py), capped at aging_max_boost.
    aging_half_life_seconds: float = 300.0
    aging_max_boost: int = 4


@dataclass
class BackendConfig:
    """Scheduler-backend sidecar (GREP-375 boundary)."""

    enabled: bool = False
    port: int = 0  # 0 = auto-assign
    max_workers: int = 8


@dataclass
class PersistenceConfig:
    """Control-plane state snapshot/restore (CR-status persistence analog)."""

    enabled: bool = False
    path: str = "/tmp/grove-tpu-state.json"
    snapshot_interval_seconds: float = 10.0


@dataclass
class ClusterConfig:
    """Node source for the manager. `none` (default): the store is fed
    externally (attach_watch / backend RPCs / simulator). `kwok`: the manager
    fabricates a KWOK-shaped fake fleet at boot and drives it through the
    watch path — the in-binary analog of the reference's scale rig
    (`make kind-up FAKE_NODES=N`, operator/hack/kind-up.sh:31,252-265), which
    makes `python -m grove_tpu.runtime` a self-contained e2e environment.
    `kubernetes`: a live apiserver via the list/watch wire protocol
    (cluster/kubernetes.py; the informer pattern of manager.go:53-121) —
    node/pod events stream in, solver placements POST back as pod creates +
    binding subresource calls."""

    source: str = "none"  # none | kwok | kubernetes
    # kubernetes source: kubeconfig path ("" = $KUBECONFIG, ~/.kube/config,
    # then the in-cluster service-account mount), context ("" = current),
    # namespace ("" = the context's), and the pod watch label selector.
    kubeconfig: str = ""
    kube_context: str = ""
    kube_namespace: str = ""
    # "" = the managed-by selector derived from api/constants
    # (cluster/kubernetes.py DEFAULT_POD_LABEL_SELECTOR).
    pod_label_selector: str = ""
    # Client-side rate limit on the kubernetes wire client — the reference's
    # ClientConnectionConfiguration{QPS, Burst} (types.go client-connection
    # section; client-go flowcontrol defaults). Token bucket over every
    # apiserver request the watch source issues (binding an N-pod gang is
    # 2N calls per tick): sustained `kubeQps` requests/s with `kubeBurst`
    # tokens of headroom. kubeQps 0 disables throttling entirely.
    kube_qps: float = 50.0
    kube_burst: int = 100
    # Watch PodCliqueSet CRs at the apiserver (kubectl-apply -> admission ->
    # reconcile -> status write-back). Off = fleet mirroring only (workloads
    # arrive via the operator's own HTTP API).
    watch_workloads: bool = True
    # How injected grove-initc agents read parent-clique readiness:
    #   operator   — poll the operator HTTP API (servers.advertiseUrl)
    #   kubernetes — list gang pods at the kube-apiserver directly with the
    #                mirrored per-PCS SA token (the reference agent's path,
    #                wait.go:111-164); no operator URL in the pod at all.
    initc_mode: str = "operator"
    kwok_nodes: int = 8
    kwok_cpu_per_node: float = 32.0
    kwok_memory_per_node: float = 128 * 2**30
    kwok_tpu_per_node: float = 8.0
    kwok_hosts_per_rack: int = 4
    kwok_racks_per_block: int = 4
    # Group factors for topology levels BEYOND rack/block, narrowest first
    # (e.g. [2, 3] = 2 blocks per zone, 3 zones per super-zone). Required
    # when the TAS config declares more than rack/block/host — a deeper
    # hierarchy must not silently get a fleet shape nobody asked for.
    kwok_level_group_factors: list = field(default_factory=list)
    # KWOK stage latencies (kind-up.sh:264-265): bind -> Running -> Ready.
    running_delay_seconds: float = 0.2
    ready_delay_seconds: float = 0.2
    # Informer-latency model: events become pollable only this much later.
    event_lag_seconds: float = 0.0
    # Revocable (spot) capacity: mark the LAST N kwok nodes revocable — the
    # fleet slice the provider may take back on a revocation notice
    # (Node.revocable; sim.node_revocation fault site). 0 = all on-demand.
    revocable_nodes: int = 0
    # Grace window granted with a notice: seconds between the notice and the
    # capacity disappearing (Simulator.revocation_grace_s analog).
    revocable_grace_seconds: float = 30.0
    # Controller reaction ladder: with at least this much grace left it
    # migrates residents make-before-break; inside the lead it evicts in
    # SLO-rank order (batch-preemptible first) so the node drains in time.
    revocable_eviction_lead_seconds: float = 10.0


@dataclass
class OperatorConfiguration:
    leader_election: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    servers: ServerConfig = field(default_factory=ServerConfig)
    controllers: ControllerConfig = field(default_factory=ControllerConfig)
    log: LogConfig = field(default_factory=LogConfig)
    authorizer: AuthorizerConfig = field(default_factory=AuthorizerConfig)
    topology_aware_scheduling: TopologyAwareSchedulingConfig = field(
        default_factory=TopologyAwareSchedulingConfig
    )
    network_acceleration: NetworkAccelerationConfig = field(
        default_factory=NetworkAccelerationConfig
    )
    scheduling: SchedulingConfig = field(default_factory=SchedulingConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    defrag: DefragConfig = field(default_factory=DefragConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    tuning: TuningConfig = field(default_factory=TuningConfig)
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    cells: CellsConfig = field(default_factory=CellsConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    persistence: PersistenceConfig = field(default_factory=PersistenceConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)

    def cluster_topology(self) -> ClusterTopology:
        """TAS levels -> ClusterTopology (clustertopology sync analog)."""
        tas = self.topology_aware_scheduling
        if not tas.levels:
            return DEFAULT_CLUSTER_TOPOLOGY
        topo = ClusterTopology.from_dict(
            {"name": "operator-config", "levels": tas.levels}
        )
        # Auto-append the host level, as the operator's topology sync does
        # (internal/clustertopology/clustertopology.go:102-107).
        return topo.with_host_level()


# Valid score-weight field names, kept jax-free (config validation must not
# import the solver). tests/test_config_wiring.py pins this against
# SolverParams._fields so the two cannot drift.
_WEIGHT_FIELDS = frozenset(
    {"w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread"}
)

_SECTION_TYPES = {
    "leaderElection": ("leader_election", LeaderElectionConfig),
    "servers": ("servers", ServerConfig),
    "controllers": ("controllers", ControllerConfig),
    "log": ("log", LogConfig),
    "authorizer": ("authorizer", AuthorizerConfig),
    "topologyAwareScheduling": ("topology_aware_scheduling", TopologyAwareSchedulingConfig),
    "networkAcceleration": ("network_acceleration", NetworkAccelerationConfig),
    "scheduling": ("scheduling", SchedulingConfig),
    "solver": ("solver", SolverConfig),
    "defrag": ("defrag", DefragConfig),
    "rollout": ("rollout", RolloutConfig),
    "trace": ("trace", TraceConfig),
    "tuning": ("tuning", TuningConfig),
    "faults": ("faults", FaultsConfig),
    "resilience": ("resilience", ResilienceConfig),
    "cells": ("cells", CellsConfig),
    "tenancy": ("tenancy", TenancyConfig),
    "backend": ("backend", BackendConfig),
    "persistence": ("persistence", PersistenceConfig),
    "cluster": ("cluster", ClusterConfig),
}

_CAMEL_FIELDS = {
    # camelCase YAML key -> snake_case dataclass field, per section type
    "leaseFile": "lease_file",
    "leaseDurationSeconds": "lease_duration_seconds",
    "renewDeadlineSeconds": "renew_deadline_seconds",
    "retryPeriodSeconds": "retry_period_seconds",
    "bindAddress": "bind_address",
    "healthPort": "health_port",
    "advertiseUrl": "advertise_url",
    "metricsPort": "metrics_port",
    "profilingEnabled": "profiling_enabled",
    "tlsMode": "tls_mode",
    "tlsCertDir": "tls_cert_dir",
    "tlsCertFile": "tls_cert_file",
    "tlsKeyFile": "tls_key_file",
    "tlsCaFile": "tls_ca_file",
    "webhookPort": "webhook_port",
    "webhookSans": "webhook_sans",
    "concurrentSyncs": "concurrent_syncs",
    "reconcileIntervalSeconds": "reconcile_interval_seconds",
    "eventsBuffer": "events_buffer",
    "healEventDedupeSeconds": "heal_event_dedupe_seconds",
    "maxRecordsPerFile": "max_records_per_file",
    "maxFiles": "max_files",
    "gridK": "grid_k",
    "halvingRungs": "halving_rungs",
    "watchdogSeconds": "watchdog_seconds",
    "maxWaveRetries": "max_wave_retries",
    "breakerThreshold": "breaker_threshold",
    "breakerWindowSeconds": "breaker_window_seconds",
    "probationSeconds": "probation_seconds",
    "bindMaxAttempts": "bind_max_attempts",
    "backoffBaseSeconds": "backoff_base_seconds",
    "backoffCapSeconds": "backoff_cap_seconds",
    "stalePlanRevalidation": "stale_plan_revalidation",
    "agingHalfLifeSeconds": "aging_half_life_seconds",
    "agingMaxBoost": "aging_max_boost",
    "sites": "sites",
    "auditSeeds": "audit_seeds",
    "queueSize": "queue_size",
    "flushIntervalSeconds": "flush_interval_seconds",
    "exemptActors": "exempt_actors",
    "autoSliceEnabled": "auto_slice_enabled",
    "sliceResourceName": "slice_resource_name",
    "priorityClasses": "priority_classes",
    "queues": "queues",
    "maxGroups": "max_groups",
    "maxSets": "max_sets",
    "maxPods": "max_pods",
    "padGangsTo": "pad_gangs_to",
    "compilationCacheDir": "compilation_cache_dir",
    "prewarmTopK": "prewarm_top_k",
    "shapeHistoryPath": "shape_history_path",
    "portfolioEscalation": "portfolio_escalation",
    "intervalSeconds": "interval_seconds",
    "maxConcurrentMigrations": "max_concurrent_migrations",
    "gangCooldownSeconds": "gang_cooldown_seconds",
    "maxMovesPerPlan": "max_moves_per_plan",
    "minEfficiency": "min_efficiency",
    "maxWorkers": "max_workers",
    "snapshotIntervalSeconds": "snapshot_interval_seconds",
    "wTight": "w_tight",
    "wPref": "w_pref",
    "wReuse": "w_reuse",
    "wReserve": "w_reserve",
    "wSpread": "w_spread",
    "kubeconfig": "kubeconfig",
    "kubeContext": "kube_context",
    "kubeNamespace": "kube_namespace",
    "podLabelSelector": "pod_label_selector",
    "kubeQps": "kube_qps",
    "kubeBurst": "kube_burst",
    "watchWorkloads": "watch_workloads",
    "initcMode": "initc_mode",
    "kwokNodes": "kwok_nodes",
    "kwokCpuPerNode": "kwok_cpu_per_node",
    "kwokMemoryPerNode": "kwok_memory_per_node",
    "kwokTpuPerNode": "kwok_tpu_per_node",
    "kwokHostsPerRack": "kwok_hosts_per_rack",
    "kwokRacksPerBlock": "kwok_racks_per_block",
    "kwokLevelGroupFactors": "kwok_level_group_factors",
    "runningDelaySeconds": "running_delay_seconds",
    "readyDelaySeconds": "ready_delay_seconds",
    "eventLagSeconds": "event_lag_seconds",
    "surgeRacks": "surge_racks",
    "deadlineSeconds": "deadline_seconds",
    "shardBy": "shard_by",
    "topologyLevel": "topology_level",
    "journalRoot": "journal_root",
    "leaseDir": "lease_dir",
    "crashCheckEvery": "crash_check_every",
    "revocableNodes": "revocable_nodes",
    "revocableGraceSeconds": "revocable_grace_seconds",
    "revocableEvictionLeadSeconds": "revocable_eviction_lead_seconds",
}


def _build_section(cls, doc: dict, path: str, errors: list[str]):
    if doc is not None and not isinstance(doc, dict):
        errors.append(f"{path}: must be a mapping, got {type(doc).__name__}")
        return cls()
    kwargs = {}
    valid_fields = set(cls.__dataclass_fields__)
    for key, value in (doc or {}).items():
        fname = _CAMEL_FIELDS.get(key, key)
        if fname not in valid_fields:
            errors.append(f"{path}.{key}: unknown field")
            continue
        kwargs[fname] = value
    try:
        return cls(**kwargs)
    except TypeError as e:
        errors.append(f"{path}: {e}")
        return cls()


def parse_operator_config(doc: dict) -> tuple[OperatorConfiguration, list[str]]:
    """Dict -> config + field errors (unknown sections/fields are errors —
    a typo'd knob silently ignored is the worst failure mode of config)."""
    errors: list[str] = []
    cfg = OperatorConfiguration()
    for key, value in (doc or {}).items():
        entry = _SECTION_TYPES.get(key)
        if entry is None:
            errors.append(f"{key}: unknown section")
            continue
        attr, cls = entry
        setattr(cfg, attr, _build_section(cls, value, key, errors))
    errors.extend(validate_operator_config(cfg))
    return cfg, errors


def validate_operator_config(cfg: OperatorConfiguration) -> list[str]:
    """Semantic validation (api/config/validation analog)."""
    errors: list[str] = []
    if cfg.log.level not in ("debug", "info", "error"):
        errors.append(f"log.level: {cfg.log.level!r} not in debug|info|error")
    if cfg.log.format not in ("json", "text"):
        errors.append(f"log.format: {cfg.log.format!r} not in json|text")
    if cfg.controllers.concurrent_syncs < 1:
        errors.append("controllers.concurrentSyncs: must be >= 1")
    if cfg.controllers.reconcile_interval_seconds <= 0:
        errors.append("controllers.reconcileIntervalSeconds: must be > 0")
    le = cfg.leader_election
    if le.enabled:
        if le.renew_deadline_seconds >= le.lease_duration_seconds:
            errors.append(
                "leaderElection.renewDeadlineSeconds: must be < leaseDurationSeconds"
            )
        if le.retry_period_seconds <= 0:
            errors.append("leaderElection.retryPeriodSeconds: must be > 0")
        # The leader renews once per run-loop iteration, so the renewal gap is
        # at least the reconcile interval; a deadline below it would make
        # leadership flap every cycle (stand down -> re-acquire, forever).
        if cfg.controllers.reconcile_interval_seconds >= le.renew_deadline_seconds:
            errors.append(
                "leaderElection.renewDeadlineSeconds: must be > "
                "controllers.reconcileIntervalSeconds (renewal happens once "
                "per reconcile cycle)"
            )
    if not isinstance(cfg.scheduling.priority_classes, dict):
        errors.append(
            "scheduling.priorityClasses: must be a mapping of name -> integer"
        )
    else:
        for pc_name, pc_value in cfg.scheduling.priority_classes.items():
            if not isinstance(pc_value, int) or isinstance(pc_value, bool):
                errors.append(
                    f"scheduling.priorityClasses.{pc_name}: {pc_value!r} is not an integer"
                )
    if cfg.servers.tls_mode not in ("disabled", "auto", "manual"):
        errors.append(
            f"servers.tlsMode: {cfg.servers.tls_mode!r} not in disabled|auto|manual"
        )
    if cfg.servers.tls_mode == "manual" and not (
        cfg.servers.tls_cert_file and cfg.servers.tls_key_file
    ):
        errors.append("servers.tlsCertFile/tlsKeyFile: required for tlsMode manual")
    if cfg.servers.tls_ca_file:
        import os as _os

        if cfg.servers.tls_mode != "manual":
            errors.append("servers.tlsCaFile: only meaningful with tlsMode manual")
        elif not _os.path.isfile(cfg.servers.tls_ca_file):
            errors.append(
                f"servers.tlsCaFile: {cfg.servers.tls_ca_file!r} does not exist"
            )
    for port_name, port in (
        ("servers.healthPort", cfg.servers.health_port),
        ("servers.metricsPort", cfg.servers.metrics_port),
        ("servers.webhookPort", cfg.servers.webhook_port),
        ("backend.port", cfg.backend.port),
    ):
        if port < -1 or port > 65535:
            errors.append(f"{port_name}: {port} out of range")
    if not isinstance(cfg.servers.webhook_sans, list):
        # A bare YAML string would iterate char-by-char below AND turn the
        # deploy renderer's `dns in sans` membership test into a substring
        # match — two silent passes ending in cluster-wide TLS failure.
        errors.append("servers.webhookSans: must be a list of DNS names")
    else:
        for i, san in enumerate(cfg.servers.webhook_sans):
            if not isinstance(san, str) or not san:
                errors.append(f"servers.webhookSans[{i}]: must be a non-empty DNS name")
    tas = cfg.topology_aware_scheduling
    seen_domains: set[str] = set()
    for i, lvl in enumerate(tas.levels):
        if not isinstance(lvl, dict) or "domain" not in lvl or "nodeLabelKey" not in lvl:
            errors.append(
                f"topologyAwareScheduling.levels[{i}]: want {{domain, nodeLabelKey}}"
            )
            continue
        if lvl["domain"] in seen_domains:
            errors.append(
                f"topologyAwareScheduling.levels[{i}]: duplicate domain {lvl['domain']!r}"
            )
        seen_domains.add(lvl["domain"])
    if tas.levels:
        try:
            cfg.cluster_topology()
        except Exception as e:
            errors.append(f"topologyAwareScheduling.levels: {e}")
    if cfg.persistence.enabled and not cfg.persistence.path:
        errors.append("persistence.path: required when persistence is enabled")
    ce = cfg.cells
    if not isinstance(ce.count, int) or isinstance(ce.count, bool) or ce.count < 1:
        errors.append("cells.count: must be an int >= 1")
    if ce.shard_by not in ("queue", "topology"):
        errors.append(f"cells.shardBy: {ce.shard_by!r} not in queue|topology")
    if (
        not isinstance(ce.crash_check_every, int)
        or isinstance(ce.crash_check_every, bool)
        or ce.crash_check_every < 1
    ):
        errors.append("cells.crashCheckEvery: must be an int >= 1")
    if ce.enabled:
        if not ce.journal_root:
            errors.append("cells.journalRoot: required when cells are enabled")
        if not ce.lease_dir:
            errors.append("cells.leaseDir: required when cells are enabled")
        if ce.renew_deadline_seconds >= ce.lease_duration_seconds:
            errors.append(
                "cells.renewDeadlineSeconds: must be < leaseDurationSeconds"
            )
    import re as _re

    pcs_map = cfg.scheduling.priority_classes
    for pc_name in (pcs_map if isinstance(pcs_map, dict) else ()):
        # Rendered as cluster-scoped PriorityClass manifests (deploy.py):
        # the name must be a DNS-1123 subdomain or kubectl apply rejects
        # it (and a "/" would even break the --out file write).
        if not _re.fullmatch(r"[a-z0-9]([-a-z0-9.]*[a-z0-9])?", str(pc_name)):
            errors.append(
                f"scheduling.priorityClasses.{pc_name}: name must be a "
                "lowercase DNS-1123 subdomain"
            )
    if not isinstance(cfg.scheduling.queues, dict):
        errors.append("scheduling.queues: must be a mapping of name -> quotas")
    else:
        # Both queue shapes (legacy flat quotas and hierarchical
        # parentQueue/resources trees) validate through the one parser the
        # manager boots from — shape, quantities, weights, parent
        # existence, and cycles (orchestrator/queues.py).
        from grove_tpu_torch.orchestrator.queues import parse_queue_config

        parse_queue_config(cfg.scheduling.queues, errors)
    pf = cfg.solver.portfolio
    if not isinstance(pf, int) or isinstance(pf, bool) or pf < 1:
        errors.append("solver.portfolio: must be an int >= 1")
    pe = cfg.solver.portfolio_escalation
    if not isinstance(pe, int) or isinstance(pe, bool) or pe < 1:
        errors.append("solver.portfolioEscalation: must be an int >= 1 (1 = off)")
    pw = cfg.solver.prewarm_top_k
    if not isinstance(pw, int) or isinstance(pw, bool) or pw < 0:
        errors.append("solver.prewarmTopK: must be an int >= 0 (0 = off)")
    if pw > 0 and not cfg.solver.shape_history_path:
        errors.append(
            "solver.shapeHistoryPath: required when prewarmTopK > 0 "
            "(the prewarm thread compiles from the recorded shape history)"
        )
    if not isinstance(cfg.solver.weights, dict):
        errors.append("solver.weights: must be a mapping of weight -> number")
    elif cfg.solver.weights:
        import math as _math

        seen_weights: dict[str, str] = {}
        for wk, wv in cfg.solver.weights.items():
            field_name = _CAMEL_FIELDS.get(wk, wk)
            if field_name not in _WEIGHT_FIELDS:
                errors.append(f"solver.weights.{wk}: unknown weight")
                continue
            if field_name in seen_weights:
                errors.append(
                    f"solver.weights.{wk}: duplicate of "
                    f"{seen_weights[field_name]!r} after case normalization"
                )
                continue
            seen_weights[field_name] = wk
            if not isinstance(wv, (int, float)) or isinstance(wv, bool) or not _math.isfinite(float(wv)):
                errors.append(f"solver.weights.{wk}: {wv!r} is not a finite number")
    pr = cfg.solver.pruning
    if not isinstance(pr, dict):
        errors.append("solver.pruning: must be a mapping")
    elif pr:
        _PRUNING_KEYS = {
            "enabled", "maxCandidates", "padLadder", "minPad", "minFleet",
        }
        for pk in pr:
            if pk not in _PRUNING_KEYS:
                errors.append(f"solver.pruning.{pk}: unknown field")
        if "enabled" in pr and not isinstance(pr["enabled"], bool):
            errors.append("solver.pruning.enabled: must be a boolean")
        for pk, lo in (("maxCandidates", 1), ("minPad", 2), ("minFleet", 0)):
            if pk in pr and (
                not isinstance(pr[pk], int)
                or isinstance(pr[pk], bool)
                or pr[pk] < lo
            ):
                errors.append(f"solver.pruning.{pk}: must be an int >= {lo}")
        ladder = pr.get("padLadder")
        if ladder is not None:
            if not isinstance(ladder, list) or any(
                not isinstance(v, int) or isinstance(v, bool) or v < 2
                for v in ladder
            ):
                errors.append(
                    "solver.pruning.padLadder: must be a list of ints >= 2"
                )
            elif any(b <= a for a, b in zip(ladder, ladder[1:])):
                errors.append(
                    "solver.pruning.padLadder: must be strictly increasing"
                )
    sm = cfg.solver.streaming
    if not isinstance(sm, dict):
        errors.append("solver.streaming: must be a mapping")
    elif sm:
        _STREAM_KEYS = {"depth", "waveSize", "maxWaitS", "pollS"}
        for sk in sm:
            if sk not in _STREAM_KEYS:
                errors.append(f"solver.streaming.{sk}: unknown field")
        for sk in ("depth", "waveSize"):
            if sk in sm and (
                not isinstance(sm[sk], int)
                or isinstance(sm[sk], bool)
                or sm[sk] < 1
            ):
                errors.append(f"solver.streaming.{sk}: must be an int >= 1")
        if "maxWaitS" in sm and (
            not isinstance(sm["maxWaitS"], (int, float))
            or isinstance(sm["maxWaitS"], bool)
            or sm["maxWaitS"] < 0
        ):
            errors.append("solver.streaming.maxWaitS: must be >= 0")
        if "pollS" in sm and (
            not isinstance(sm["pollS"], (int, float))
            or isinstance(sm["pollS"], bool)
            or sm["pollS"] <= 0
        ):
            errors.append("solver.streaming.pollS: must be > 0")
    sc = cfg.solver.scan
    if not isinstance(sc, dict):
        errors.append("solver.scan: must be a mapping")
    elif sc:
        _SCAN_KEYS = {
            "enabled",
            "maxScanLen",
            "minWavesPerClass",
            "affinityLookahead",
            "deviceResident",
        }
        for ck in sc:
            if ck not in _SCAN_KEYS:
                errors.append(f"solver.scan.{ck}: unknown field")
        for ck in ("enabled", "deviceResident"):
            if ck in sc and not isinstance(sc[ck], bool):
                errors.append(f"solver.scan.{ck}: must be a boolean")
        for ck in ("maxScanLen", "minWavesPerClass"):
            if ck in sc and (
                not isinstance(sc[ck], int)
                or isinstance(sc[ck], bool)
                or sc[ck] < 1
            ):
                errors.append(f"solver.scan.{ck}: must be an int >= 1")
        if "affinityLookahead" in sc and (
            not isinstance(sc["affinityLookahead"], int)
            or isinstance(sc["affinityLookahead"], bool)
            or sc["affinityLookahead"] < 0
        ):
            errors.append("solver.scan.affinityLookahead: must be an int >= 0")
    mh = cfg.solver.mesh
    if not isinstance(mh, dict):
        errors.append("solver.mesh: must be a mapping")
    elif mh:
        _MESH_KEYS = {"enabled", "minNodes", "maxDevices"}
        for mk in mh:
            if mk not in _MESH_KEYS:
                errors.append(f"solver.mesh.{mk}: unknown field")
        if "enabled" in mh and not isinstance(mh["enabled"], bool):
            errors.append("solver.mesh.enabled: must be a boolean")
        for mk in ("minNodes", "maxDevices"):
            if mk in mh and (
                not isinstance(mh[mk], int)
                or isinstance(mh[mk], bool)
                or mh[mk] < 0
            ):
                errors.append(f"solver.mesh.{mk}: must be an int >= 0")
    df = cfg.defrag
    if not isinstance(df.threshold, (int, float)) or isinstance(
        df.threshold, bool
    ) or not 0.0 <= float(df.threshold) <= 1.0:
        errors.append("defrag.threshold: must be a number in [0, 1]")
    if not isinstance(df.interval_seconds, (int, float)) or isinstance(
        df.interval_seconds, bool
    ) or df.interval_seconds <= 0:
        errors.append("defrag.intervalSeconds: must be > 0")
    mc = df.max_concurrent_migrations
    if not isinstance(mc, int) or isinstance(mc, bool) or mc < 1:
        errors.append("defrag.maxConcurrentMigrations: must be an int >= 1")
    if not isinstance(df.gang_cooldown_seconds, (int, float)) or isinstance(
        df.gang_cooldown_seconds, bool
    ) or df.gang_cooldown_seconds < 0:
        errors.append("defrag.gangCooldownSeconds: must be >= 0")
    mm = df.max_moves_per_plan
    if not isinstance(mm, int) or isinstance(mm, bool) or mm < 1:
        errors.append("defrag.maxMovesPerPlan: must be an int >= 1")
    if not isinstance(df.min_efficiency, (int, float)) or isinstance(
        df.min_efficiency, bool
    ) or df.min_efficiency < 0:
        errors.append("defrag.minEfficiency: must be >= 0")
    ro = cfg.rollout
    if not isinstance(ro.surge_racks, int) or isinstance(
        ro.surge_racks, bool
    ) or ro.surge_racks < 0:
        errors.append("rollout.surgeRacks: must be an int >= 0")
    for ro_name, ro_val in (
        ("rollout.backoffBaseSeconds", ro.backoff_base_seconds),
        ("rollout.backoffCapSeconds", ro.backoff_cap_seconds),
        ("rollout.deadlineSeconds", ro.deadline_seconds),
    ):
        if not isinstance(ro_val, (int, float)) or isinstance(
            ro_val, bool
        ) or ro_val <= 0:
            errors.append(f"{ro_name}: must be a number > 0")
    if (
        isinstance(ro.backoff_base_seconds, (int, float))
        and isinstance(ro.backoff_cap_seconds, (int, float))
        and not isinstance(ro.backoff_base_seconds, bool)
        and not isinstance(ro.backoff_cap_seconds, bool)
        and ro.backoff_cap_seconds < ro.backoff_base_seconds
    ):
        errors.append(
            "rollout.backoffCapSeconds: must be >= rollout.backoffBaseSeconds"
        )
    tn = cfg.tenancy
    if not isinstance(tn.aging_half_life_seconds, (int, float)) or isinstance(
        tn.aging_half_life_seconds, bool
    ) or tn.aging_half_life_seconds <= 0:
        errors.append("tenancy.agingHalfLifeSeconds: must be > 0")
    if not isinstance(tn.aging_max_boost, int) or isinstance(
        tn.aging_max_boost, bool
    ) or tn.aging_max_boost < 0:
        errors.append("tenancy.agingMaxBoost: must be an int >= 0")
    tr = cfg.trace
    if tr.enabled and not tr.path:
        errors.append("trace.path: required when trace is enabled")
    for tname, tval in (
        ("trace.maxRecordsPerFile", tr.max_records_per_file),
        ("trace.maxFiles", tr.max_files),
        ("trace.queueSize", tr.queue_size),
    ):
        if not isinstance(tval, int) or isinstance(tval, bool) or tval < 1:
            errors.append(f"{tname}: must be an int >= 1")
    if not isinstance(tr.flush_interval_seconds, (int, float)) or isinstance(
        tr.flush_interval_seconds, bool
    ) or tr.flush_interval_seconds <= 0:
        errors.append("trace.flushIntervalSeconds: must be > 0")
    tu = cfg.tuning
    for tu_name, tu_val in (
        ("tuning.gridK", tu.grid_k),
        ("tuning.halvingRungs", tu.halving_rungs),
    ):
        if not isinstance(tu_val, int) or isinstance(tu_val, bool) or tu_val < 1:
            errors.append(f"{tu_name}: must be an int >= 1")
    import math as _tmath

    if not isinstance(tu.spread, (int, float)) or isinstance(
        tu.spread, bool
    ) or not _tmath.isfinite(float(tu.spread)) or tu.spread <= 0:
        errors.append("tuning.spread: must be a finite number > 0")
    if not isinstance(tu.seed, int) or isinstance(tu.seed, bool) or tu.seed < 0:
        errors.append("tuning.seed: must be an int >= 0")
    if not isinstance(tu.audit_seeds, list) or any(
        not isinstance(s, int) or isinstance(s, bool) for s in tu.audit_seeds
    ):
        errors.append("tuning.auditSeeds: must be a list of ints")
    fa = cfg.faults
    if not isinstance(fa.seed, int) or isinstance(fa.seed, bool) or fa.seed < 0:
        errors.append("faults.seed: must be an int >= 0")
    if not isinstance(fa.sites, dict):
        errors.append("faults.sites: must be a mapping of site -> schedule")
    else:
        # Site names and schedule shapes validate through the injector's
        # own parser — the chaos rig and the config cannot drift.
        from grove_tpu_torch.faults import SITES, parse_spec_entry

        for site, doc in fa.sites.items():
            if site not in SITES:
                errors.append(
                    f"faults.sites.{site}: unknown site; one of "
                    + "|".join(SITES)
                )
                continue
            try:
                parse_spec_entry(site, doc)
            except ValueError as e:
                errors.append(f"faults.sites.{e}")
    rs = cfg.resilience
    for rname, rval, lo in (
        ("resilience.watchdogSeconds", rs.watchdog_seconds, 0.0),
        ("resilience.breakerWindowSeconds", rs.breaker_window_seconds, 0.0),
        ("resilience.probationSeconds", rs.probation_seconds, 0.0),
        ("resilience.backoffBaseSeconds", rs.backoff_base_seconds, 0.0),
    ):
        if not isinstance(rval, (int, float)) or isinstance(rval, bool) or rval <= lo:
            errors.append(f"{rname}: must be a number > {lo:g}")
    for rname, rval, lo in (
        ("resilience.maxWaveRetries", rs.max_wave_retries, 0),
        ("resilience.breakerThreshold", rs.breaker_threshold, 1),
        ("resilience.bindMaxAttempts", rs.bind_max_attempts, 1),
    ):
        if not isinstance(rval, int) or isinstance(rval, bool) or rval < lo:
            errors.append(f"{rname}: must be an int >= {lo}")
    if not isinstance(rs.backoff_cap_seconds, (int, float)) or isinstance(
        rs.backoff_cap_seconds, bool
    ) or (
        isinstance(rs.backoff_base_seconds, (int, float))
        and not isinstance(rs.backoff_base_seconds, bool)
        and rs.backoff_cap_seconds < rs.backoff_base_seconds
    ):
        errors.append(
            "resilience.backoffCapSeconds: must be a number >= "
            "backoffBaseSeconds"
        )
    eb = cfg.controllers.events_buffer
    if not isinstance(eb, int) or isinstance(eb, bool) or eb < 1:
        errors.append("controllers.eventsBuffer: must be an int >= 1")
    hd = cfg.controllers.heal_event_dedupe_seconds
    if not isinstance(hd, (int, float)) or isinstance(hd, bool) or hd < 0:
        errors.append(
            "controllers.healEventDedupeSeconds: must be >= 0 (0 = off)"
        )
    cl = cfg.cluster
    if cl.initc_mode not in ("operator", "kubernetes"):
        errors.append(
            f"cluster.initcMode: {cl.initc_mode!r} not in operator|kubernetes"
        )
    if cl.initc_mode == "kubernetes" and cl.source != "kubernetes":
        errors.append(
            "cluster.initcMode: kubernetes requires cluster.source: kubernetes "
            "(the agent lists gang pods at the apiserver)"
        )
    if cl.source not in ("none", "kwok", "kubernetes"):
        errors.append(
            f"cluster.source: {cl.source!r} not in none|kwok|kubernetes"
        )
    if not isinstance(cl.kube_qps, (int, float)) or isinstance(
        cl.kube_qps, bool
    ) or cl.kube_qps < 0:
        errors.append("cluster.kubeQps: must be a number >= 0 (0 = unlimited)")
    if not isinstance(cl.kube_burst, int) or isinstance(
        cl.kube_burst, bool
    ) or cl.kube_burst < 0:
        errors.append("cluster.kubeBurst: must be an int >= 0")
    elif (
        isinstance(cl.kube_qps, (int, float))
        and not isinstance(cl.kube_qps, bool)
        and cl.kube_qps > 0
        and cl.kube_burst < 1
    ):
        errors.append(
            "cluster.kubeBurst: must be >= 1 when kubeQps > 0 (a zero-token "
            "bucket would block every request forever)"
        )
    if cl.source == "kubernetes" and cl.kubeconfig:
        import os as _os

        if not _os.path.exists(cl.kubeconfig):
            errors.append(f"cluster.kubeconfig: {cl.kubeconfig!r} does not exist")
    if cl.source == "kwok":
        if cl.kwok_nodes < 1:
            errors.append("cluster.kwokNodes: must be >= 1")
        if cl.kwok_hosts_per_rack < 1 or cl.kwok_racks_per_block < 1:
            errors.append(
                "cluster.kwokHostsPerRack/kwokRacksPerBlock: must be >= 1"
            )
        if cl.running_delay_seconds < 0 or cl.ready_delay_seconds < 0:
            errors.append(
                "cluster.runningDelaySeconds/readyDelaySeconds: must be >= 0"
            )
        if cl.event_lag_seconds < 0:
            errors.append("cluster.eventLagSeconds: must be >= 0")
        if not isinstance(cl.revocable_nodes, int) or isinstance(
            cl.revocable_nodes, bool
        ) or cl.revocable_nodes < 0 or (
            isinstance(cl.kwok_nodes, int) and cl.revocable_nodes > cl.kwok_nodes
        ):
            errors.append(
                "cluster.revocableNodes: must be an int in [0, kwokNodes]"
            )
        if not isinstance(cl.revocable_grace_seconds, (int, float)) or isinstance(
            cl.revocable_grace_seconds, bool
        ) or cl.revocable_grace_seconds <= 0:
            errors.append("cluster.revocableGraceSeconds: must be > 0")
        if not isinstance(
            cl.revocable_eviction_lead_seconds, (int, float)
        ) or isinstance(
            cl.revocable_eviction_lead_seconds, bool
        ) or cl.revocable_eviction_lead_seconds < 0:
            errors.append("cluster.revocableEvictionLeadSeconds: must be >= 0")
        if (
            cl.kwok_cpu_per_node < 0
            or cl.kwok_memory_per_node < 0
            or cl.kwok_tpu_per_node < 0
        ):
            errors.append(
                "cluster.kwokCpuPerNode/kwokMemoryPerNode/kwokTpuPerNode: "
                "must be >= 0"
            )
        factors = cl.kwok_level_group_factors
        if not isinstance(factors, list) or any(
            not isinstance(fct, int) or isinstance(fct, bool) or fct < 1
            for fct in factors
        ):
            errors.append(
                "cluster.kwokLevelGroupFactors: must be a list of ints >= 1"
            )
        else:
            from grove_tpu_torch.api.types import TopologyDomain

            try:
                non_host = [
                    lvl
                    for lvl in cfg.cluster_topology().sorted_levels()
                    if lvl.domain != TopologyDomain.HOST
                ]
            except Exception:
                non_host = []  # reported above via topologyAwareScheduling
            # The default rack/block/zone shape keeps its implicit factors
            # (zone groups 4 blocks, the e2e rig's shape); anything DEEPER
            # must spell out every factor beyond block — a 5-level hierarchy
            # silently shaped by a hardcoded 4 is a fleet nobody asked for.
            extra = len(non_host) - 2
            if len(non_host) > 3 and extra > len(factors):
                errors.append(
                    f"cluster.kwokLevelGroupFactors: topology declares {extra} "
                    "level(s) beyond rack/block; list a group factor for each "
                    "(narrowest first) — hierarchies deeper than zone get no "
                    "implicit shape"
                )
    return errors


def load_operator_config(path: str) -> OperatorConfiguration:
    """YAML file -> validated config; raises ValueError listing every problem
    (LoadAndValidateOperatorConfig boot contract, cmd/cli/cli.go)."""
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: config root must be a mapping")
    cfg, errors = parse_operator_config(doc)
    if errors:
        raise ValueError(f"{path}: invalid operator config:\n  " + "\n  ".join(errors))
    return cfg
