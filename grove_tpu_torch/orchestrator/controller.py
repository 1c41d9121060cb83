"""The reconcile cascade: PCS → cliques/PCSGs/gangs/pods → solver → bindings
(grove_tpu/orchestrator/controller.py counterpart, whole).

Rebuilds the reference's three controllers (SURVEY.md §3.3) as one pass-based
engine over the in-memory store:

  reconcile(now)
  ├─ sync_workloads      — expansion diff: create/delete cliques, PCSGs, gangs,
  │                        pods (stable index fill, deletion sort), refresh
  │                        PodGroup pod references
  ├─ rolling_updates     — generation-hash change → one PCS replica at a time,
  │                        priority: unscheduled → breached → ordinal
  │                        (podcliquesetreplica/rollingupdate.go:39-223)
  ├─ solve_pending       — encode gangs with gated pods → solver → bind
  │                        admitted gangs' pods (replaces gate-removal + KAI
  │                        bind, podclique/components/pod/syncflow.go:242-301)
  ├─ update_statuses     — clique/PCSG/gang/PCS condition rollup (status.py)
  └─ gang_termination    — MinAvailableBreached > TerminationDelay ⇒ delete the
                           PCS replica's cliques; recreated next pass
                           (gangterminate.go:67-213)

Incremental re-solve: a partially scheduled gang is encoded with only its
gated pods and each group's floor reduced by already-bound pods, against a
snapshot that accounts existing bindings — no global re-solve (SURVEY.md §7
"incrementality").

Device: every solve of the cascade (the serving waves, the defrag and
revocation planners, the make-before-break rollout) runs on `device` — None
means the card, "cpu" the plain PyTorch versions. The snapshot, the encoded
batch and every digest stay numpy on the host; a solve's verdicts, scores
and assignments come back in one copy per solve (`fetch_result`), the tick's
only synchronisation with the card.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

from grove_tpu_torch.api import constants, naming
from grove_tpu_torch.api.pod import Pod, PodPhase
from grove_tpu_torch.api.podgang import NamespacedName, PodGang
from grove_tpu_torch.api.types import (
    ClusterTopology,
    PodCliqueSet,
    PodCliqueSetRollingUpdateProgress,
)
from grove_tpu_torch.orchestrator import expansion as exp
from grove_tpu_torch.orchestrator.status import (
    clique_breached_since,
    compute_pcs_status,
    compute_pcsg_status,
    compute_podclique_status,
    compute_podgang_status,
    clique_rolling_state,
    pcsg_breached_since,
    sync_pcsg_rolling_progress,
)
from grove_tpu_torch.orchestrator.queues import QueueTree
from grove_tpu_torch.orchestrator.store import Cluster
from grove_tpu_torch.solver.core import SolverParams, decode_bindings, fetch_result, \
    resolve_device, solve
from grove_tpu_torch.solver.encode import encode_gangs, next_pow2
from grove_tpu_torch.solver.escalation import EscalationDamper, node_state_digest
from grove_tpu_torch.solver.planner import (
    build_pending_subgang,
    build_spread_avoid,
    sort_pending,
)
from grove_tpu_torch.solver.warm import WarmPath
from grove_tpu_torch.state.cluster import build_snapshot
from grove_tpu_torch.tenancy import (
    TenantLedger,
    aging_boost,
    slo_borrow_eligible,
    slo_rank,
)


@dataclass
class GroveController:
    cluster: Cluster
    topology: ClusterTopology
    solver_params: SolverParams = field(default_factory=SolverParams)
    # Where every solve runs: None = the card (raises without one), "cpu" =
    # the plain PyTorch versions. There is no fallback between the two.
    device: object = None
    tas_enabled: bool = True
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    # priority class name -> numeric priority (PriorityClassName ordering)
    priority_classes: dict[str, int] = field(default_factory=dict)
    # bucketing knobs (recompilation control; see solver/encode.py)
    max_groups: int | None = None
    max_sets: int | None = None
    max_pods: int | None = None
    pad_gangs_to: int | None = None
    # candidate-node pruning (solver.pruning config -> pruning_config()):
    # when set, per-tick solves and defrag planning solves run on the
    # gathered candidate sub-fleet with exactness escalation — the launch
    # cache then keys on the candidate pad, not the fleet pad
    # (solver/pruning.py; stats on warm.prune)
    pruning: object | None = None
    # mesh-sharded solve (solver.mesh config; parallel/mesh.MeshConfig): each
    # single-variant solve shards over the negotiated layout (B7 on the
    # card, over virtual shards of it); an enabled mesh that resolves to no
    # layout is a counted fallback (parallel/mesh.shard_fallbacks)
    mesh_cfg: object | None = None
    # portfolio width: >1 solves each wave under P weight variants, winner
    # kept (solver.portfolio; parallel/portfolio.py)
    portfolio: int = 1
    # rejection escalation (solver.portfolioEscalation): a portfolio=1 solve
    # that rejects valid gangs is retried once under P variants — packing
    # artifacts get fixed through the DEFAULT serving path, uncontended
    # passes pay nothing
    portfolio_escalation: int = 4
    # MNNVL-analog TPU-slice injection (networkAcceleration config section)
    auto_slice_enabled: bool = False
    slice_resource_name: str = "google.com/tpu"
    # servers.advertiseUrl: the injected initc agent's --server ("" = the
    # agent's localhost default; real clusters need the operator Service URL)
    initc_server_url: str = ""
    # cluster.initcMode: operator (poll the operator API) | kubernetes
    # (agent lists gang pods at the apiserver directly)
    initc_mode: str = "operator"
    # Preemption flap guard: a gang whose rejection is NOT capacity-caused
    # (e.g. a required rack that can never fit it) must not evict fresh
    # victims every pass — one preemption attempt per contender per window.
    preemption_cooldown_seconds: float = 30.0
    _preempted_for_at: dict = field(default_factory=dict)
    # set by the floors wave when some gang has gated pods beyond its floor;
    # gates the extras wave (see solve_pending)
    _extras_candidates: bool = False
    # Capacity queues (scheduling.queues; hierarchical KAI Queue analog,
    # orchestrator/queues.py): a QueueTree, or a legacy flat
    # {name: {resource: quota-or--1}} map (normalized by the queue_tree
    # property); gangs opt in via the grove.io/queue annotation (expansion
    # stamps PodGang.queue).
    queues: object = field(default_factory=dict)
    # Event dedupe for quota-blocked gangs (one event per block episode).
    _quota_blocked: set = field(default_factory=set)
    # Floors wave's post-grant hierarchical usage map, consumed by the
    # extras wave (see solve_pending) — saves a full pod scan per pass.
    _queue_usage_carry: dict | None = None
    # Reclaim flap guard (same discipline as _preempted_for_at): one
    # reclaim attempt per in-quota contender per cooldown window.
    _reclaimed_for_at: dict = field(default_factory=dict)
    # Solve-skip memo, per wave kind: (input fingerprint, retry_at,
    # valid-rejected names) of the last no-effect pass — see the wave_fp
    # block in _solve_wave.
    _solve_skip_memo: dict = field(default_factory=dict)
    # Observability: how each solve wave resolved — "full" (complete
    # encode+solve), "delta" (incremental arrivals-only), "skipped"
    # (fingerprint match, no work). The manager exports these as
    # grove_solve_passes_total{kind=...}.
    solve_pass_counts: dict = field(
        default_factory=lambda: {"full": 0, "delta": 0, "skipped": 0}
    )
    # PlacementScores of gangs first-admitted in the LAST solve_pending pass
    # (GREP-244 metrics direction) — the manager drains this into the
    # grove_placement_score histogram each reconcile.
    last_admission_scores: list = field(default_factory=list)
    # Host-stage split of the last solve pass (wall seconds): encode (host
    # dense encode incl. row-cache traffic), solve (device dispatch+wait),
    # decode (batch binding decode) — the serving-path slice of the drain's
    # host-stage ledger (/statusz solver.hostStages, `get solver` rows).
    last_host_stages: dict = field(default_factory=dict)
    # Node-axis shards the last solve ran across (0 = unsharded): /statusz
    # solver.mesh shardDevices.
    last_shard_devices: int = 0
    # Placement-quality view of serving solves (quality/report.py
    # discipline): the last NON-EMPTY wave's aggregate — admitted ratio over
    # the solver-valid gangs it saw, mean PlacementScore of the admitted —
    # plus cumulative counters. Surfaced on /statusz "quality", the
    # grove_placement_quality_* gauges, and `grove-tpu get quality`.
    quality_last: dict = field(default_factory=dict)
    quality_counts: dict = field(
        default_factory=lambda: {
            "waves": 0,
            "gangs": 0,
            "admitted": 0,
            "score_sum": 0.0,
        }
    )
    # First-admissions of the current pass (floors wave), so the extras wave
    # can't double-count them (see solve_pending).
    _admitted_this_pass: set = field(default_factory=set)
    # Futile-escalation damper, keyed per wave kind (floors/extras): while
    # the solver-input state matches the last pass whose ESCALATED solve
    # still rejected valid gangs, re-escalating is a guaranteed no-op, so a
    # saturated steady state pays base-solve cost per reconcile. Definition
    # shared with the backend sidecar (solver/escalation.py).
    _escalation_damper: EscalationDamper = field(default_factory=EscalationDamper)
    # Warm-path caches (solver/warm.py), one per controller: the launch
    # cache (one prepared launch per shape, replayed as a CUDA graph;
    # observable lowering counters + prewarm), device-resident node tensors
    # across ticks, and per-gang encode-row reuse.
    warm: WarmPath = field(default_factory=WarmPath)
    # Defragmentation & rebalance loop (solver/defrag.py; config section
    # `defrag`): when the fragmentation score crosses the threshold, the
    # batched migration planner re-places movable gangs (cluster minus their
    # own usage, through the SAME warm path as serving solves) and this
    # controller executes the winning plan's moves under a disruption budget
    # — at most `defrag_max_concurrent` gangs migrating at once, one
    # migration per gang per cooldown window, make-before-break: a gang's
    # target capacity is verified free while its old placement still holds,
    # then the whole gang rebinds atomically (gang semantics preserved).
    defrag_enabled: bool = False
    defrag_threshold: float = 0.5
    defrag_interval_seconds: float = 30.0
    defrag_max_concurrent: int = 1
    defrag_cooldown_seconds: float = 300.0
    defrag_max_moves: int = 8
    defrag_min_efficiency: float = 0.0
    # Decision flight recorder (grove_tpu/trace; config section `trace`):
    # when set, every solve wave's input closure + resulting plan and every
    # disruptive action (preemption, reclaim, defrag migration, rolling
    # update, gang termination) is journaled for deterministic replay and
    # what-if counterfactuals. Tracing is observability: a recorder failure
    # must never break serving, so every hook is exception-contained.
    recorder: object | None = None
    # Graceful-degradation ladder (solver/resilience.DegradationLadder),
    # shared with the manager/stream drivers: per-tick solves consult the
    # breaker states (portfolio -> single, mesh -> unsharded, pruned ->
    # dense), a failed solve retries once fully degraded and charges the
    # ladder, and the bind commit path gains retire-time stale-plan
    # revalidation + all-or-nothing gang bind with rollback. None = the
    # pre-resilience behavior exactly.
    resilience: object | None = None
    # Fault-recovery counters the manager exports (grove_bind_rollbacks_
    # total etc.); monotonic, delta-exported like defrag_counts.
    resilience_counts: dict = field(
        default_factory=lambda: {
            "bind_rollbacks": 0,
            "stale_plan_requeues": 0,
            "solve_degraded_retries": 0,
        }
    )
    # Tenancy subsystem (config section `tenancy`; grove_tpu/tenancy,
    # docs/design.md "Multi-tenant SLO tiers"): SLO tiers lead the
    # admission order (latency < standard < batch-preemptible), `latency`
    # gangs never ride borrowed capacity, starved contenders climb
    # effective priority on a deterministic aging ladder, reclaim
    # evictions share the defrag disruption budget, and a per-tenant
    # fairness ledger feeds /statusz tenancy + grove_tenancy_* metrics +
    # `grove-tpu get tenancy`. Disabled = the pre-tenancy behavior exactly.
    tenancy_enabled: bool = False
    tenancy_aging_half_life_seconds: float = 300.0
    tenancy_aging_max_boost: int = 4
    # Pending-since stamps (gang name -> first reconcile time seen pending)
    # feeding the aging boost; entries leave with the gang (churn-pruned
    # every pass alongside the flap guards) or when it stops pending.
    _pending_since: dict = field(default_factory=dict)
    # Current aging boost per pending gang — refreshed once per floors wave
    # so every consumer of _priority_of inside one pass sees one value; a
    # step up is journaled as a `tenancy.aging` action with its inputs.
    _aging_boost: dict = field(default_factory=dict)
    # Reclaim transactions in flight: victim gang -> (contender, start).
    # Counted WITH _defrag_migrating against defrag_max_concurrent (the one
    # disruption budget); an entry clears when the contender binds, the
    # victim is whole again, or either departs.
    _reclaim_evicting: dict = field(default_factory=dict)
    # Per-tenant fairness accounting (tenant = capacity queue).
    tenancy_ledger: TenantLedger = field(default_factory=TenantLedger)
    # Gangs mid-migration (name -> start time); a migration completes when
    # every pod of the gang is scheduled and Ready again. This set IS the
    # disruption budget's denominator.
    _defrag_migrating: dict = field(default_factory=dict)
    # Per-gang cooldown stamps (name -> last migration start).
    _defrag_migrated_at: dict = field(default_factory=dict)
    # Next scheduled defrag evaluation (None = immediately when enabled).
    _defrag_next_at: float | None = None
    # Last tick's summary (score, report, plan) — /statusz + CLI surface.
    defrag_last: dict = field(default_factory=dict)
    # Monotonic counters the manager exports as metrics.
    defrag_counts: dict = field(
        default_factory=lambda: {
            "ticks": 0,
            "plans": 0,
            "migrations": 0,
            "migrations_completed": 0,
            "pods_migrated": 0,
            "capacity_recovered": 0.0,
            "skipped_budget": 0,
            "skipped_below_threshold": 0,
            "moves_deferred": 0,
        }
    )
    # Make-before-break rolling updates (orchestrator/rollout.py; config
    # section `rollout`): when enabled (globally or per-PCS via the
    # grove.io/rollout-strategy annotation), the current replica's stale
    # pods are replaced by planning the NEW generation onto capacity that
    # is free while the old placement still holds (plan_rescue with usage
    # held), then cutting over atomically through _bind_gang. Infeasible
    # replicas price "+surge racks" and "next candidate replica" what-ifs
    # through the trace engine's clone_racks, then defer whole on a
    # decorrelated-jitter backoff (utils/backoff.py); a spent deadline
    # falls back to the seed delete-then-recreate path. Off = the seed
    # behavior exactly (RU7-RU21 pin it).
    rollout_enabled: bool = False
    rollout_surge_racks: int = 1
    rollout_backoff_base_seconds: float = 0.5
    rollout_backoff_cap_seconds: float = 30.0
    rollout_deadline_seconds: float = 600.0
    # Retry/decision ledger the manager exports (grove_rollout_* metrics).
    rollout_counts: dict = field(
        default_factory=lambda: {
            "planned": 0,
            "cutovers": 0,
            "deferred_budget": 0,
            "deferred_capacity": 0,
            "replans": 0,
            "retries": 0,
            "whatifs": 0,
            "fallbacks": 0,
        }
    )
    # Per-(pcs, replica) backoff episodes: (Backoff, clock cell, retry_at).
    _rollout_backoff: dict = field(default_factory=dict)
    # Replicas mid-replacement ((pcs, replica) -> start); counted against
    # the shared disruption budget until the replica is whole again.
    _rollout_replacing: dict = field(default_factory=dict)
    # Last MBB decision per PCS — /statusz "rollout" + `get rollout`.
    rollout_last: dict = field(default_factory=dict)
    # Revocable capacity (docs/design.md "Fleet lifecycle"): nodes carrying
    # a revocation notice (Node.revocation_deadline) are handled within
    # grace — resident gangs migrate make-before-break through plan_rescue
    # under the shared disruption budget while time allows; inside the
    # eviction lead (or when no plan fits) residents are evicted in SLO
    # rank order, batch-preemptible first. Expired notices become node
    # deaths (the simulator enforces that).
    revocation_eviction_lead_seconds: float = 10.0
    revocation_counts: dict = field(
        default_factory=lambda: {
            "notices": 0,
            "migrated": 0,
            "evicted": 0,
            "migration_deferred": 0,
        }
    )
    # Nodes whose pending notice was already counted/journaled.
    _revocation_seen: set = field(default_factory=set)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # --- top-level pass ----------------------------------------------------------

    def reconcile(self, now: float) -> None:
        for pcs in list(self.cluster.podcliquesets.values()):
            self.sync_workload(pcs, now)
        self.rolling_updates(now)
        self.revocation_tick(now)
        self.solve_pending(now)
        self.update_statuses(now)
        self.gang_termination(now)
        self.maybe_defrag(now)

    # --- workload sync (PCS controller analog) -----------------------------------

    def compute_desired(self, pcs: PodCliqueSet, rng: random.Random | None = None):
        """Pure expansion for one PCS — no store mutation, safe to run on a
        worker thread (the manager parallelizes this across PCSes with the
        slow-start runner when controllers.concurrentSyncs > 1)."""
        c = self.cluster
        # The scale endpoint (POST /api/v1/scale) inserts into scale_overrides
        # from an HTTP handler thread; retry the snapshot on the rare
        # mid-iteration resize — same discipline as the manager's object-API
        # reads (dict writes are GIL-atomic, iteration is the racy part).
        for _ in range(8):
            try:
                overrides_snapshot = dict(c.scale_overrides)
                break
            except RuntimeError:
                continue
        else:
            overrides_snapshot = {}
        pcsg_names = {
            naming.scaling_group_name(pcs.metadata.name, i, cfg.name)
            for i in range(pcs.spec.replicas)
            for cfg in pcs.spec.template.pod_clique_scaling_group_configs
        }
        pcsg_overrides = {
            k: v for k, v in overrides_snapshot.items() if k in pcsg_names
        }
        pclq_overrides = overrides_snapshot
        return exp.expand_podcliqueset(
            pcs,
            self.topology,
            tas_enabled=self.tas_enabled,
            pcsg_replica_overrides=pcsg_overrides,
            pclq_replica_overrides=pclq_overrides,
            rng=rng if rng is not None else self.rng,
            auto_slice_enabled=self.auto_slice_enabled,
            slice_resource_name=self.slice_resource_name,
            initc_server_url=self.initc_server_url,
            initc_mode=self.initc_mode,
        )

    def sync_workload(self, pcs: PodCliqueSet, now: float, desired=None) -> None:
        c = self.cluster
        if desired is None:
            desired = self.compute_desired(pcs)

        # Auxiliary managed resources: upsert (spec refresh) + stale GC per
        # owning PCS (ordered kinds, reconcilespec.go:206-221). The single
        # exception: an EXISTING token secret keeps its token value across
        # re-syncs — it is a long-lived credential, not spec.
        sa, role, binding, secret = desired.rbac
        for coll, want in (
            (c.services, {o.name: o for o in desired.services}),
            (c.hpas, {o.name: o for o in desired.hpas}),
            (c.service_accounts, {sa.name: sa}),
            (c.roles, {role.name: role}),
            (c.role_bindings, {binding.name: binding}),
            (c.secrets, {secret.name: secret}),
        ):
            for name, obj in want.items():
                existing = coll.get(name)
                if existing is not None and coll is c.secrets:
                    obj.token = existing.token
                coll[name] = obj
            for name in [
                n
                for n, obj in coll.items()
                if getattr(obj, "pcs_name", None) == pcs.metadata.name and n not in want
            ]:
                del coll[name]

        desired_clique_names = {x.metadata.name for x in desired.podcliques}
        desired_pcsg_names = {x.metadata.name for x in desired.scaling_groups}
        desired_gang_names = {x.name for x in desired.podgangs}

        # Upsert scaling groups & cliques (spec refresh preserves status).
        for pcsg in desired.scaling_groups:
            existing = c.scaling_groups.get(pcsg.metadata.name)
            if existing is None:
                c.scaling_groups[pcsg.metadata.name] = pcsg
            else:
                existing.spec = pcsg.spec
        for clique in desired.podcliques:
            existing = c.podcliques.get(clique.metadata.name)
            if existing is None:
                c.podcliques[clique.metadata.name] = clique
                clique.status.current_pod_template_hash = exp.compute_pod_template_hash(
                    pcs.clique_template(clique.template_name),
                    pcs.spec.template.priority_class_name,
                )
            else:
                existing.spec = clique.spec
                existing.pod_gang_name = clique.pod_gang_name

        # Delete objects from scale-down / replica removal (cascades pods).
        for name in [n for n in c.podcliques if c.podcliques[n].pcs_name == pcs.metadata.name]:
            if name not in desired_clique_names:
                c.delete_clique_cascade(name)
        for name in [n for n in c.scaling_groups if c.scaling_groups[n].pcs_name == pcs.metadata.name]:
            if name not in desired_pcsg_names:
                del c.scaling_groups[name]
        for name in [g.name for g in c.gangs_of_pcs(pcs.metadata.name)]:
            if name not in desired_gang_names:
                del c.podgangs[name]

        # Upsert gangs (pod references are refreshed below).
        for gang in desired.podgangs:
            existing = c.podgangs.get(gang.name)
            if existing is None:
                c.podgangs[gang.name] = gang
            else:
                existing.spec.topology_constraint = gang.spec.topology_constraint
                existing.spec.topology_constraint_group_configs = (
                    gang.spec.topology_constraint_group_configs
                )
                # Annotations are mutable: a live gang must follow its PCS
                # to a new capacity queue or it would silently keep draining
                # the old queue's quota forever.
                existing.queue = gang.queue
                existing.spec.pod_groups = _merge_pod_groups(
                    existing.spec.pod_groups, gang.spec.pod_groups
                )

        # Pod diff per clique: stable indices, gated creation, deletion sort.
        gen_hash = exp.compute_generation_hash(pcs)
        for clique in desired.podcliques:
            live = c.podcliques[clique.metadata.name]
            self._sync_clique_pods(pcs, live, gen_hash, now)

        # Refresh PodGroup pod references from actual pods (sorted by index).
        for gang in c.gangs_of_pcs(pcs.metadata.name):
            for grp in gang.spec.pod_groups:
                pods = sorted(
                    (p for p in c.pods_of_clique(grp.name) if p.is_active),
                    key=lambda p: p.pod_index,
                )
                grp.pod_references = [NamespacedName(pcs.metadata.namespace, p.name) for p in pods]

    def _sync_clique_pods(self, pcs: PodCliqueSet, clique, gen_hash: str, now: float) -> None:
        c = self.cluster
        fqn = clique.metadata.name
        # GC terminal pods so replacements are created (failed pods don't count
        # toward replicas; the reference's pod component deletes them too).
        for pod in c.pods_of_clique(fqn):
            if not pod.is_active and pod.deletion_timestamp is None:
                self._release_pod(pod, now, reason=f"terminal phase {pod.phase.value}")
        active = [p for p in c.pods_of_clique(fqn) if p.is_active]
        want = clique.spec.replicas
        diff = want - len(active)
        clique_tmpl = pcs.clique_template(clique.template_name)
        if diff > 0:
            # Fill the lowest free hostname indices (internal/index/tracker.go:32-43).
            used = {p.pod_index for p in active}
            svc = naming.headless_service_name(pcs.metadata.name, clique.pcs_replica_index)
            new_indices = []
            i = 0
            while len(new_indices) < diff:
                if i not in used:
                    new_indices.append(i)
                i += 1
            pods = exp._build_pods(
                pcs,
                clique,
                clique_tmpl,
                svc,
                clique.pcs_replica_index,
                gen_hash,
                self.rng,
                tmpl_hash=exp.compute_pod_template_hash(
                    clique_tmpl, pcs.spec.template.priority_class_name
                ),
                pcsg_fqn=clique.pcsg_name,
                pcsg_replica=clique.pcsg_replica_index,
                base_podgang_name=(
                    c.podgangs[clique.pod_gang_name].base_podgang_name
                    if clique.pod_gang_name in c.podgangs
                    else None
                ),
                initc_server_url=self.initc_server_url,
                initc_mode=self.initc_mode,
            )
            # _build_pods makes spec.replicas pods indexed 0..n-1; keep only the
            # ones matching the free indices, re-pointing their index/hostname.
            inject_slice = exp.slice_injection_active(
                pcs, self.auto_slice_enabled
            ) and exp.template_requests_slice(clique_tmpl, self.slice_resource_name)
            for pod, idx in zip(pods[:diff], new_indices):
                pod.pod_index = idx
                pod.spec.hostname = naming.pod_hostname(fqn, idx)
                pod.name = naming.pod_name(fqn, self.rng)
                pod.env[constants.ENV_PCLQ_POD_INDEX] = str(idx)
                pod.labels[constants.LABEL_POD_INDEX] = str(idx)
                if inject_slice:
                    exp.inject_slice_claim(pod, self.slice_resource_name)
                c.pods[pod.name] = pod
                c.record_event(now, fqn, f"created pod {pod.name} (index {idx})")
        elif diff < 0:
            # Deletion sort: unscheduled first, then not-ready, then highest
            # index (podclique/components/pod/deletionsort.go).
            victims = sorted(
                active,
                key=lambda p: (p.is_scheduled, p.ready, -p.pod_index),
            )[: -diff]
            for pod in victims:
                self._release_pod(pod, now, reason="scale-down")

    def _release_pod(self, pod: Pod, now: float, reason: str) -> None:
        self.cluster.delete_pod(pod.name)
        self.cluster.record_event(now, pod.pclq_fqn, f"deleted pod {pod.name} ({reason})")

    # --- solver integration (scheduler-backend analog) ---------------------------

    def solve_pending(self, now: float) -> int:
        """Two solve waves: gang FLOORS first (the guarantee), best-effort
        extras second against leftover capacity.

        One combined wave would let an earlier gang's extras strand the
        capacity a later gang's floor needs — GS-7/GS-8 pin the reference
        behavior (gang_scheduling_test.go:537-786): every gang floor binds
        before ANY best-effort pod. Returns newly admitted gangs.

        The extras wave only runs when the floors pass saw at least one gang
        with gated pods beyond its floor (replicas > minAvailable is the
        exception, not the rule) — otherwise the second scan over every gang
        and pod is pure overhead at fleet scale."""
        self._extras_candidates = False
        self.last_admission_scores = []
        # Gangs first-admitted by THIS pass's floors wave. The extras wave's
        # scheduled_names is rebuilt from gang status, which update_statuses
        # only refreshes AFTER solve_pending — without this set, a gang
        # admitted in the floors wave and topped up in the same pass's extras
        # wave would re-enter the first-admission branch (duplicate admitted
        # event, floor score overwritten by the extras-only score).
        self._admitted_this_pass = set()
        # Prune quota-block dedupe entries for gangs that no longer exist
        # (rolling updates churn gang names; same discipline as
        # _preempted_for_at): a recreated namesake must event again.
        self._quota_blocked &= set(self.cluster.podgangs)
        # Prune the flap-guard cooldown maps here, EVERY pass — not only
        # inside the preempt/reclaim handlers, which a calm controller may
        # never call again: under tenant churn the departed-gang entries
        # otherwise accumulate without bound. Same for the tenancy
        # pending/aging stamps and in-flight reclaim ledger.
        live = self.cluster.podgangs
        for m in (
            self._preempted_for_at,
            self._reclaimed_for_at,
            self._pending_since,
            self._aging_boost,
            self._reclaim_evicting,
        ):
            for name in [n for n in m if n not in live]:
                del m[name]
        if self._reclaim_evicting:
            # Completion sweep every pass, not only on the reclaim/defrag
            # paths: a landed transaction must release its disruption slot
            # even when the controller goes calm afterward.
            self._sweep_reclaim_evictions()
        # One queue-usage scan per pass: the floors wave builds the
        # hierarchical usage map from live usage and leaves its post-grant
        # state here for the extras wave (a floor grant the SOLVER then
        # rejected makes the extras view conservative for one pass — extras
        # are best-effort and the next pass recomputes from real bindings).
        self._queue_usage_carry = None
        admitted = self._solve_wave(now, floors_only=True)
        if self._extras_candidates:
            self._solve_wave(now, floors_only=False)
        return admitted

    def _solve_wave(self, now: float, floors_only: bool) -> int:
        c = self.cluster
        pending: list[PodGang] = []
        for gang in c.podgangs.values():
            pods = [p for p in c.pods_of_gang(gang.name) if p.is_active]
            if pods and any(p.is_gated for p in pods):
                pending.append(gang)
        if not pending or not c.nodes:
            # No nodes: nothing can bind; an empty snapshot has no resource
            # axes and would crash encode (max over empty capacity matrix).
            return 0

        scheduled_names = {
            g.name for g in c.podgangs.values() if g.is_base_gang_scheduled() and g.spec.pod_groups
        }
        if self.tenancy_enabled and floors_only:
            # Refresh aging stamps once per pass (the floors wave): every
            # consumer of effective priority below — batch order, preemption
            # contender choice, reclaim ordering — sees one boost value.
            self._refresh_aging(pending, now)
        pending = sort_pending(
            pending,
            self._priority_of,
            # SLO tiers lead the batch order when tenancy is on: a latency
            # gang admits ahead of standard/batch regardless of priority.
            tier_of=self._slo_rank_of if self.tenancy_enabled else None,
        )

        # Capacity queues (the hierarchical KAI Queue analog,
        # orchestrator/queues.py): the pass works against a HIERARCHICAL
        # usage map — every queue's usage includes its descendants' — seeded
        # from bound usage; each grant charges the whole ancestor chain.
        # The floors wave builds it and leaves the charged map for the
        # extras wave.
        qtree = self.queue_tree
        qusage: dict | None = None
        if qtree is not None:
            if not floors_only and self._queue_usage_carry is not None:
                qusage = self._queue_usage_carry
            else:
                qusage = qtree.hierarchical_usage(self.queue_usage())
                self._queue_usage_carry = qusage

        # Partial gangs: encode only gated pods; floors shrink by bound pods
        # (shared discipline: solver/planner.py). Bound pods' node NAMES are
        # collected in the same pass (converted to snapshot indices below) so
        # required pack-sets of a re-solved remainder pin to the domain the
        # bound pods occupy.
        sub_gangs: list[PodGang] = []
        bound_node_names: dict[str, dict[str, list[str]]] = {}
        # Quota-grant staging: in-quota demands grant inline (in priority
        # order); over-quota demands wait in `borrowers` and retry with
        # borrowing afterward, overQuotaWeight-descending — deserved demand
        # of this pass beats borrowed, and heavier borrowers beat lighter.
        granted: list[tuple[int, PodGang, PodGang, dict]] = []
        borrowers: list[tuple[int, PodGang, PodGang, dict, dict]] = []
        # Gangs whose grant this wave rode borrowed capacity — the ledger's
        # borrowed-share input at first admission (tenancy only).
        borrow_granted: set[str] = set()
        order = 0
        for gang in pending:
            unbound_refs: dict[str, list[NamespacedName]] = {}
            bound_counts: dict[str, int] = {}
            per_group_nodes: dict[str, list[str]] = {}
            for grp in gang.spec.pod_groups:
                pods = [p for p in c.pods_of_clique(grp.name) if p.is_active]
                gated = [p for p in pods if p.is_gated]
                scheduled_pods = [p for p in pods if p.is_scheduled]
                if scheduled_pods:
                    per_group_nodes[grp.name] = [
                        p.node_name for p in scheduled_pods if p.node_name
                    ]
                bound_counts[grp.name] = len(scheduled_pods)
                if gated:
                    refs = [
                        NamespacedName(gang.namespace, p.name)
                        for p in sorted(gated, key=lambda p: p.pod_index)
                    ]
                    if floors_only:
                        # Encode ONLY up to the unmet floor; extras wait for
                        # the second wave.
                        needed = max(0, grp.min_replicas - len(scheduled_pods))
                        if len(refs) > needed:
                            self._extras_candidates = True
                        refs = refs[:needed]
                    if refs:
                        unbound_refs[grp.name] = refs
            if not floors_only and any(
                grp.min_replicas > bound_counts.get(grp.name, 0)
                for grp in gang.spec.pod_groups
            ):
                # Extras wave takes only gangs whose floors are MET: a
                # floor-rejected gang must not re-solve (guaranteed no-op
                # against the unchanged snapshot — it would double solver
                # cost in the contended steady state) and must never bind
                # extras before its floor.
                continue
            sub = build_pending_subgang(gang, unbound_refs, bound_counts)
            if sub is None:
                continue
            if qtree is not None and gang.queue and gang.queue in qtree.specs:
                # This wave's encode-set demand must fit the queue tree
                # (quota/limit along the ancestor chain) or the gang waits —
                # no solver cost; re-offered next pass as usage frees.
                demand: dict[str, float] = {}
                for refs in unbound_refs.values():
                    for ref in refs:
                        pod = c.pods.get(ref.name)
                        if pod is None:
                            continue
                        for res, qty in pod.spec.total_requests().items():
                            demand[res] = demand.get(res, 0.0) + qty
                if qtree.try_charge(
                    qusage, gang.queue, demand, allow_borrow=False
                ).admitted:
                    self._quota_blocked.discard(gang.name)
                    granted.append((order, gang, sub, per_group_nodes))
                else:
                    borrowers.append((order, gang, sub, per_group_nodes, demand))
            else:
                granted.append((order, gang, sub, per_group_nodes))
            order += 1
        reclaim_candidates: list[tuple[PodGang, dict, object]] = []
        if borrowers:
            borrowers.sort(
                key=lambda b: (-qtree.borrow_weight(b[1].queue, b[4]), b[0])
            )
            for order_i, gang, sub, pgn, demand in borrowers:
                if self.tenancy_enabled and not slo_borrow_eligible(
                    getattr(gang, "slo_class", "")
                ):
                    # `latency` gangs are in-quota only: no borrowing retry.
                    # Re-derive the hard-quota verdict — blocked at an
                    # ANCESTOR while in-quota at its own level means the
                    # tenant's deserved share is squeezed by borrowers, and
                    # that is exactly the reclaim case.
                    verdict = qtree.try_charge(
                        qusage, gang.queue, demand,
                        commit=False, allow_borrow=False,
                    )
                    if gang.name not in self._quota_blocked:
                        self._quota_blocked.add(gang.name)
                        c.record_event(
                            now,
                            gang.name,
                            f"gang waiting on queue {gang.queue!r} quota "
                            f"({verdict.blocked_reason} at "
                            f"{verdict.blocked_at!r}; sloClass latency "
                            "does not borrow)",
                        )
                    if verdict.reclaim_eligible:
                        reclaim_candidates.append((gang, demand, verdict))
                    continue
                verdict = qtree.try_charge(qusage, gang.queue, demand)
                if verdict.admitted:
                    self._quota_blocked.discard(gang.name)
                    granted.append((order_i, gang, sub, pgn))
                    if self.tenancy_enabled:
                        borrow_granted.add(gang.name)
                    continue
                if gang.name not in self._quota_blocked:
                    self._quota_blocked.add(gang.name)
                    c.record_event(
                        now,
                        gang.name,
                        f"gang waiting on queue {gang.queue!r} quota "
                        f"({verdict.blocked_reason} at {verdict.blocked_at!r})",
                    )
                if verdict.reclaim_eligible:
                    reclaim_candidates.append((gang, demand, verdict))
        # Solver batch order must stay the priority order (scaled gangs
        # behind their base, etc.) — re-sort grants by arrival index.
        for _, gang, sub, pgn in sorted(granted, key=lambda g: g[0]):
            sub_gangs.append(sub)
            if pgn:
                bound_node_names[gang.name] = pgn
        if reclaim_candidates and floors_only:
            # In-quota demand squeezed out by siblings' borrowing reclaims
            # the borrowed capacity (KAI reclaim) — floors only: best-effort
            # extras never evict anyone.
            self._reclaim_for_quota(reclaim_candidates, now)
        if not sub_gangs:
            return 0

        bound_pods = [p for p in c.pods.values() if p.is_scheduled and p.is_active]
        # Solve-skip damper: the batched solve is deterministic in its
        # inputs, so a pass whose input state matches the last pass that
        # admitted NOTHING and bound NOTHING will reproduce that outcome
        # exactly — skip the snapshot/encode/solve entirely. This is the
        # controller's steady-state saturation cost going to ~zero (and the
        # scenario suites' wall-clock with it). `retry_at` re-runs the pass
        # when a rejected contender's preemption cooldown expires — the one
        # time-driven effect a skipped solve would otherwise never retry.
        # The fingerprint covers everything the encode reads: ordered
        # pending subgangs (refs + template hashes + floors + queue +
        # priority), base-scheduled set, placements, full node state. It is
        # shared with the escalation damper. Placements are digested over
        # ALL pods holding a node_name — not just active ones — because the
        # reuse/spread seeds read inactive (Failed) pods' nodes too; a GC
        # of those pods changes solver inputs and must break the match.
        sub_digests = [self._sub_digest(sub) for sub in sub_gangs]
        wave_fp = (
            tuple(sub_digests),
            frozenset(scheduled_names),
            frozenset(
                (p.name, p.node_name, p.is_active)
                for p in c.pods.values()
                if p.node_name is not None
            ),
            node_state_digest(c.nodes.values()),
        )
        memo = self._solve_skip_memo.get(floors_only)
        carried: set | None = None
        carried_rejected: list[PodGang] = []
        if memo is not None and now < memo[1]:
            if memo[0] == wave_fp:
                self.solve_pass_counts["skipped"] += 1
                return 0
            if memo[0][1:] == wave_fp[1:] and set(memo[0][0]) <= set(
                wave_fp[0]
            ):
                # Incremental arrivals-only solve: placements, scheduled
                # set, and node state all match the memoized no-effect pass
                # and its pending gangs are a SUBSET of this pass's — the
                # carried gangs are provably still rejected (placement
                # feasibility is monotone in free capacity, which has not
                # grown), so only the new arrivals need encoding and
                # solving. A changed-by-arrival pass costs O(delta), not
                # O(pending). Any admission by the delta binds pods, which
                # changes the placement digest and forces the next pass to
                # run full.
                carried = set(memo[0][0])
        if carried is not None:
            kept = [i for i, d in enumerate(sub_digests) if d not in carried]
            if not kept:
                # Pure reorder of still-rejected gangs: same no-op outcome.
                # Refresh the memo so the next unchanged pass takes the
                # O(1) exact-match skip instead of re-deriving the subset.
                self._solve_skip_memo[floors_only] = (
                    wave_fp, memo[1], memo[2],
                )
                self.solve_pass_counts["skipped"] += 1
                return 0
            # A delta scaled gang needs its BASE at an earlier batch index
            # to encode as valid-rejected (encode's dependency rule) — a
            # carried base rides along and deterministically re-rejects.
            idx_of = {sub.name: i for i, sub in enumerate(sub_gangs)}
            keep_set = set(kept)
            for i in list(kept):
                base = sub_gangs[i].base_podgang_name
                if base is not None and base in idx_of:
                    keep_set.add(idx_of[base])
            kept = sorted(keep_set)
            # Preemption must see the FULL contender field: carried gangs
            # that were valid-rejected in the memoized pass (recorded
            # there) still outrank or contend with delta rejections.
            kept_idx = set(kept)
            carried_rejected = [
                sub_gangs[i]
                for i in range(len(sub_gangs))
                if i not in kept_idx and sub_gangs[i].name in memo[2]
            ]
            sub_gangs = [sub_gangs[i] for i in kept]
            sub_digests = [sub_digests[i] for i in kept]
            kept_names = {sub.name for sub in sub_gangs}
            bound_node_names = {
                k: v for k, v in bound_node_names.items() if k in kept_names
            }
        self.solve_pass_counts["delta" if carried is not None else "full"] += 1
        # Node axis bucketed to the next power of two (phantom rows are
        # unschedulable zero-capacity): node add/remove inside a bucket
        # reuses the prepared launch instead of preparing another — the
        # static-shape discipline every other solve axis already follows.
        snapshot = build_snapshot(
            list(c.nodes.values()),
            self.topology,
            bound_pods=bound_pods,
            pad_nodes_to=next_pow2(len(c.nodes)),
        )
        # ReuseReservationRef (podgang.go:65-71): a gang replacing another is
        # biased toward the old gang's nodes via the solver's w_reuse seed.
        reuse_nodes: dict[str, list[int]] = {}
        for gang in pending:
            ref = gang.spec.reuse_reservation_ref
            if ref is None:
                continue
            idxs = {
                snapshot.node_index(p.node_name)
                for p in c.pods_of_gang(ref.name)
                if p.node_name is not None and p.node_name in snapshot.node_index_map
            }
            if idxs:
                reuse_nodes[gang.name] = sorted(idxs)
        # Replica spread (topologySpreadDomain): seed each pending base gang
        # with the nodes its SIBLING replicas' pods occupy right now, so a
        # recreated/scaled-out replica prefers a domain no live sibling uses.
        # One grouping pass over bound pods, not a store scan per gang.
        spread_avoid: dict[str, list[int]] = {}
        spreading = [
            gang
            for gang in pending
            if gang.spec.spread_key is not None and gang.base_podgang_name is None
        ]
        if spreading:
            spread_pcs = {gang.pcs_name for gang in spreading}
            idxs_by_pcs_replica: dict[tuple[str, int], set[int]] = {}
            for other in c.podgangs.values():
                if other.pcs_name not in spread_pcs:
                    continue
                key = (other.pcs_name, other.pcs_replica_index)
                bucket = idxs_by_pcs_replica.setdefault(key, set())
                bucket.update(
                    snapshot.node_index(p.node_name)
                    for p in c.pods_of_gang(other.name)
                    if p.node_name is not None
                    and p.node_name in snapshot.node_index_map
                )
            spread_avoid = {
                name: sorted(idxs)
                for name, idxs in build_spread_avoid(
                    spreading, idxs_by_pcs_replica
                ).items()
            }
        # Convert the bound-pod node names collected above to snapshot indices.
        bound_nodes: dict[str, dict[str, list[int]]] = {}
        for gname, groups in bound_node_names.items():
            per_group = {
                grp: idxs
                for grp, names in groups.items()
                if (idxs := [
                    snapshot.node_index(nm)
                    for nm in names
                    if nm in snapshot.node_index_map
                ])
            }
            if per_group:
                bound_nodes[gname] = per_group
        pods_by_name = dict(c.pods)
        # pad_gangs_to buckets the gang axis (round up to the next multiple)
        # so recurring solve shapes reuse the compiled program.
        pad_to = None
        if self.pad_gangs_to:
            pad_to = self.pad_gangs_to * max(
                1, -(-len(sub_gangs) // self.pad_gangs_to)
            )
        # Incremental encode reuse (solver/warm.py): each sub-gang's dense
        # rows are dirty-tracked by (spec digest, snapshot epoch) — a tick
        # that re-solves an unchanged pending set against a changed cluster
        # (capacity freed, node added) copies rows instead of re-walking
        # specs in Python. The sub digests are already computed for the
        # solve-skip fingerprint; the epoch is memoized on the snapshot.
        t_solve0 = time.perf_counter()
        epoch = snapshot.encode_epoch()
        row_keys = [(d, epoch) for d in sub_digests]
        t_encode0 = time.perf_counter()
        batch, decode = encode_gangs(
            sub_gangs,
            pods_by_name,
            snapshot,
            max_groups=self.max_groups,
            max_sets=self.max_sets,
            max_pods=self.max_pods,
            pad_gangs_to=pad_to,
            scheduled_gangs=scheduled_names,
            bound_nodes_by_group=bound_nodes,
            reuse_nodes_by_gang=reuse_nodes,
            spread_avoid_by_gang=spread_avoid,
            row_cache=self.warm.encode_rows,
            row_keys=row_keys,
        )
        encode_s = time.perf_counter() - t_encode0
        esc = self.portfolio_escalation
        esc_fp = None
        if esc > self.portfolio:
            esc_fp = wave_fp  # same inputs govern both dampers
            esc = self._escalation_damper.effective_width(
                floors_only, esc_fp, self.portfolio, esc
            )
        mesh_layout = None
        if self.mesh_cfg is not None:
            from grove_tpu_torch.parallel.mesh import resolve_layout

            # None when the mesh cannot engage (a counted fallback).
            mesh_layout = resolve_layout(
                self.mesh_cfg, int(snapshot.free.shape[0])
            )
        # Degradation ladder (solver/resilience.py): open rungs step this
        # pass down BEFORE solving — portfolio -> single (escalation off),
        # mesh -> unsharded, pruned -> dense. Every rung is admitted-set-
        # preserving (each rung's path admits the same set), so a degraded pass
        # admits the same gangs, just slower.
        pf, pruning_eff = self.portfolio, self.pruning
        ladder = self.resilience
        if ladder is not None:
            if pf > 1 and not ladder.allows("portfolio"):
                pf, esc = 1, 1
            if mesh_layout is not None and not ladder.allows("mesh"):
                mesh_layout = None
            if pruning_eff is not None and not ladder.allows("pruning"):
                pruning_eff = None
        try:
            result = solve(
                snapshot,
                batch,
                self.solver_params,
                portfolio=pf,
                escalate_portfolio=esc,
                # Launch cache + device-resident node tensors: a tick whose
                # shapes recur prepares nothing, and unchanged capacity/
                # topology/free tensors skip the per-tick host->device upload.
                warm=self.warm,
                # Candidate pruning (solver.pruning config): solve on the
                # gathered sub-fleet; lossy rejections escalate dense.
                pruning=pruning_eff,
                device=self.device,
                # Mesh-sharded solve (solver.mesh config): node/candidate axis
                # split across the device mesh; a portfolio solve ignores it
                # and negotiates its own (portfolio, node) mesh.
                mesh=mesh_layout,
            )
            if ladder is not None:
                ladder.record_success()
        except Exception as e:  # noqa: BLE001 — degrade, never drop the pass
            if ladder is None:
                raise
            # Attribute the failure to the richest optional subsystem that
            # was actually in play, then retry ONCE fully degraded — dense,
            # unsharded, single-variant: the configuration that only needs
            # the device to run one program. A failure there too is real.
            subsystem = (
                "portfolio"
                if pf > 1
                else "mesh"
                if mesh_layout is not None
                else "pruning"
                if pruning_eff is not None
                else None
            )
            ladder.record_failure(subsystem)
            self.resilience_counts["solve_degraded_retries"] += 1
            self._journal_action(
                now,
                "resilience.solve_degraded",
                "floors" if floors_only else "extras",
                error=str(e)[:200],
            )
            result = solve(
                snapshot,
                batch,
                self.solver_params,
                portfolio=1,
                escalate_portfolio=1,
                warm=self.warm,
                pruning=None,
                device=self.device,
            )
            # The journaled wave must fingerprint the config that actually
            # solved, or replay rebuilds the wrong executable.
            pf, esc, pruning_eff, mesh_layout = 1, 1, None, None
        self.last_shard_devices = mesh_layout.node_devices if mesh_layout and pf == 1 else 0
        t_decode0 = time.perf_counter()
        # One copy from the card for the whole solve: verdicts, scores and
        # assignments together.
        ok_arr, assigned_arr, score_arr = fetch_result(result)
        bindings = decode_bindings(ok_arr, assigned_arr, decode, snapshot)
        decode_s = time.perf_counter() - t_decode0
        solve_seconds = time.perf_counter() - t_solve0
        # Serving-path host-stage split (the drain's ledger, per-tick view):
        # solveS is the device dispatch+wait remainder between the two host
        # stages. Rendered by /statusz solver.hostStages and `get solver`.
        self.last_host_stages = {
            "encodeS": round(encode_s, 6),
            "solveS": round(
                max(solve_seconds - encode_s - decode_s, 0.0), 6
            ),
            "decodeS": round(decode_s, 6),
            "gangs": len(sub_gangs),
        }

        admitted = 0
        import numpy as np

        ok_by_name = dict(zip(decode.gang_names, ok_arr))
        scores = dict(zip(decode.gang_names, score_arr))
        valid_by_name = dict(zip(decode.gang_names, np.asarray(batch.gang_valid)))
        any_valid_rejected = any(
            valid_by_name.get(n, False) and not ok_by_name.get(n, False)
            for n in decode.gang_names
        )
        if self.recorder is not None:
            # Flight-recorder capture BEFORE the binding loop mutates the
            # pods: the journal holds the pre-solve input closure. The
            # record's JSON is rendered here (the C renderer, utils/csrc);
            # the file I/O is the writer thread's.
            try:
                self.recorder.capture_wave(
                    now=now,
                    wave="floors" if floors_only else "extras",
                    snapshot=snapshot,
                    gangs=sub_gangs,
                    pods_by_name=pods_by_name,
                    scheduled_names=scheduled_names,
                    bound_nodes=bound_nodes,
                    reuse_nodes=reuse_nodes,
                    spread_avoid=spread_avoid,
                    max_groups=self.max_groups,
                    max_sets=self.max_sets,
                    max_pods=self.max_pods,
                    pad_gangs_to=pad_to,
                    params=self.solver_params,
                    portfolio=pf,
                    escalate_portfolio=esc,
                    pruning=pruning_eff,
                    plan=bindings,
                    ok_by_name=ok_by_name,
                    valid_by_name=valid_by_name,
                    scores=scores,
                    solve_seconds=solve_seconds,
                    mesh=mesh_layout.fingerprint() if mesh_layout else None,
                )
            except Exception:  # noqa: BLE001 — tracing must never break serving
                pass
        # Rolling placement-quality view (quality/report.py units): only
        # solver-valid gangs count — a gang gated out at encode (missing
        # base, unresolvable key) is not a quality verdict on this wave.
        considered = [
            n for n in decode.gang_names if valid_by_name.get(n, False)
        ]
        if considered:
            adm_names = [n for n in considered if ok_by_name.get(n, False)]
            mean_q = (
                float(np.mean([float(scores[n]) for n in adm_names]))
                if adm_names
                else 0.0
            )
            self.quality_last = {
                "wave": "floors" if floors_only else "extras",
                "gangs": len(considered),
                "admitted": len(adm_names),
                "admittedRatio": round(len(adm_names) / len(considered), 4),
                "meanPlacementScore": round(mean_q, 4),
                # score = 0.5 + 0.5 * preferred fraction, inverted.
                "preferredFraction": round(max(0.0, 2.0 * mean_q - 1.0), 4)
                if adm_names
                else 0.0,
            }
            qc = self.quality_counts
            qc["waves"] += 1
            qc["gangs"] += len(considered)
            qc["admitted"] += len(adm_names)
            qc["score_sum"] += mean_q * len(adm_names)
        if esc_fp is not None:
            self._escalation_damper.record(
                floors_only, esc_fp, esc > self.portfolio, any_valid_rejected
            )
        # Arm the solve-skip memo only for no-effect passes (nothing bound,
        # nothing newly admitted). retry_at: the earliest in-cooldown
        # preemption expiry among valid rejected contenders — past it the
        # pass must re-run so preemption can retry; contenders NOT in
        # cooldown already attempted (deterministically) this pass. An
        # incremental (delta) pass stores the UNION fingerprint but must
        # carry the smaller of its own and the inherited retry_at — the
        # carried gangs' pending preemption retries survive the delta.
        if not any(bindings.values()):
            valid_rejected = frozenset(
                n
                for n in decode.gang_names
                if valid_by_name.get(n, False) and not ok_by_name.get(n, False)
            )
            retry_at = math.inf
            if floors_only and valid_rejected:
                expiries = [
                    t + self.preemption_cooldown_seconds
                    for n in valid_rejected
                    if (t := self._preempted_for_at.get(n)) is not None
                    and now - t < self.preemption_cooldown_seconds
                ]
                if expiries:
                    retry_at = min(expiries)
            if carried is not None and memo is not None:
                retry_at = min(retry_at, memo[1])
                valid_rejected = valid_rejected | memo[2]
            self._solve_skip_memo[floors_only] = (
                wave_fp, retry_at, valid_rejected,
            )
        else:
            self._solve_skip_memo.pop(floors_only, None)
        for gang_name, pod_bindings in bindings.items():
            gang = c.podgangs[gang_name]
            if not self._bind_gang(gang_name, pod_bindings, now):
                # Stale plan or mid-gang commit failure: the gang's pods are
                # untouched (still gated), so the next pass re-solves it
                # against the current fleet — requeued, never half-bound.
                continue
            if gang_name not in scheduled_names and gang_name not in self._admitted_this_pass:
                # First admission only: extras top-ups of an already-admitted
                # gang must not re-emit the admission event, inflate the
                # admitted count, or overwrite the floor solve's score.
                # scheduled_names covers earlier passes (via status);
                # _admitted_this_pass covers the floors wave of THIS pass.
                self._admitted_this_pass.add(gang_name)
                gang.status.placement_score = float(scores.get(gang_name, 0.0))
                self.last_admission_scores.append(gang.status.placement_score)
                c.record_event(
                    now, gang_name, f"gang admitted ({len(pod_bindings)} pods bound)"
                )
                admitted += 1
                if self.tenancy_enabled:
                    tenant = self._tenant_of(gang)
                    self.tenancy_ledger.note_admitted(
                        tenant, borrowed=gang_name in borrow_granted
                    )
                    # Time-to-bind in reconcile-clock seconds, from the
                    # first pass that saw the gang pending to this bind.
                    self.tenancy_ledger.note_bound(
                        tenant,
                        getattr(gang, "slo_class", ""),
                        now - self._pending_since.get(gang_name, now),
                    )

        # Priority preemption: a rejected gang that outranks placed gangs may
        # evict the lowest-priority ones (whole gangs — gang semantics) to
        # make room; it re-solves first next pass (sort_pending is
        # priority-ordered). One preemption action per pass keeps the cascade
        # observable and bounded.
        # Preemption considers FLOOR rejections only — a gang denied best-effort
        # extras has its guarantee met and must not evict anyone.
        if floors_only:
            rejected = [
                g
                for g in sub_gangs
                if not ok_by_name.get(g.name, False)
                and valid_by_name.get(g.name, False)  # gated/unresolvable can't preempt
                and g.name in c.podgangs
            ]
            # Incremental pass: carried valid-rejected gangs stay in the
            # contender field — a full pass would pick the highest-priority
            # contender across ALL pending, and the delta must not let a
            # lower-priority arrival preempt in its place.
            rejected.extend(
                g for g in carried_rejected if g.name in c.podgangs
            )
            if rejected:
                self._preempt_for_rejected(rejected, now)
        return admitted

    def _journal_action(self, now: float, action: str, obj: str, **fields) -> None:
        """Journal one disruptive decision to the flight recorder (no-op
        without one; contained — tracing must never break serving)."""
        if self.recorder is None:
            return
        try:
            self.recorder.capture_action(now, action, obj, **fields)
        except Exception:  # noqa: BLE001
            pass

    def _bind_gang(self, gang_name: str, pod_bindings: dict, now: float) -> bool:
        """Commit one admitted gang's bindings all-or-nothing.

        Two failure domains the solve itself cannot see land here:

        - RETIRE-TIME STALE-PLAN REVALIDATION: between the snapshot and this
          commit, a target node may have died or been cordoned (a watch
          event pumped mid-pass, sim chaos, a drain-driven flow). Binding
          into a dead node would strand the whole gang until status rollup
          notices; instead the gang is REQUEUED untouched — its pods stay
          gated and the next pass re-solves against the live fleet.
        - ALL-OR-NOTHING COMMIT WITH ROLLBACK: a commit that fails mid-gang
          (injected `bind.commit` fault; any real store error) restores
          every already-mutated pod to its exact prior (gates, node, phase)
          — the defrag make-before-break discipline: the new placement
          holds only when the WHOLE gang lands. A half-bound gang is the
          one state the gang-semantics machine must never enter.

        Both paths are counted (resilience_counts -> grove_bind_* metrics),
        journaled, and evented — never silent. True = committed."""
        c = self.cluster
        from grove_tpu_torch import faults as faults_mod

        revalidate = (
            self.resilience is None
            or self.resilience.config.stale_plan_revalidation
        )
        if revalidate:
            # A revocation-pending node is as dead as a cordoned one for NEW
            # bindings: a notice landing between solve and bind must never
            # produce a bind into doomed capacity.
            dead = sorted(
                node
                for node in set(pod_bindings.values())
                if (n := c.nodes.get(node)) is None
                or not n.schedulable
                or n.revocation_deadline is not None
            )
            if dead:
                self.resilience_counts["stale_plan_requeues"] += 1
                self._journal_action(
                    now, "resilience.stale_plan_requeue", gang_name, nodes=dead
                )
                c.record_event(
                    now,
                    gang_name,
                    f"bind requeued: target node(s) {', '.join(dead)} died, "
                    "were cordoned, or got a revocation notice after the solve",
                )
                return False
        injector = faults_mod.active()
        bound: list = []  # (pod, prior node_name, prior gates, prior phase)
        try:
            for pod_name, node_name in pod_bindings.items():
                pod = c.pods.get(pod_name)
                if pod is None:
                    continue
                if injector.enabled:
                    injector.maybe_raise(
                        "bind.commit", gang=gang_name, pod=pod_name
                    )
                bound.append(
                    (pod, pod.node_name, list(pod.scheduling_gates), pod.phase)
                )
                pod.node_name = node_name
                pod.scheduling_gates = []
                pod.phase = PodPhase.PENDING
        except Exception as e:  # noqa: BLE001 — roll back, requeue, surface
            for pod, prior_node, prior_gates, prior_phase in bound:
                pod.node_name = prior_node
                pod.scheduling_gates = prior_gates
                pod.phase = prior_phase
            self.resilience_counts["bind_rollbacks"] += 1
            self._journal_action(
                now, "resilience.bind_rollback", gang_name, error=str(e)[:200]
            )
            c.record_event(
                now,
                gang_name,
                f"gang bind rolled back ({len(bound)} pods restored): {e}",
            )
            return False
        return True

    def _sub_digest(self, sub: PodGang) -> tuple:
        """Hashable digest of ONE pending subgang — everything encode reads
        from it: identity, queue, priority, dependency/seed references,
        topology constraints at all three levels, and per-group refs with
        their pod template hashes (spec drift of a pod recreated under the
        same name must break the match)."""

        def pc(obj) -> tuple:
            tc = getattr(obj, "topology_constraint", None)
            p = getattr(tc, "pack_constraint", None) if tc else None
            return (p.required, p.preferred) if p else (None, None)

        c = self.cluster
        return (
            sub.name,
            getattr(sub, "queue", ""),
            # Tenancy inputs: the SLO tier and the current aging boost both
            # move the batch order / contender choice, so a boost step or a
            # class change must break the solve-skip match (and the encode
            # row key riding this digest).
            getattr(sub, "slo_class", ""),
            self._aging_boost.get(sub.name, 0) if self.tenancy_enabled else 0,
            sub.spec.priority_class_name,
            sub.base_podgang_name,
            getattr(sub.spec.reuse_reservation_ref, "name", None),
            sub.spec.spread_key,
            (sub.pcs_name, sub.pcs_replica_index),
            pc(sub.spec),
            tuple(
                (gc.name, tuple(gc.pod_group_names), pc(gc))
                for gc in sub.spec.topology_constraint_group_configs
            ),
            tuple(
                (
                    grp.name,
                    grp.min_replicas,
                    pc(grp),
                    tuple(
                        (
                            r.name,
                            getattr(c.pods.get(r.name), "pod_template_hash", ""),
                        )
                        for r in grp.pod_references
                    ),
                )
                for grp in sub.spec.pod_groups
            ),
        )

    @property
    def queue_tree(self) -> QueueTree | None:
        """The QueueTree for `queues` — accepts an already-built tree or the
        legacy flat {name: {res: quota}} float map (normalized once and
        cached per distinct mapping object)."""
        q = self.queues
        if not q:
            return None
        if isinstance(q, QueueTree):
            return q
        cached = getattr(self, "_queue_tree_cache", None)
        if cached is not None and cached[0] is q:
            return cached[1]
        tree = QueueTree.from_flat(q)
        self._queue_tree_cache = (q, tree)
        return tree

    def queue_usage(self) -> dict[str, dict[str, float]]:
        """Bound-and-active resource usage per capacity queue — the number
        the quota filter subtracts and the observability surfaces report
        (statusz/metrics)."""
        c = self.cluster
        usage: dict[str, dict[str, float]] = {}
        for pod in c.pods.values():
            if not (pod.is_scheduled and pod.is_active):
                continue
            owner = c.podgangs.get(pod.podgang_name)
            qname = getattr(owner, "queue", "") if owner else ""
            if not qname:
                continue
            acc = usage.setdefault(qname, {})
            for res, qty in pod.spec.total_requests().items():
                acc[res] = acc.get(res, 0.0) + qty
        return usage

    def _priority_of(self, gang: PodGang) -> int:
        """Effective priority: PriorityClass value plus the tenancy aging
        boost (zero when tenancy is off or the gang is not aging)."""
        base = self.priority_classes.get(gang.spec.priority_class_name, 0)
        if not self.tenancy_enabled:
            return base
        return base + self._aging_boost.get(gang.name, 0)

    def _slo_rank_of(self, gang: PodGang) -> int:
        return slo_rank(getattr(gang, "slo_class", ""))

    def _tenant_of(self, gang: PodGang) -> str:
        return gang.queue or "(unqueued)"

    def _refresh_aging(self, pending: list[PodGang], now: float) -> None:
        """Advance the deterministic aging ladder (tenancy/aging.py) for
        every pending gang. Each step up is journaled with its inputs
        (waited, halfLife, boost, base priority) — the decision record the
        replay gate checks; the boost itself re-derives from those inputs."""
        pending_names = set()
        for gang in pending:
            pending_names.add(gang.name)
            since = self._pending_since.get(gang.name)
            if since is None:
                self._pending_since[gang.name] = since = now
                self.tenancy_ledger.note_submitted(self._tenant_of(gang))
            boost = aging_boost(
                now - since,
                self.tenancy_aging_half_life_seconds,
                self.tenancy_aging_max_boost,
            )
            prev = self._aging_boost.get(gang.name, 0)
            if boost > prev:
                self._aging_boost[gang.name] = boost
                self.tenancy_ledger.note_aging(self._tenant_of(gang))
                self._journal_action(
                    now,
                    "tenancy.aging",
                    gang.name,
                    waitedSeconds=round(now - since, 6),
                    halfLifeSeconds=self.tenancy_aging_half_life_seconds,
                    boost=boost,
                    basePriority=self.priority_classes.get(
                        gang.spec.priority_class_name, 0
                    ),
                    sloClass=getattr(gang, "slo_class", "") or "standard",
                )
        # A gang that stopped pending (bound, or departed — the departed
        # case is also churn-pruned in solve_pending) ages from scratch if
        # it ever re-enters: aging measures THIS episode of starvation.
        for name in [n for n in self._pending_since if n not in pending_names]:
            del self._pending_since[name]
            self._aging_boost.pop(name, None)

    def _preempt_for_rejected(self, rejected: list[PodGang], now: float) -> bool:
        """Evict lower-priority placed gangs so the highest-priority rejected
        gang can fit (KAI priority-preemption analog; victims get the
        DisruptionTarget condition, podgang.go:160-167)."""
        c = self.cluster
        # Prune cooldown entries for gangs that no longer exist (rolling
        # updates churn gang names; this dict must not grow unboundedly).
        for name in [n for n in self._preempted_for_at if n not in c.podgangs]:
            del self._preempted_for_at[name]
        # Highest-priority contender NOT in cooldown — a permanently-rejected
        # high-priority gang must not block lower-priority gangs whose
        # preemption would succeed.
        contender_sub = None
        for cand in sorted(rejected, key=self._priority_of, reverse=True):
            last = self._preempted_for_at.get(cand.name)
            if last is None or now - last >= self.preemption_cooldown_seconds:
                contender_sub = cand
                break
        if contender_sub is None:
            return False
        contender = c.podgangs[contender_sub.name]
        prio = self._priority_of(contender)
        # Demand of the unmet remainder (the sub-gang carries shrunken floors).
        demand: dict[str, float] = {}
        for grp in contender_sub.spec.pod_groups:
            first = grp.pod_references[0].name if grp.pod_references else None
            pod = c.pods.get(first) if first else None
            if pod is None:
                continue
            for res, qty in pod.spec.total_requests().items():
                demand[res] = demand.get(res, 0.0) + qty * grp.min_replicas
        if not demand:
            return False

        def placed_gangs():
            for gang in c.podgangs.values():
                pods = [
                    p for p in c.pods_of_gang(gang.name) if p.is_active and p.is_scheduled
                ]
                if pods:
                    yield gang, pods

        victims = sorted(
            (
                (gang, pods)
                for gang, pods in placed_gangs()
                if self._priority_of(gang) < prio
            ),
            # Tenancy leads with preemptibility: batch-preemptible gangs go
            # first, latency last (rank descending), before the existing
            # lowest-priority / smallest-blast-radius order.
            key=lambda gp: (
                -self._slo_rank_of(gp[0]) if self.tenancy_enabled else 0,
                self._priority_of(gp[0]),
                len(gp[1]),
            ),
        )
        if not victims:
            return False
        released: dict[str, float] = {res: 0.0 for res in demand}
        chosen: list[tuple[PodGang, list[Pod]]] = []
        for gang, pods in victims:
            chosen.append((gang, pods))
            for p in pods:
                for res, qty in p.spec.total_requests().items():
                    if res in released:
                        released[res] += qty
            if all(released[res] >= demand[res] for res in demand):
                break
        else:
            return False  # even evicting everything eligible cannot fit it
        from grove_tpu_torch.api.types import Condition, set_condition

        self._preempted_for_at[contender.name] = now
        for gang, pods in chosen:
            gang.status.conditions = set_condition(
                gang.status.conditions,
                Condition(
                    type=constants.PODGANG_CONDITION_DISRUPTION_TARGET,
                    status="True",
                    reason="Preempted",
                    message=f"preempted by higher-priority gang {contender.name}",
                ),
                now,
            )
            for p in pods:
                self._release_pod(
                    p, now, reason=f"preempted by {contender.name}"
                )
            c.record_event(
                now, gang.name, f"gang preempted by {contender.name} ({len(pods)} pods)"
            )
            if self.tenancy_enabled:
                self.tenancy_ledger.note_preemption(
                    self._tenant_of(gang), self._tenant_of(contender)
                )
        self._journal_action(
            now,
            "preemption",
            contender.name,
            victims=[g.name for g, _ in chosen],
            podsEvicted=sum(len(p) for _, p in chosen),
            contenderPriority=prio,
            sloClass=getattr(contender, "slo_class", "") or "standard",
        )
        return True

    def _reclaim_for_quota(
        self, candidates: list[tuple[PodGang, dict, object]], now: float
    ) -> bool:
        """In-quota demand beats over-quota borrowers (the KAI reclaim
        rule): evict enough borrower gangs under the blocking ancestor that
        the highest-priority in-quota contender's demand fits its deserved
        share. One reclaim per pass with the preemption cooldown, so the
        cascade stays observable; the contender re-solves next pass against
        the freed capacity."""
        c = self.cluster
        qtree = self.queue_tree
        for name in [n for n in self._reclaimed_for_at if n not in c.podgangs]:
            del self._reclaimed_for_at[name]
        self._sweep_reclaim_evictions()
        chosen_cand = None
        for gang, demand, verdict in sorted(
            candidates,
            # Tenancy: the SLO tier outranks priority among in-quota
            # contenders (a latency tenant's deserved share reclaims ahead
            # of a standard one's), matching the admission order.
            key=lambda t: (
                self._slo_rank_of(t[0]) if self.tenancy_enabled else 0,
                -self._priority_of(t[0]),
            ),
        ):
            last = self._reclaimed_for_at.get(gang.name)
            if last is None or now - last >= self.preemption_cooldown_seconds:
                chosen_cand = (gang, demand, verdict)
                break
        if chosen_cand is None:
            return False
        gang, demand, verdict = chosen_cand
        blocked_at = verdict.blocked_at
        # Live (not pass-charged) usage: reclaim evicts BOUND gangs, so the
        # arithmetic must be over committed bindings only.
        live = qtree.hierarchical_usage(self.queue_usage())
        # Over-quota is a queue-level (rolled-up) property, but gangs are
        # charged to the queue they were SUBMITTED to — which may be a
        # descendant of the over-quota level (e.g. borrowers in sub-a push
        # team-a past quota). The victim pool is therefore the union of the
        # over-quota queues' SUBTREES: every gang in an over-quota family is
        # running on borrowed share.
        contender_chain = set(qtree.ancestors(gang.queue))
        victim_queues: set[str] = set()
        for oq in qtree.over_quota_queues(live, blocked_at) - contender_chain:
            victim_queues |= qtree.subtree(oq)
        victim_queues -= contender_chain
        if not victim_queues:
            return False
        # How much must free AT THE BLOCKING LEVEL for the contender to fit
        # inside that level's quota.
        used = live.get(blocked_at, {})
        needed: dict[str, float] = {}
        for rname, qty in demand.items():
            env = qtree.envelope(blocked_at, rname)
            if env.quota != -1:
                over = used.get(rname, 0.0) + qty - env.quota
                if over > 1e-9:
                    needed[rname] = over
        if not needed:
            return False
        victims = []
        for other in c.podgangs.values():
            if other.queue in victim_queues and other.name != gang.name:
                pods = [
                    p
                    for p in c.pods_of_gang(other.name)
                    if p.is_active and p.is_scheduled
                ]
                if pods:
                    victims.append((other, pods))
        # Victim order: batch-preemptible first when tenancy is on (SLO rank
        # descending — latency victims only as a last resort), then lightest
        # borrowers (overQuotaWeight ascending), lowest priority, smallest
        # blast radius.
        victims.sort(
            key=lambda gp: (
                -self._slo_rank_of(gp[0]) if self.tenancy_enabled else 0,
                qtree.borrow_weight(gp[0].queue, needed),
                self._priority_of(gp[0]),
                len(gp[1]),
            )
        )
        released = {r: 0.0 for r in needed}
        chosen: list[tuple[PodGang, list[Pod]]] = []
        for other, pods in victims:
            chosen.append((other, pods))
            for p in pods:
                for res, qty in p.spec.total_requests().items():
                    if res in released:
                        released[res] += qty
            if all(released[r] >= needed[r] - 1e-9 for r in needed):
                break
        else:
            return False  # even evicting every borrower cannot free enough
        if self.tenancy_enabled:
            # Make-first, break-bounded: the victim set is only evicted
            # when (a) its released usage provably covers the contender's
            # overage at the blocking level (the for-else above) AND (b) it
            # fits the SAME disruption budget defrag migrations draw from —
            # at most defrag_max_concurrent gangs disrupted at any instant,
            # in-flight reclaims swept on completion like migrations. A set
            # over budget defers whole (journaled, counted): no partial
            # eviction that frees too little to admit anyone.
            budget = self.defrag_max_concurrent - len(
                self._defrag_migrating
            ) - len(self._reclaim_evicting)
            if len(chosen) > budget:
                self.tenancy_ledger.note_reclaim_deferred()
                self._journal_action(
                    now,
                    "tenancy.reclaim_deferred",
                    gang.name,
                    victims=[g.name for g, _ in chosen],
                    blockedAt=blocked_at,
                    budget=max(0, budget),
                    inFlight=len(self._defrag_migrating)
                    + len(self._reclaim_evicting),
                )
                c.record_event(
                    now,
                    gang.name,
                    f"reclaim deferred: {len(chosen)} victim(s) exceed the "
                    f"disruption budget ({max(0, budget)} slot(s) free)",
                )
                return False
        from grove_tpu_torch.api.types import Condition, set_condition

        self._reclaimed_for_at[gang.name] = now
        for other, pods in chosen:
            other.status.conditions = set_condition(
                other.status.conditions,
                Condition(
                    type=constants.PODGANG_CONDITION_DISRUPTION_TARGET,
                    status="True",
                    reason="Reclaimed",
                    message=(
                        f"over-quota usage reclaimed by in-quota gang {gang.name}"
                    ),
                ),
                now,
            )
            for p in pods:
                self._release_pod(p, now, reason=f"reclaimed by {gang.name}")
            c.record_event(
                now,
                other.name,
                f"gang reclaimed by in-quota {gang.name} ({len(pods)} pods)",
            )
            if self.tenancy_enabled:
                self._reclaim_evicting[other.name] = (gang.name, now)
                self.tenancy_ledger.note_reclaim(
                    self._tenant_of(other), self._tenant_of(gang)
                )
        self._journal_action(
            now,
            "quota-reclaim",
            gang.name,
            victims=[g.name for g, _ in chosen],
            blockedAt=blocked_at,
            needed={r: round(v, 6) for r, v in needed.items()},
            victimSloClasses=[
                getattr(g, "slo_class", "") or "standard" for g, _ in chosen
            ],
            contenderSloClass=getattr(gang, "slo_class", "") or "standard",
        )
        return True

    def _sweep_reclaim_evictions(self) -> None:
        """Completion sweep for in-flight reclaim transactions (the defrag
        _defrag_migrating discipline): an eviction stops counting against
        the disruption budget when the contender that demanded the capacity
        is scheduled (the transaction landed), the victim is whole again
        (it re-placed elsewhere), or either side departed."""
        c = self.cluster
        for victim in list(self._reclaim_evicting):
            contender_name, _ = self._reclaim_evicting[victim]
            vg = c.podgangs.get(victim)
            if vg is None:
                del self._reclaim_evicting[victim]
                continue
            cg = c.podgangs.get(contender_name)
            if cg is None or cg.is_base_gang_scheduled():
                del self._reclaim_evicting[victim]
                continue
            pods = [p for p in c.pods_of_gang(victim) if p.is_active]
            if pods and all(p.is_scheduled for p in pods):
                del self._reclaim_evicting[victim]

    # --- statuses ----------------------------------------------------------------

    def update_statuses(self, now: float) -> None:
        c = self.cluster
        updating_pcs = {
            name
            for name, pcs in c.podcliquesets.items()
            if pcs.status.rolling_update_progress is not None
            and pcs.status.rolling_update_progress.update_ended_at is None
        }
        for clique in c.podcliques.values():
            compute_podclique_status(c, clique, now, updating=clique.pcs_name in updating_pcs)
        # Per-PCS template-hash cache: cliques sharing a template share a hash,
        # and the sha only needs computing when a PCSG is mid-update.
        hash_cache: dict[tuple[str, str], str] = {}

        def _desired_hash(pcs, clique) -> str:
            key = (pcs.metadata.name, clique.template_name)
            if key not in hash_cache:
                hash_cache[key] = exp.compute_pod_template_hash(
                    pcs.clique_template(clique.template_name),
                    pcs.spec.template.priority_class_name,
                )
            return hash_cache[key]

        for pcsg in c.scaling_groups.values():
            compute_pcsg_status(c, pcsg, now, updating=pcsg.pcs_name in updating_pcs)
            pcs = c.podcliquesets.get(pcsg.pcs_name)
            if pcs is not None:
                pcs_prog = pcs.status.rolling_update_progress
                sync_pcsg_rolling_progress(
                    c,
                    pcsg,
                    lambda clique, _pcs=pcs: _desired_hash(_pcs, clique),
                    now,
                    updating=pcsg.pcs_name in updating_pcs,
                    pcs_update_started_at=(
                        pcs_prog.update_started_at if pcs_prog is not None else None
                    ),
                )
        for gang in c.podgangs.values():
            compute_podgang_status(c, gang, now)
        for pcs in c.podcliquesets.values():
            compute_pcs_status(c, pcs, now)

    # --- gang termination (gangterminate.go) -------------------------------------

    def gang_termination(self, now: float) -> list[tuple[str, int]]:
        """Delete PCS replicas breached beyond TerminationDelay. Returns them."""
        c = self.cluster
        terminated: list[tuple[str, int]] = []
        for pcs in c.podcliquesets.values():
            delay = pcs.spec.template.termination_delay_seconds
            for i in range(pcs.spec.replicas):
                since_values = []
                for clique in c.cliques_of_pcs_replica(pcs.metadata.name, i):
                    if clique.pcsg_name is None:
                        t = clique_breached_since(clique)
                        if t is not None:
                            since_values.append(t)
                for pcsg in c.pcsgs_of_pcs(pcs.metadata.name):
                    if pcsg.pcs_replica_index == i:
                        t = pcsg_breached_since(pcsg)
                        if t is not None:
                            since_values.append(t)
                if not since_values:
                    continue
                earliest = min(since_values)
                if now - earliest > delay:
                    for clique in list(c.cliques_of_pcs_replica(pcs.metadata.name, i)):
                        c.delete_clique_cascade(clique.metadata.name)
                    c.record_event(
                        now,
                        pcs.metadata.name,
                        f"gang-terminated replica {i} (breached {now - earliest:.0f}s "
                        f"> terminationDelay {delay:.0f}s)",
                    )
                    terminated.append((pcs.metadata.name, i))
                    self._journal_action(
                        now, "gang-termination", pcs.metadata.name, replica=i
                    )
        return terminated

    # --- rolling updates (rollingupdate.go) --------------------------------------

    def _sweep_rollout_replacements(self) -> None:
        """Free (pcs, replica) disruption-budget slots whose make-before-break
        replacement completed — the replica shows up in
        updated_replica_indices (or the update / the PCS itself is gone).
        Runs at the top of rolling_updates so a slot frees on the pass after
        the replica comes whole."""
        c = self.cluster
        for key in list(self._rollout_replacing):
            pcs_name, replica = key
            pcs = c.podcliquesets.get(pcs_name)
            prog = pcs.status.rolling_update_progress if pcs is not None else None
            if (
                pcs is None
                or prog is None
                or prog.update_ended_at is not None
                or replica in prog.updated_replica_indices
            ):
                del self._rollout_replacing[key]
                self._rollout_backoff.pop(key, None)

    def rolling_updates(self, now: float) -> None:
        c = self.cluster
        self._sweep_rollout_replacements()
        for pcs in c.podcliquesets.values():
            new_hash = exp.compute_generation_hash(pcs)
            st = pcs.status
            if st.current_generation_hash is None:
                st.current_generation_hash = new_hash
                continue
            if new_hash != st.current_generation_hash and (
                st.rolling_update_progress is None
                or st.rolling_update_progress.update_ended_at is not None
                or st.updated_generation_hash != new_hash
            ):
                st.rolling_update_progress = PodCliqueSetRollingUpdateProgress(
                    update_started_at=now
                )
                st.updated_generation_hash = new_hash
                c.record_event(now, pcs.metadata.name, f"rolling update started -> {new_hash}")
                self._journal_action(
                    now, "rolling-update-started", pcs.metadata.name, hash=new_hash
                )
            if st.rolling_update_progress is None or st.rolling_update_progress.update_ended_at:
                continue
            self._advance_rolling_update(pcs, now)

    def _advance_rolling_update(self, pcs: PodCliqueSet, now: float) -> None:
        c = self.cluster
        st = pcs.status
        prog = st.rolling_update_progress
        new_hash = st.updated_generation_hash

        # Staleness is per-clique pod-template hash: only cliques whose own
        # template changed roll their pods (reconcilestatus.go:91-112 keys
        # completion on CurrentPodTemplateHash, not the set-level hash).
        def desired_hash(clique) -> str:
            return exp.compute_pod_template_hash(
                pcs.clique_template(clique.template_name),
                pcs.spec.template.priority_class_name,
            )

        def stale_pods(i: int) -> list[Pod]:
            out = []
            for clique in c.cliques_of_pcs_replica(pcs.metadata.name, i):
                want = desired_hash(clique)
                out.extend(
                    p
                    for p in c.pods_of_clique(clique.metadata.name)
                    if p.is_active and p.pod_template_hash != want
                )
            return out

        def replica_updated(i: int) -> bool:
            """Updated = no stale pods AND every clique back to ready >=
            minAvailable (isPCLQUpdateComplete, rollingupdate.go:286-295 gates
            on UpdatedReplicas and ReadyReplicas >= MinAvailable) — otherwise
            the update would advance while the replica is still down, losing
            the one-replica-at-a-time availability guarantee. The predicate
            itself is shared with the PCSG-status bookkeeping
            (status.clique_rolling_state) so the two granularities agree."""
            for clique in c.cliques_of_pcs_replica(pcs.metadata.name, i):
                stale, ready = clique_rolling_state(c, clique, desired_hash(clique))
                if stale or ready < clique.min_available:
                    return False
            return True

        # Replica order: no-scheduled-pods first, then breached, then ordinal
        # (rollingupdate.go:196-223).
        def order_key(i: int) -> tuple:
            pods = [
                p
                for clique in c.cliques_of_pcs_replica(pcs.metadata.name, i)
                for p in c.pods_of_clique(clique.metadata.name)
                if p.is_active
            ]
            scheduled = sum(1 for p in pods if p.is_scheduled)
            breached = any(
                clique_breached_since(cl) is not None
                for cl in c.cliques_of_pcs_replica(pcs.metadata.name, i)
            )
            return (scheduled > 0, not breached, i)

        remaining = [
            i
            for i in range(pcs.spec.replicas)
            if i not in prog.updated_replica_indices and not replica_updated(i)
        ]
        # Mark replicas that became up-to-date.
        for i in range(pcs.spec.replicas):
            if i not in prog.updated_replica_indices and replica_updated(i):
                prog.updated_replica_indices.append(i)
        remaining = [i for i in remaining if i not in prog.updated_replica_indices]
        if not remaining:
            prog.update_ended_at = now
            prog.current_replica_index = None
            st.current_generation_hash = new_hash
            for clique in c.cliques_of_pcs(pcs.metadata.name):
                clique.status.current_pcs_generation_hash = new_hash
            c.record_event(now, pcs.metadata.name, f"rolling update complete -> {new_hash}")
            self._journal_action(
                now, "rolling-update-complete", pcs.metadata.name, hash=new_hash
            )
            return

        current = min(remaining, key=order_key)
        prog.current_replica_index = current
        # Replace stale pods of the current replica: unscheduled/not-ready pods
        # all at once, ready pods one at a time (scalinggroup.go:117-120) —
        # and only when no replacement is still in flight: the next ready pod
        # may be disrupted only after the previous replacement is back Ready
        # (RU-10 delete-first: exactly ONE pod down at a time under no
        # capacity, rolling_updates_test.go:210-258).
        stale = stale_pods(current)
        # Make-before-break (opt-in via config `rollout.enabled` or the
        # grove.io/rollout-strategy annotation): plan the replacement
        # generation onto capacity that is free while the old pods still
        # run, then cut over atomically — or defer the replica whole.
        # True = handled this pass; False = the backoff deadline is spent,
        # fall through to the seed delete-then-recreate path below.
        if stale and self._rollout_mbb_enabled(pcs):
            from grove_tpu_torch.orchestrator.rollout import advance_make_before_break

            if advance_make_before_break(self, pcs, current, stale, desired_hash, now):
                return

        def _replacement_in_flight() -> bool:
            """A replacement pod (new hash, in a clique the update touches)
            that is not back Ready yet. Scoped to CHANGED cliques — a
            never-ready pod in an untouched clique (e.g. crashlooping) is a
            health problem for replica_updated to hold on, not a replacement
            — and crashlooping pods never count (they will never come Ready;
            waiting on them would wedge the update forever)."""
            for clique in c.cliques_of_pcs_replica(pcs.metadata.name, current):
                want = desired_hash(clique)
                pods = [p for p in c.pods_of_clique(clique.metadata.name) if p.is_active]
                changed = any(p.pod_template_hash != want for p in pods) or (
                    clique.status.current_pod_template_hash not in (None, want)
                )
                if not changed:
                    continue
                if any(
                    not p.ready
                    and not p.crashlooping
                    and p.pod_template_hash == want
                    for p in pods
                ):
                    return True
            return False

        ready_deleted = _replacement_in_flight()
        for pod in stale:
            if pod.ready:
                if ready_deleted:
                    continue
                ready_deleted = True
            self._release_pod(pod, now, reason="rolling-update")

    # --- autoscaling (hpa component analog) --------------------------------------

    def autoscale(self, metrics: dict[str, float], now: float) -> None:
        """Evaluate the store's HPA OBJECTS (components/hpa/hpa.go analog).

        `metrics` maps HPA target FQN -> current average utilization,
        normalized so 1.0 == the target value (classic HPA ratio scaling).
        Scaling writes the target's scale subresource (scale_overrides),
        which the next expansion consumes — exactly the reference flow
        HPA -> CR scale subresource -> determinePodCliqueReplicas."""
        c = self.cluster
        for hpa in c.hpas.values():
            fqn = hpa.target_name
            if fqn not in metrics:
                continue
            current = c.scale_overrides.get(fqn, hpa.target_spec_replicas)
            desired = math.ceil(current * metrics[fqn])
            desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
            if desired != current:
                c.scale_overrides[fqn] = desired
                c.record_event(now, fqn, f"HPA scaled {current} -> {desired}")

    # --- defragmentation & rebalance (solver/defrag.py execution side) -----------

    def maybe_defrag(self, now: float) -> dict | None:
        """Run one defrag evaluation when enabled and the interval elapsed.
        Called from reconcile() and from the manager's flow step — the
        interval gate makes double wiring harmless."""
        if not self.defrag_enabled:
            return None
        if self._defrag_next_at is not None and now < self._defrag_next_at:
            return None
        self._defrag_next_at = now + self.defrag_interval_seconds
        return self.defrag_tick(now)

    def defrag_movable(self, now: float) -> list[PodGang]:
        """Gangs eligible for migration: fully placed AND settled (every
        active pod scheduled and Ready — a gang mid-startup is not moved
        under it), outside the per-gang cooldown, and not already migrating.
        Ordered cheapest-disruption first: lowest priority, then fewest
        pods, then name — the same priority machinery preemption uses, so
        defrag never moves a high-priority gang to spare a low-priority one."""
        c = self.cluster
        movable: list[PodGang] = []
        for gang in c.podgangs.values():
            if gang.name in self._defrag_migrating:
                continue
            last = self._defrag_migrated_at.get(gang.name)
            if last is not None and now - last < self.defrag_cooldown_seconds:
                continue
            pods = [p for p in c.pods_of_gang(gang.name) if p.is_active]
            if not pods or not all(p.is_scheduled and p.ready for p in pods):
                continue
            movable.append(gang)
        movable.sort(
            key=lambda g: (
                self._priority_of(g),
                len(c.pods_of_gang(g.name)),
                g.name,
            )
        )
        return movable

    def defrag_tick(self, now: float) -> dict | None:
        """One defrag cycle: score → (maybe) plan → execute under budget.

        Make-before-break: each move's target capacity is verified against
        the CURRENT free state — before the gang's old placement releases
        anything — and the whole gang then rebinds atomically. Moves whose
        targets are still occupied (they need an earlier move's freed
        capacity) retry within the tick after other moves land, and
        anything left defers to the next cycle, which replans against the
        then-current cluster."""
        from grove_tpu_torch.solver.defrag import fragmentation_report, plan_migrations

        c = self.cluster
        counts = self.defrag_counts
        counts["ticks"] += 1
        self._sweep_migrations()
        # In-flight reclaim evictions share this budget (tenancy); sweep
        # them on the same cadence so a landed reclaim frees its slot.
        self._sweep_reclaim_evictions()
        if not c.nodes:
            return None
        nodes = list(c.nodes.values())
        bound = [p for p in c.pods.values() if p.is_scheduled and p.is_active]
        snapshot = build_snapshot(
            nodes,
            self.topology,
            bound_pods=bound,
            pad_nodes_to=next_pow2(len(c.nodes)),
        )
        report = fragmentation_report(snapshot)
        summary: dict = {
            "at": now,
            "score": report.score,
            "threshold": self.defrag_threshold,
            "migrating": len(self._defrag_migrating),
            "report": report.to_doc(),
        }
        self.defrag_last = summary
        if report.score < self.defrag_threshold:
            counts["skipped_below_threshold"] += 1
            return summary
        budget = (
            self.defrag_max_concurrent
            - len(self._defrag_migrating)
            - len(self._reclaim_evicting)
        )
        if budget <= 0:
            counts["skipped_budget"] += 1
            summary["deferred"] = "disruption budget exhausted"
            return summary
        movable = self.defrag_movable(now)
        if not movable:
            summary["deferred"] = "no movable gangs"
            return summary
        plan = plan_migrations(
            nodes,
            self.topology,
            movable,
            dict(c.pods),
            params=self.solver_params,
            warm=self.warm,
            max_moves=self.defrag_max_moves,
            min_efficiency=self.defrag_min_efficiency,
            pruning=self.pruning,
            device=self.device,
        )
        if plan is None:
            summary["deferred"] = "no improving plan"
            return summary
        counts["plans"] += 1
        counts["capacity_recovered"] += plan.capacity_recovered
        summary["plan"] = plan.to_doc()
        executed = 0
        moves = list(plan.moves)
        progress = True
        while moves and budget > 0 and progress:
            progress = False
            remaining = []
            for mv in moves:
                if budget <= 0:
                    remaining.append(mv)
                    continue
                if self._execute_move(mv, snapshot, now):
                    budget -= 1
                    executed += 1
                    progress = True
                else:
                    remaining.append(mv)
            moves = remaining
        counts["moves_deferred"] += len(moves)
        summary["migrationsStarted"] = executed
        summary["migrationsDeferred"] = len(moves)
        summary["migrating"] = len(self._defrag_migrating)
        return summary

    def _sweep_migrations(self) -> None:
        """Completion sweep shared by defrag and revocation rescue: a
        migration is done when the gang is whole again (every active pod
        scheduled and Ready). Revocation rescues ride _defrag_migrating, so
        this must run even when defrag itself is disabled — otherwise a
        rescue would hold its disruption-budget slot forever."""
        c = self.cluster
        counts = self.defrag_counts
        for name in list(self._defrag_migrating):
            gang = c.podgangs.get(name)
            if gang is None:
                del self._defrag_migrating[name]
                continue
            pods = [p for p in c.pods_of_gang(name) if p.is_active]
            if pods and all(p.is_scheduled and p.ready for p in pods):
                del self._defrag_migrating[name]
                counts["migrations_completed"] += 1
        for name in [n for n in self._defrag_migrated_at if n not in c.podgangs]:
            del self._defrag_migrated_at[name]

    def _execute_move(self, mv, snapshot, now: float) -> bool:
        """Atomically rebind one gang to its planned nodes; False when the
        move cannot run yet (capacity not free, gang changed under the plan).

        The reservation IS the capacity check: every target node must fit
        the incoming pods out of free capacity measured while the gang's old
        placement still holds (make-before-break) — `snapshot.allocated` is
        updated in place as moves land, so later moves inside one tick see
        earlier moves' releases."""
        import numpy as np

        from grove_tpu_torch.state.cluster import pod_request_vector

        c = self.cluster
        gang = c.podgangs.get(mv.gang)
        if gang is None:
            return False
        pods = {p.name: p for p in c.pods_of_gang(mv.gang) if p.is_active}
        demand: dict[int, np.ndarray] = {}
        for pod_name, target in mv.bindings.items():
            pod = pods.get(pod_name)
            if pod is None or not pod.is_scheduled:
                return False  # gang churned since planning; replan next cycle
            if target not in snapshot.node_index_map:
                return False
            ti = snapshot.node_index(target)
            req = pod_request_vector(pod, snapshot.resource_names)
            demand[ti] = demand.get(ti, 0) + req
        free = snapshot.capacity - snapshot.allocated
        for ti, need in demand.items():
            if not snapshot.schedulable[ti] or (free[ti] + 1e-6 < need).any():
                return False  # target not free yet: defer (make-before-break)
        # Cutover: the whole gang rebinds in one step. Pods restart on their
        # new hosts (PENDING, not Ready) and flow through the normal startup
        # lifecycle; the gang reads as migrating until it is whole again.
        moved = 0
        for pod_name, target in mv.bindings.items():
            pod = pods[pod_name]
            req = pod_request_vector(pod, snapshot.resource_names)
            old = pod.node_name
            if old in snapshot.node_index_map:
                snapshot.allocated[snapshot.node_index(old)] -= req
            snapshot.allocated[snapshot.node_index(target)] += req
            pod.node_name = target
            pod.ready = False
            pod.phase = PodPhase.PENDING
            pod.started_at = None
            moved += 1
        np.maximum(snapshot.allocated, 0.0, out=snapshot.allocated)
        self._defrag_migrating[mv.gang] = now
        self._defrag_migrated_at[mv.gang] = now
        self.defrag_counts["migrations"] += 1
        self.defrag_counts["pods_migrated"] += moved
        c.record_event(
            now,
            mv.gang,
            f"gang migrated by defrag ({moved} pods rebound, "
            f"make-before-break)",
        )
        self._journal_action(
            now, "defrag-migration", mv.gang, podsRebound=moved
        )
        return True

    # --- fleet lifecycle: rollout strategy + revocable capacity -------------------

    def _rollout_mbb_enabled(self, pcs: PodCliqueSet) -> bool:
        """Per-PCS make-before-break opt-in: the grove.io/rollout-strategy
        annotation wins ("make-before-break" / "recreate"), else the global
        `rollout.enabled` config. Default off — the seed delete-then-recreate
        behavior is pinned by the RU scenario suite."""
        strategy = (pcs.metadata.annotations or {}).get(
            constants.ANNOTATION_ROLLOUT_STRATEGY, ""
        )
        if strategy == constants.ROLLOUT_STRATEGY_MAKE_BEFORE_BREAK:
            return True
        if strategy == constants.ROLLOUT_STRATEGY_RECREATE:
            return False
        return self.rollout_enabled

    def revocation_tick(self, now: float) -> None:
        """React to pending revocation notices within their grace window.

        For every schedulable node carrying a revocation_deadline: while
        time allows (outside revocation_eviction_lead_seconds), resident
        gangs migrate make-before-break through plan_rescue under the
        shared disruption budget, highest SLO tier planned first so latency
        work gets the scarce free capacity. Inside the lead — or for
        whatever migration could not place in time — residents are evicted
        in DESCENDING SLO rank (batch-preemptible first) and reschedule
        from the queue; the node must be empty before the deadline turns it
        into a dead node. Evictions are forced by the provider, not chosen
        by us, so they do not consume disruption-budget slots."""
        c = self.cluster
        pending = [
            n
            for n in c.nodes.values()
            if n.revocation_deadline is not None and n.schedulable
        ]
        if self._revocation_seen:
            # Bookkeeping for resolved notices (expired → killed → cordoned).
            self._revocation_seen &= {n.name for n in pending}
        if not pending:
            return
        c_counts = self.revocation_counts
        # Rescues ride the defrag-migration machinery; sweep completions even
        # when defrag itself is disabled so budget slots free up.
        self._sweep_migrations()
        self._sweep_reclaim_evictions()
        for node in sorted(pending, key=lambda n: (n.revocation_deadline, n.name)):
            if node.name not in self._revocation_seen:
                self._revocation_seen.add(node.name)
                c_counts["notices"] += 1
                self._journal_action(
                    now,
                    "revocation.notice",
                    node.name,
                    deadline=node.revocation_deadline,
                )
                c.record_event(
                    now,
                    node.name,
                    f"revocation notice: capacity gone at t={node.revocation_deadline:g}",
                )
            residents = self._gangs_on_node(node.name)
            if not residents:
                continue
            if now >= node.revocation_deadline - self.revocation_eviction_lead_seconds:
                self._revocation_evict(node, residents, now)
            else:
                self._revocation_migrate(node, residents, now)

    def _gangs_on_node(self, node_name: str) -> list[PodGang]:
        """Gangs with at least one active scheduled pod on the node, in
        deterministic name order."""
        c = self.cluster
        return [
            gang
            for name, gang in sorted(c.podgangs.items())
            if any(
                p.node_name == node_name and p.is_active and p.is_scheduled
                for p in c.pods_of_gang(name)
            )
        ]

    def _revocation_migrate(self, node, residents: list[PodGang], now: float) -> None:
        """Rescue residents off a revocation-pending node make-before-break:
        plan_rescue re-places each whole gang onto capacity that is free
        while the old placement still holds (hold_usage=True — the same
        discipline _execute_move enforces at commit time), with every
        revocation-pending node masked. Deferred or unplaceable gangs retry
        next tick and age into eviction."""
        from grove_tpu_torch.solver.defrag import plan_rescue

        c = self.cluster
        candidates = [g for g in residents if g.name not in self._defrag_migrating]
        if not candidates:
            return
        budget = (
            self.defrag_max_concurrent
            - len(self._defrag_migrating)
            - len(self._reclaim_evicting)
            - len(self._rollout_replacing)
        )
        if budget <= 0:
            self.revocation_counts["migration_deferred"] += len(candidates)
            return
        # Highest-SLO work first: free capacity is scarce during a storm and
        # latency gangs must not lose their escape slot to batch work that
        # the eviction ladder handles acceptably.
        candidates.sort(
            key=lambda g: (self._slo_rank_of(g), -self._priority_of(g), g.name)
        )
        candidates = candidates[:budget]
        plan = plan_rescue(
            list(c.nodes.values()),
            self.topology,
            candidates,
            dict(c.pods),
            params=self.solver_params,
            warm=self.warm,
            pruning=self.pruning,
            hold_usage=True,
            device=self.device,
        )
        planned = {mv.gang for mv in plan}
        self.revocation_counts["migration_deferred"] += sum(
            1 for g in candidates if g.name not in planned
        )
        if not plan:
            return
        nodes = list(c.nodes.values())
        bound = [p for p in c.pods.values() if p.is_scheduled and p.is_active]
        snapshot = build_snapshot(
            nodes,
            self.topology,
            bound_pods=bound,
            pad_nodes_to=next_pow2(len(c.nodes)),
        )
        for mv in plan:
            if self._execute_move(mv, snapshot, now):
                self.revocation_counts["migrated"] += 1
                self._journal_action(
                    now,
                    "revocation.migrated",
                    mv.gang,
                    node=node.name,
                    podsRebound=len(mv.bindings),
                )
            else:
                self.revocation_counts["migration_deferred"] += 1

    def _revocation_evict(self, node, residents: list[PodGang], now: float) -> None:
        """Inside the eviction lead the node WILL die: clear every resident,
        batch-preemptible tiers first (tenancy/slo.revocation_victim_key),
        so the journal shows low-SLO work absorbing the reclaim ahead of
        latency work. Released pods recreate and reschedule off-node."""
        from grove_tpu_torch.api.types import Condition, set_condition
        from grove_tpu_torch.tenancy.slo import revocation_victim_key

        c = self.cluster
        victims = sorted(
            residents,
            key=lambda g: revocation_victim_key(
                getattr(g, "slo_class", ""), self._priority_of(g), g.name
            ),
        )
        for gang in victims:
            gang.status.conditions = set_condition(
                gang.status.conditions,
                Condition(
                    type=constants.PODGANG_CONDITION_DISRUPTION_TARGET,
                    status="True",
                    reason="Revoked",
                    message=f"evicted ahead of revocation deadline on {node.name}",
                ),
                now,
            )
            # Only the doomed node's residents: gang-mates elsewhere keep
            # their slots and the gang heals pod-by-pod, exactly like the
            # node-death recovery path.
            pods = [
                p
                for p in c.pods_of_gang(gang.name)
                if p.is_active and p.node_name == node.name
            ]
            for pod in pods:
                self._release_pod(pod, now, reason="revocation")
            self.revocation_counts["evicted"] += 1
            self._journal_action(
                now,
                "revocation.evicted",
                gang.name,
                node=node.name,
                podsEvicted=len(pods),
                sloClass=getattr(gang, "slo_class", "") or "standard",
            )
            c.record_event(
                now,
                gang.name,
                f"gang evicted ahead of revocation deadline on {node.name}",
            )

    def rollout_status(self) -> dict:
        """JSON-able fleet-lifecycle state for /statusz "rollout" and
        `grove-tpu get rollout`."""
        c = self.cluster
        pending = {
            n.name: n.revocation_deadline
            for n in c.nodes.values()
            if n.revocation_deadline is not None and n.schedulable
        }
        return {
            "enabled": self.rollout_enabled,
            "surgeRacks": self.rollout_surge_racks,
            "deadlineSeconds": self.rollout_deadline_seconds,
            "replacing": sorted(f"{p}/{i}" for (p, i) in self._rollout_replacing),
            "counts": dict(self.rollout_counts),
            "last": dict(self.rollout_last),
            "revocation": {
                "evictionLeadSeconds": self.revocation_eviction_lead_seconds,
                "pendingNodes": dict(sorted(pending.items())),
                "counts": dict(self.revocation_counts),
            },
        }

    def quality_status(self) -> dict:
        """JSON-able placement-quality state for /statusz "quality" and
        `grove-tpu get quality`."""
        qc = self.quality_counts
        return {
            "last": dict(self.quality_last),
            "counts": {
                "waves": qc["waves"],
                "gangs": qc["gangs"],
                "admitted": qc["admitted"],
                "admittedRatio": round(qc["admitted"] / qc["gangs"], 4)
                if qc["gangs"]
                else 0.0,
                "meanPlacementScore": round(qc["score_sum"] / qc["admitted"], 4)
                if qc["admitted"]
                else 0.0,
            },
        }

    def disrupted_now(self) -> int:
        """Gangs currently counted against the disruption budget: defrag
        migrations (including revocation rescues) in flight, reclaim
        evictions in flight, and rolling-update replicas mid-replacement.
        The tenancy/rollout benches sample this every tick against
        defrag_max_concurrent."""
        return (
            len(self._defrag_migrating)
            + len(self._reclaim_evicting)
            + len(self._rollout_replacing)
        )

    def tenancy_status(self, top: int = 50) -> dict:
        """JSON-able tenancy state for /statusz "tenancy" and `grove-tpu
        get tenancy`. `top` bounds the per-tenant table (busiest first)."""
        return {
            "enabled": self.tenancy_enabled,
            "agingHalfLifeSeconds": self.tenancy_aging_half_life_seconds,
            "agingMaxBoost": self.tenancy_aging_max_boost,
            "aged": {
                name: boost
                for name, boost in sorted(self._aging_boost.items())
                if boost > 0
            },
            "reclaimEvicting": sorted(self._reclaim_evicting),
            "disruptionBudget": {
                "max": self.defrag_max_concurrent,
                "inFlight": self.disrupted_now(),
            },
            "ledger": self.tenancy_ledger.snapshot(top=top),
        }

    def defrag_status(self) -> dict:
        """JSON-able defrag state for /statusz and `grove-tpu get defrag`."""
        return {
            "enabled": self.defrag_enabled,
            "threshold": self.defrag_threshold,
            "intervalSeconds": self.defrag_interval_seconds,
            "maxConcurrentMigrations": self.defrag_max_concurrent,
            "gangCooldownSeconds": self.defrag_cooldown_seconds,
            "migrating": sorted(self._defrag_migrating),
            "counts": dict(self.defrag_counts),
            "last": dict(self.defrag_last),
        }


def _merge_pod_groups(existing, desired):
    """Keep existing group objects (with references) for groups that persist,
    adopt new ones, drop removed ones — preserving desired order."""
    by_name = {g.name: g for g in existing}
    out = []
    for g in desired:
        if g.name in by_name:
            kept = by_name[g.name]
            kept.min_replicas = g.min_replicas
            kept.topology_constraint = g.topology_constraint
            out.append(kept)
        else:
            out.append(g)
    return out
