"""The grove-tpu scheduler-backend sidecar: gRPC service around the solver.

Implements the reference's SchedulerBackend boundary (GREP-375,
docs/proposals/375-scheduler-backend-framework/README.md:158-202) as a
standalone gRPC process an unmodified Go operator can talk to:

  Init                 — topology handshake (ClusterTopology levels)
  SyncPodGang          — register/refresh a gang (PodGang IR)
  OnPodGangDelete      — drop a gang, release its bindings
  PreparePod           — schedulerName + scheduling-gate injection
                         (podclique/components/pod/pod.go:68,162)
  ValidatePodCliqueSet — backend-specific admission checks

plus the placement cycle KAI performs out-of-band in the reference:

  UpdateCluster        — node snapshot feed (the informer-cache analog)
  ReleasePods          — free capacity for externally deleted pods
  Solve                — drain pending gangs through the batched solver on
                         the card (B1+B2, B5 under escalation);
                         whole-gang bindings + PlacementScore out. (Capacity
                         queues — scheduling.queues — are enforced by the
                         OPERATOR path's admission filter, not here: an
                         external Go operator brings its own quota system.)

The service is a thin, locked translation layer: proto -> PodGang IR ->
dense encode -> one solve() on `device` (the card unless the caller passes
"cpu", which runs the plain PyTorch versions) -> one copy of its planes to
the host -> bindings. All placement state (nodes, gangs,
bindings) lives here so repeated Solve calls are incremental: already-bound
pods shrink group floors and pin required pack-sets to their domains.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures
from typing import Optional

import grpc

from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.podgang import (
    IRTopologyConstraint,
    NamespacedName,
    PodGang,
    PodGroup,
    TopologyConstraintGroupConfig,
    TopologyPackConstraint,
)
from grove_tpu_torch.api.types import (
    ClusterTopology,
    Container,
    PodSpec,
    TopologyDomain,
    TopologyLevel,
)
from grove_tpu_torch.backend.proto import scheduler_backend_pb2 as pb
from grove_tpu_torch.solver.core import decode_bindings, fetch_result, resolve_device, solve
from grove_tpu_torch.solver.encode import encode_gangs, pack_set_count
from grove_tpu_torch.solver.escalation import EscalationDamper, escalation_fingerprint
from grove_tpu_torch.solver.planner import (
    build_pending_subgang,
    build_spread_avoid,
    sort_pending,
)
from grove_tpu_torch.solver.warm import WarmPath, gang_row_digest
from grove_tpu_torch.state.cluster import Node, build_snapshot

SERVICE_NAME = "grove_tpu.backend.v1.SchedulerBackend"
BACKEND_NAME = "grove-tpu"
SCHEDULER_NAME = "grove-tpu-scheduler"
PENDING_GATE = "grove.io/podgang-pending-creation"
LABEL_PODGANG = "grove.io/podgang"


def _pack_constraint(p: Optional[pb.PackConstraint]) -> Optional[IRTopologyConstraint]:
    if p is None or (not p.required_key and not p.preferred_key):
        return None
    return IRTopologyConstraint(
        pack_constraint=TopologyPackConstraint(
            required=p.required_key or None, preferred=p.preferred_key or None
        )
    )


def _gang_from_proto(
    spec: pb.PodGangSpec,
) -> tuple[
    PodGang,
    dict[str, dict[str, float]],
    dict[str, dict[str, str]],
    dict[str, list[dict]],
]:
    """Proto -> PodGang IR + per-group maps: per-pod requests, nodeSelector,
    tolerations."""
    gang = PodGang(name=spec.name, namespace=spec.namespace or "default")
    gang.spec.priority_class_name = spec.priority_class_name
    gang.spec.topology_constraint = _pack_constraint(
        spec.pack_constraint if spec.HasField("pack_constraint") else None
    )
    gang.base_podgang_name = spec.base_podgang_name or None
    gang.pcs_name = spec.pcs_name or ""
    gang.pcs_replica_index = spec.pcs_replica_index
    gang.spec.spread_key = spec.spread_key or None
    if spec.HasField("reuse_reservation_ref"):
        gang.spec.reuse_reservation_ref = NamespacedName(
            spec.reuse_reservation_ref.namespace, spec.reuse_reservation_ref.name
        )
    requests: dict[str, dict[str, float]] = {}
    selectors: dict[str, dict[str, str]] = {}
    tolerations: dict[str, list[dict]] = {}
    for grp in spec.pod_groups:
        g = PodGroup(
            name=grp.name,
            pod_references=[
                NamespacedName(r.namespace or "default", r.name) for r in grp.pod_references
            ],
            min_replicas=grp.min_replicas,
            topology_constraint=_pack_constraint(
                grp.pack_constraint if grp.HasField("pack_constraint") else None
            ),
        )
        gang.spec.pod_groups.append(g)
        requests[grp.name] = {q.name: q.value for q in grp.per_pod_requests}
        if grp.node_selector:
            selectors[grp.name] = dict(grp.node_selector)
        if grp.tolerations:
            tolerations[grp.name] = [
                {
                    "key": t.key,
                    "operator": t.operator or "Equal",
                    "value": t.value,
                    "effect": t.effect,
                }
                for t in grp.tolerations
            ]
    for gc in spec.group_configs:
        gang.spec.topology_constraint_group_configs.append(
            TopologyConstraintGroupConfig(
                name=gc.name,
                pod_group_names=list(gc.pod_group_names),
                topology_constraint=_pack_constraint(
                    gc.pack_constraint if gc.HasField("pack_constraint") else None
                ),
            )
        )
    return gang, requests, selectors, tolerations


class TPUSchedulerBackend:
    """Servicer: control RPCs are short critical sections; Solve snapshots
    state under the lock, runs encode + device solve UNLOCKED, then
    re-acquires to commit — concurrent SyncPodGang/UpdateCluster RPCs are
    never blocked behind a device execution (GREP-375 contract,
    docs/proposals/375-scheduler-backend-framework/README.md:158-202)."""

    def __init__(
        self, solver_config=None, priority_classes=None, metrics=None, device=None
    ) -> None:
        from grove_tpu_torch.runtime.config import SolverConfig
        from grove_tpu_torch.utils.metrics import Registry

        # Solver-side observability (GREP-244 placement-metrics direction):
        # shared registry when hosted by the manager (surfaces on /metrics),
        # private one standalone.
        reg = metrics or Registry()
        # The card unless the caller asks for the CPU; no card raises here.
        self.device = resolve_device(device)
        self._m_solves = reg.counter(
            "grove_backend_solves_total", "Solve RPCs that ran a device solve"
        )
        self._m_solve_seconds = reg.histogram(
            "grove_backend_solve_seconds", "end-to-end Solve RPC latency"
        )
        self._m_gangs_admitted = reg.counter(
            "grove_backend_gangs_admitted_total", "gangs admitted by Solve"
        )
        self._m_gangs_rejected = reg.counter(
            "grove_backend_gangs_rejected_total", "gangs left pending by Solve"
        )
        self._m_pods_bound = reg.counter(
            "grove_backend_pods_bound_total", "pod bindings committed"
        )
        # Warm-path observability: AOT executable-cache traffic + per-gang
        # encode-row reuse (solver/warm.py).
        self._m_exec_hits = reg.counter(
            "grove_backend_exec_cache_hits_total",
            "solver launch cache hits (no launch prepared)",
        )
        self._m_exec_misses = reg.counter(
            "grove_backend_exec_cache_misses_total",
            "solver launch cache misses (prepared a launch)",
        )
        self._m_encode_reuse = reg.counter(
            "grove_backend_encode_reuse_hits_total",
            "gang encode rows reused from the previous Solve",
        )
        self._lock = threading.Lock()
        # One solve at a time (capacity accounting is sequential); control
        # RPCs use _lock only.
        self._solve_lock = threading.Lock()
        # Futile-escalation damper (see _solve_unlocked; definition shared
        # with the controller in solver/escalation.py).
        self._escalation_damper = EscalationDamper()
        # Warm path (solver/warm.py): AOT executables, device-resident node
        # tensors across Solve RPCs, per-gang encode-row reuse.
        self._warm = WarmPath()
        self._topology = ClusterTopology(name="backend", levels=[])
        self._nodes: dict[str, Node] = {}
        self._gangs: dict[str, PodGang] = {}
        self._group_requests: dict[str, dict[str, dict[str, float]]] = {}  # gang -> group -> reqs
        self._group_selectors: dict[str, dict[str, dict[str, str]]] = {}  # gang -> group -> nodeSelector
        self._group_tolerations: dict[str, dict[str, list]] = {}  # gang -> group -> tolerations
        self._bindings: dict[str, tuple[str, str, str]] = {}  # pod -> (node, gang, group)
        self._scheduled_gangs: set[str] = set()
        self._solver_config = solver_config or SolverConfig()
        # Frozen config -> build once; Solve is the p99-tuned path.
        self._solver_params = self._solver_config.solver_params()
        # Candidate pruning (solver/pruning.py): sidecar Solve RPCs ride the
        # same pruned path as the in-process controller when configured.
        self._pruning = self._solver_config.pruning_config()
        # Host-config defaults; an Init carrying priority_classes overrides.
        self._priority_classes: dict[str, int] = dict(priority_classes or {})
        # Wall seconds of the last Solve's stages (collect, snapshotEncode,
        # solve, fetchDecode, commit) and, on the card, the solve's device
        # milliseconds by CUDA events (solveEventMs); {} before the first.
        # Filled as the Solve (one at a time, under _solve_lock) proceeds.
        self.last_stages: dict = {}

    @staticmethod
    def _bucket(value: int, configured: Optional[int]) -> int:
        """Stable encode shapes: the configured bound (a floor, never a cap),
        with overflow still rounded to the next power of two — recurring
        solve shapes reuse the compiled program instead of recompiling per
        pending-set size."""
        from grove_tpu_torch.solver.encode import next_pow2

        pow2 = next_pow2(value)
        return max(configured, pow2) if configured else pow2

    @staticmethod
    def _gang_fingerprint(
        gang: PodGang, reqs: dict, sels: dict, tols: dict
    ) -> tuple:
        """Spec identity for mid-solve drift detection (see _commit): pods,
        floors, per-group requests, nodeSelectors, tolerations, and every
        pack-constraint key — a selector/toleration-only re-sync invalidates
        the placement too."""

        def pc(tc):
            if tc is None or tc.pack_constraint is None:
                return None
            return (tc.pack_constraint.required, tc.pack_constraint.preferred)

        return (
            tuple(
                (
                    grp.name,
                    grp.min_replicas,
                    tuple(sorted(r.name for r in grp.pod_references)),
                    tuple(sorted((reqs.get(grp.name) or {}).items())),
                    tuple(sorted((sels.get(grp.name) or {}).items())),
                    tuple(
                        tuple(sorted(t.items()))
                        for t in (tols.get(grp.name) or [])
                    ),
                    pc(grp.topology_constraint),
                )
                for grp in gang.spec.pod_groups
            ),
            pc(gang.spec.topology_constraint),
            tuple(
                (gc.name, tuple(gc.pod_group_names), pc(gc.topology_constraint))
                for gc in gang.spec.topology_constraint_group_configs
            ),
        )

    # ---- GREP-375 surface --------------------------------------------------------

    def Init(self, request: pb.InitRequest, context) -> pb.InitResponse:
        levels = []
        for lv in request.topology:
            try:
                levels.append(TopologyLevel(TopologyDomain(lv.domain), lv.node_label_key))
            except ValueError:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, f"unknown topology domain {lv.domain!r}"
                )
        with self._lock:
            self._topology = ClusterTopology(name="backend", levels=levels)
            if request.priority_classes:
                self._priority_classes = dict(request.priority_classes)
        return pb.InitResponse(name=BACKEND_NAME)

    def SyncPodGang(self, request: pb.SyncPodGangRequest, context) -> pb.SyncPodGangResponse:
        gang, requests, selectors, tolerations = _gang_from_proto(request.pod_gang)
        if not gang.name:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "pod_gang.name required")
        with self._lock:
            self._gangs[gang.name] = gang
            self._group_requests[gang.name] = requests
            self._group_selectors[gang.name] = selectors
            self._group_tolerations[gang.name] = tolerations
            # Drop bindings of pods no longer referenced (spec shrink).
            live = {r.name for g in gang.spec.pod_groups for r in g.pod_references}
            for pod in [p for p, (_, gname, _) in self._bindings.items()
                        if gname == gang.name and p not in live]:
                del self._bindings[pod]
        return pb.SyncPodGangResponse()

    def OnPodGangDelete(self, request: pb.OnPodGangDeleteRequest, context) -> pb.OnPodGangDeleteResponse:
        with self._lock:
            self._gangs.pop(request.name, None)
            self._group_requests.pop(request.name, None)
            self._group_selectors.pop(request.name, None)
            self._group_tolerations.pop(request.name, None)
            self._scheduled_gangs.discard(request.name)
            for pod in [p for p, (_, gname, _) in self._bindings.items() if gname == request.name]:
                del self._bindings[pod]
        return pb.OnPodGangDeleteResponse()

    def PreparePod(self, request: pb.PreparePodRequest, context) -> pb.PreparePodResponse:
        resp = pb.PreparePodResponse(
            scheduler_name=SCHEDULER_NAME, scheduling_gates=[PENDING_GATE]
        )
        if request.pod_gang_name:
            resp.labels[LABEL_PODGANG] = request.pod_gang_name
        return resp

    def ValidatePodCliqueSet(self, request: pb.ValidatePodCliqueSetRequest, context) -> pb.ValidatePodCliqueSetResponse:
        import yaml

        from grove_tpu_torch.api import (
            PodCliqueSet,
            default_podcliqueset,
            validate_podcliqueset,
        )

        try:
            doc = yaml.safe_load(request.pcs_yaml)
            pcs = default_podcliqueset(PodCliqueSet.from_dict(doc))
        except Exception as exc:  # malformed input is a validation error, not a crash
            return pb.ValidatePodCliqueSetResponse(errors=[f"unparseable PodCliqueSet: {exc}"])
        with self._lock:
            topology = self._topology
        errors = [str(e) for e in validate_podcliqueset(pcs, topology.with_host_level())]
        return pb.ValidatePodCliqueSetResponse(errors=errors)

    # ---- placement cycle ---------------------------------------------------------

    def UpdateCluster(self, request: pb.UpdateClusterRequest, context) -> pb.UpdateClusterResponse:
        with self._lock:
            if request.full_replace:
                self._nodes.clear()
            for n in request.nodes:
                self._nodes[n.name] = Node(
                    name=n.name,
                    capacity={q.name: q.value for q in n.capacity},
                    labels=dict(n.labels),
                    schedulable=n.schedulable,
                    taints=[
                        {"key": t.key, "value": t.value, "effect": t.effect}
                        for t in n.taints
                    ],
                )
            return pb.UpdateClusterResponse(node_count=len(self._nodes))

    def ReleasePods(self, request: pb.ReleasePodsRequest, context) -> pb.ReleasePodsResponse:
        with self._lock:
            for name in request.pod_names:
                self._bindings.pop(name, None)
        return pb.ReleasePodsResponse()

    def Solve(self, request: pb.SolveRequest, context) -> pb.SolveResponse:
        # request.speculative is accepted and ignored (wire-compat): the
        # speculative path was deleted in round 4 after losing to the
        # sequential scan in every measured regime.
        t0 = time.perf_counter()
        with self._solve_lock:  # one device solve at a time
            with self._lock:
                work = self._collect_pending()
            stages = self.last_stages = {"collectS": time.perf_counter() - t0}
            if work is None:
                result = pb.SolveResponse()
            else:
                # UNLOCKED device phase: encode + the solve on the card + decode run
                # without blocking control RPCs. The state may drift
                # meanwhile; _commit re-validates every binding against the
                # live state before applying it.
                solved = self._solve_unlocked(work)
                t_commit = time.perf_counter()
                with self._lock:
                    result = self._commit(work, *solved)
                stages["commitS"] = time.perf_counter() - t_commit
                stages["gangs"] = len(work["pending"])
        result.solve_micros = int((time.perf_counter() - t0) * 1e6)
        if work is not None:
            self._m_solves.inc()
            self._m_solve_seconds.observe(time.perf_counter() - t0)
            admitted = sum(1 for g in result.gangs if g.admitted)
            self._m_gangs_admitted.inc(admitted)
            self._m_gangs_rejected.inc(len(result.gangs) - admitted)
            self._m_pods_bound.inc(
                sum(len(g.bindings) for g in result.gangs if g.admitted)
            )
        return result

    def _collect_pending(self):
        """Under lock: snapshot everything the solve needs into plain values."""
        if not self._nodes:
            return None
        # Sub-gangs over unbound pods, floors shrunk by bound pods — the same
        # incremental discipline as the in-process controller
        # (orchestrator/controller.py solve_pending).
        pending: list[PodGang] = []
        pods_by_name: dict[str, Pod] = {}
        bound_nodes_by_group: dict[str, dict[str, list[str]]] = {}
        # Batch order IS the solver's priority order (InitRequest proto):
        # family-max priority first, bases before their scaled gangs
        # (sort_pending — the shared discipline with the in-process
        # controller; an inline sort here once broke the base-before-scaled
        # invariant for high-priority scaled gangs).
        for gang in sort_pending(
            list(self._gangs.values()),
            lambda g: self._priority_classes.get(g.spec.priority_class_name, 0),
        ):
            reqs = self._group_requests.get(gang.name, {})
            sels = self._group_selectors.get(gang.name, {})
            tols = self._group_tolerations.get(gang.name, {})
            unbound_refs: dict[str, list] = {}
            bound_counts: dict[str, int] = {}
            per_group_bound: dict[str, list[str]] = {}
            for grp in gang.spec.pod_groups:
                unbound = [r for r in grp.pod_references if r.name not in self._bindings]
                bound = [r for r in grp.pod_references if r.name in self._bindings]
                if bound:
                    per_group_bound[grp.name] = [self._bindings[r.name][0] for r in bound]
                    bound_counts[grp.name] = len(bound)
                if not unbound:
                    continue
                unbound_refs[grp.name] = unbound
                group_reqs = reqs.get(grp.name, {})
                group_sel = sels.get(grp.name, {})
                group_tol = tols.get(grp.name, [])
                for ref in unbound:
                    pods_by_name[ref.name] = Pod(
                        name=ref.name,
                        namespace=ref.namespace,
                        spec=PodSpec(
                            containers=[Container(name="c", requests=dict(group_reqs))],
                            node_selector=dict(group_sel),
                            tolerations=list(group_tol),
                        ),
                    )
            sub = build_pending_subgang(gang, unbound_refs, bound_counts)
            if sub is None:
                continue
            if per_group_bound:
                bound_nodes_by_group[gang.name] = per_group_bound
            pending.append(sub)
        if not pending:
            return None

        bound_pods = [
            Pod(
                name=pod,
                node_name=node,
                spec=PodSpec(containers=[Container(
                    name="c",
                    requests=dict(self._group_requests.get(gname, {}).get(group, {})),
                )]),
            )
            for pod, (node, gname, group) in self._bindings.items()
            if node in self._nodes
        ]
        # ReuseReservationRef inputs (node NAMES; indices resolved after the
        # snapshot is built outside the lock). One pass over _bindings, not
        # one per pending gang — this runs under the control-RPC lock.
        nodes_by_gang: dict[str, set[str]] = {}
        for pod, (node, gname, _) in self._bindings.items():
            nodes_by_gang.setdefault(gname, set()).add(node)
        reuse_names_by_gang: dict[str, set[str]] = {}
        for sub in pending:
            ref = self._gangs[sub.name].spec.reuse_reservation_ref
            if ref is not None and ref.name in nodes_by_gang:
                reuse_names_by_gang[sub.name] = nodes_by_gang[ref.name]
        # Replica-spread seed: nodes bound to SIBLING replicas of a spreading
        # base gang (same pcs_name, different replica index). One grouping
        # pass over _gangs (like nodes_by_gang above), not one scan per
        # pending gang — this runs under the control-RPC lock.
        spread_names_by_gang: dict[str, set[str]] = {}
        spreading = [
            self._gangs[sub.name]
            for sub in pending
            if self._gangs[sub.name].spec.spread_key is not None
            and self._gangs[sub.name].base_podgang_name is None
        ]
        if spreading:
            nodes_by_pcs_replica: dict[tuple[str, int], set[str]] = {}
            for other in self._gangs.values():
                if other.pcs_name:
                    nodes_by_pcs_replica.setdefault(
                        (other.pcs_name, other.pcs_replica_index), set()
                    ).update(nodes_by_gang.get(other.name, ()))
            spread_names_by_gang = build_spread_avoid(
                spreading, nodes_by_pcs_replica
            )
        return {
            "pending": pending,
            "pods_by_name": pods_by_name,
            "bound_nodes_by_group": bound_nodes_by_group,
            "bound_pods": bound_pods,
            "nodes": list(self._nodes.values()),
            "topology": self._topology,
            "scheduled_gangs": set(self._scheduled_gangs),
            "reuse_names_by_gang": reuse_names_by_gang,
            "spread_names_by_gang": spread_names_by_gang,
            # Spec fingerprints for drift detection at commit time.
            "fingerprints": {
                sub.name: self._gang_fingerprint(
                    self._gangs[sub.name],
                    self._group_requests.get(sub.name, {}),
                    self._group_selectors.get(sub.name, {}),
                    self._group_tolerations.get(sub.name, {}),
                )
                for sub in pending
            },
        }

    def _solve_unlocked(self, work: dict):
        """No lock held: snapshot build, bucketed encode, device solve, decode
        (their walls go into `last_stages`)."""
        from grove_tpu_torch.solver.encode import next_pow2

        stages = self.last_stages
        t0 = time.perf_counter()
        pending = work["pending"]
        # Node axis pow2-bucketed like every encode axis: cluster growth
        # inside a bucket reuses the prepared launch (no new lowering).
        snapshot = build_snapshot(
            work["nodes"],
            work["topology"],
            bound_pods=work["bound_pods"],
            pad_nodes_to=next_pow2(len(work["nodes"])),
        )
        bound_idx = {
            gname: {
                grp: [snapshot.node_index(n) for n in nodes if n in snapshot.node_index_map]
                for grp, nodes in groups.items()
            }
            for gname, groups in work["bound_nodes_by_group"].items()
        }
        reuse_by_gang = {
            gname: sorted(
                snapshot.node_index(n)
                for n in names
                if n in snapshot.node_index_map
            )
            for gname, names in work["reuse_names_by_gang"].items()
        }
        spread_by_gang = {
            gname: sorted(
                snapshot.node_index(n)
                for n in names
                if n in snapshot.node_index_map
            )
            for gname, names in work["spread_names_by_gang"].items()
        }
        # Bucketed shapes (SolverConfig or next-pow2): repeated Solve calls
        # with drifting pending-set sizes hit the warm compiled program.
        cfg = self._solver_config
        mg = self._bucket(max(len(g.spec.pod_groups) for g in pending), cfg.max_groups)
        mp = self._bucket(max(g.total_pods() for g in pending), cfg.max_pods)

        # Like mg/mp, the configured bound is a floor preference, never a cap
        # below the real demand — an undersized bucket would make encode raise
        # and wedge every subsequent Solve.
        ms = self._bucket(max(max(pack_set_count(g) for g in pending), 1), cfg.max_sets)
        if cfg.pad_gangs_to:
            pad_to = cfg.pad_gangs_to * max(1, -(-len(pending) // cfg.pad_gangs_to))
        else:
            pad_to = self._bucket(len(pending), None)
        # Incremental encode reuse: gangs whose spec digest + snapshot epoch
        # match the previous Solve copy their dense rows instead of re-
        # walking the proto-derived spec (solver/warm.py; keyed on spec
        # hash, not object identity — _collect_pending rebuilds sub-gang
        # objects every RPC).
        epoch = snapshot.encode_epoch()
        row_keys = [
            (gang_row_digest(sub, work["pods_by_name"]), epoch) for sub in pending
        ]
        h0 = self._warm.encode_rows.hits
        x0 = (self._warm.executables.hits, self._warm.executables.misses)
        batch, decode = encode_gangs(
            pending,
            work["pods_by_name"],
            snapshot,
            max_groups=mg,
            max_sets=ms,
            max_pods=mp,
            pad_gangs_to=pad_to,
            scheduled_gangs=work["scheduled_gangs"],
            bound_nodes_by_group=bound_idx,
            reuse_nodes_by_gang=reuse_by_gang,
            spread_avoid_by_gang=spread_by_gang,
            row_cache=self._warm.encode_rows,
            row_keys=row_keys,
        )
        # solver.portfolio > 1: the sidecar's Solve explores P weight
        # variants and keeps the winner (multi-chip quality path; the
        # variants shard over the device mesh when one exists).
        # portfolioEscalation: a rejecting base solve retries once under P
        # variants — dampened by the same futile-fingerprint discipline as
        # the controller (a saturated steady state must not pay P-variant
        # cost every Solve when nothing changed).
        esc = self._solver_config.portfolio_escalation
        esc_fp = None
        if esc > self._solver_config.portfolio:
            esc_fp = escalation_fingerprint(
                work["fingerprints"].items(),
                ((p.name, p.node_name) for p in work["bound_pods"]),
                work["nodes"],
            )
            esc = self._escalation_damper.effective_width(
                "solve", esc_fp, self._solver_config.portfolio, esc
            )
        events = None
        if self.device.type == "cuda":
            import torch

            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t1 = time.perf_counter()
        stages["snapshotEncodeS"] = t1 - t0
        result = solve(
            snapshot,
            batch,
            params=self._solver_params,
            portfolio=self._solver_config.portfolio,
            escalate_portfolio=esc,
            warm=self._warm,
            pruning=self._pruning,
            device=self.device,
        )
        if events is not None:
            events[1].record()
        t2 = time.perf_counter()
        stages["solveS"] = t2 - t1
        # One copy from the card for the whole solve: verdicts, scores and
        # assignments together (the controller reads its solves the same way).
        ok_arr, assigned_arr, score_arr = fetch_result(result)
        bindings = decode_bindings(ok_arr, assigned_arr, decode, snapshot)
        stages["fetchDecodeS"] = time.perf_counter() - t2
        if events is not None:
            stages["solveEventMs"] = events[0].elapsed_time(events[1])
        self._m_encode_reuse.inc(self._warm.encode_rows.hits - h0)
        self._m_exec_hits.inc(self._warm.executables.hits - x0[0])
        self._m_exec_misses.inc(self._warm.executables.misses - x0[1])

        import numpy as np

        ok = dict(zip(decode.gang_names, ok_arr))
        scores = dict(zip(decode.gang_names, score_arr))
        valid = dict(zip(decode.gang_names, np.asarray(batch.gang_valid)))
        any_valid_rejected = any(
            valid.get(n, False) and not ok.get(n, False) for n in decode.gang_names
        )
        if esc_fp is not None:
            self._escalation_damper.record(
                "solve", esc_fp, esc > self._solver_config.portfolio,
                any_valid_rejected,
            )
        return bindings, ok, scores

    def _commit(self, work: dict, bindings, ok, scores) -> pb.SolveResponse:
        """Under lock again: re-validate against live state, apply bindings.

        The state may have drifted during the unlocked device phase; a gang
        deleted or re-synced mid-solve gets its stale result dropped (the
        next Solve sees the new truth) — same discipline as the reference
        scheduler racing the apiserver."""
        resp = pb.SolveResponse()
        group_of_pod = {
            r.name: (g.name, grp.name)
            for g in work["pending"]
            for grp in g.spec.pod_groups
            for r in grp.pod_references
        }
        for sub in work["pending"]:
            gang_name = sub.name
            live = self._gangs.get(gang_name)
            if live is None:
                continue  # deleted mid-solve: drop the stale result
            # Spec drift: a re-sync that changed requests, floors, refs, or
            # constraints invalidates the solved placement even when pod
            # names are unchanged — comparing names alone would commit
            # bindings solved for the OLD spec.
            live_fp = self._gang_fingerprint(
                live,
                self._group_requests.get(gang_name, {}),
                self._group_selectors.get(gang_name, {}),
                self._group_tolerations.get(gang_name, {}),
            )
            spec_drifted = live_fp != work["fingerprints"].get(gang_name)
            gr = pb.GangResult(
                name=gang_name,
                placement_score=float(scores.get(gang_name, 0.0)),
            )
            valid: list[tuple[str, str]] = []
            dropped = 1 if spec_drifted else 0
            for pod_name, node_name in bindings.get(gang_name, {}).items():
                node = self._nodes.get(node_name)
                if (
                    spec_drifted
                    or pod_name in self._bindings  # concurrently bound
                    or node is None  # node removed mid-solve
                    or not node.schedulable  # node cordoned mid-solve
                ):
                    dropped += 1
                else:
                    valid.append((pod_name, node_name))
            # Admission holds only if the ENTIRE solved placement survived
            # revalidation — a partially-dropped result must not bind a
            # remnant, ungate the gang, or unblock scaled gangs waiting on it
            # (all-or-nothing); the next Solve re-places it whole.
            gr.admitted = bool(ok.get(gang_name, False)) and dropped == 0
            if gr.admitted:
                for pod_name, node_name in valid:
                    gr.bindings.append(pb.Binding(pod_name=pod_name, node_name=node_name))
                    _, group = group_of_pod[pod_name]
                    self._bindings[pod_name] = (node_name, gang_name, group)
                self._scheduled_gangs.add(gang_name)
            resp.gangs.append(gr)
        return resp


def _handlers(servicer: TPUSchedulerBackend) -> grpc.GenericRpcHandler:
    """Manual method table — grpc_tools codegen isn't in the image; the
    generic-handler API with protobuf serializers is exactly what generated
    stubs produce anyway."""
    methods = {
        "Init": pb.InitRequest,
        "SyncPodGang": pb.SyncPodGangRequest,
        "OnPodGangDelete": pb.OnPodGangDeleteRequest,
        "PreparePod": pb.PreparePodRequest,
        "ValidatePodCliqueSet": pb.ValidatePodCliqueSetRequest,
        "UpdateCluster": pb.UpdateClusterRequest,
        "ReleasePods": pb.ReleasePodsRequest,
        "Solve": pb.SolveRequest,
    }
    table = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_cls.FromString,
            response_serializer=lambda resp: resp.SerializeToString(),
        )
        for name, req_cls in methods.items()
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, table)


def create_server(
    port: int = 0,
    max_workers: int = 8,
    solver_config=None,
    priority_classes=None,
    metrics=None,
    device=None,
) -> tuple[grpc.Server, int]:
    """Build + start the sidecar server; returns (server, bound port).
    `device`: the card (None) or "cpu" for the plain versions."""
    return serve_backend(
        TPUSchedulerBackend(
            solver_config=solver_config,
            priority_classes=priority_classes,
            metrics=metrics,
            device=device,
        ),
        port=port,
        max_workers=max_workers,
    )


def serve_backend(servicer: TPUSchedulerBackend, port: int = 0,
                  max_workers: int = 8) -> tuple[grpc.Server, int]:
    """Start a gRPC server on 127.0.0.1 around an existing servicer (whose
    stages and caches the caller can then read); returns (server, bound
    port)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_handlers(servicer),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound


def main(argv=None) -> None:
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="grove-tpu scheduler backend sidecar")
    parser.add_argument("--port", type=int, default=50055)
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (the default: the card, which must be present) or cpu (the "
             "plain PyTorch versions)",
    )
    args = parser.parse_args(argv)
    # The card is probed and named before the server binds; a missing card
    # is an error, never a silent fall back to the CPU.
    from grove_tpu_torch.utils.platform import describe_device

    print(f"device: {describe_device(args.device)}", file=sys.stderr, flush=True)
    server, bound = create_server(port=args.port, device=args.device)
    print(f"{BACKEND_NAME} backend listening on 127.0.0.1:{bound}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
