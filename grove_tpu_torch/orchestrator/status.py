"""Status & condition computation for cliques, scaling groups, and sets.

Parity targets:
  - MinAvailableBreached / PodCliqueScheduled semantics
    (podclique/reconcilestatus.go:170-226): scheduled < minAvailable ⇒ NOT
    breached (pre-schedule flap guard); ready-or-starting < minAvailable ⇒
    breached; update in progress ⇒ Unknown.
  - PCSG availability rollup (podcliquescalinggroup/reconcilestatus.go):
    replica scheduled = every member clique scheduled; replica available =
    every member clique not breached; MinAvailableBreached when
    available < spec.minAvailable (same pre-schedule guard).
  - PCS rollup incl. AvailableReplicas and per-gang phases
    (podcliqueset/reconcilestatus.go).

The port's copy of grove_tpu/orchestrator/status.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from grove_tpu_torch.api import constants
from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.podgang import PodGang, PodGangPhase
from grove_tpu_torch.api.types import (
    Condition,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueSet,
    PodGangStatusSummary,
    set_condition,
)
from grove_tpu_torch.orchestrator.store import Cluster


def is_starting(pod: Pod) -> bool:
    """Scheduled, alive, not yet ready, not crash-looping — counts toward the
    availability grace (utils/kubernetes/pod.go pod categorization: a pod whose
    container terminated erroneously is NOT starting)."""
    return pod.is_scheduled and pod.is_active and not pod.ready and not pod.crashlooping




def _hpa_selector(extra_key: str, extra_val: str, pcs_name: str) -> str:
    """Label-selector string for autoscaler use (mutateSelector analog,
    podclique/reconcilestatus.go:150-167): the managed-by + part-of labels
    every built pod carries, narrowed to the owning object."""
    return ",".join(
        f"{k}={v}"
        for k, v in (
            (constants.LABEL_MANAGED_BY, constants.LABEL_MANAGED_BY_VALUE),
            (constants.LABEL_PART_OF, pcs_name),
            (extra_key, extra_val),
        )
    )


def compute_podclique_status(
    cluster: Cluster, clique: PodClique, now: float, updating: bool = False
) -> None:
    """Recompute clique status + conditions in place."""
    # Autoscaler selector. The reference fills it only when scaling is
    # configured (reconcilestatus.go:150-167); here it is ALWAYS populated —
    # the child CRD's scale subresource names .status.selector as
    # labelSelectorPath, and a cluster HPA targeting a non-auto-scaled
    # clique would fail on an empty selector. The selector is a pure
    # function of the clique's identity, so there is nothing to go stale.
    clique.status.selector = _hpa_selector(
        constants.LABEL_PODCLIQUE, clique.metadata.name, clique.pcs_name
    )
    pods = [p for p in cluster.pods_of_clique(clique.metadata.name) if p.is_active]
    scheduled = sum(1 for p in pods if p.is_scheduled)
    ready = sum(1 for p in pods if p.ready)
    ready_or_starting = sum(1 for p in pods if p.ready or is_starting(p))
    min_available = clique.min_available

    st = clique.status
    st.replicas = len(pods)
    st.scheduled_replicas = scheduled
    st.ready_replicas = ready
    st.schedule_gated_replicas = sum(1 for p in pods if p.is_gated)
    st.updated_replicas = sum(
        1
        for p in pods
        if p.pod_template_hash and p.pod_template_hash == st.current_pod_template_hash
    )

    sched_cond = Condition(
        type=constants.CONDITION_POD_CLIQUE_SCHEDULED,
        status="True" if scheduled >= min_available else "False",
        reason="SufficientScheduledPods" if scheduled >= min_available else "InsufficientScheduledPods",
    )
    st.conditions = set_condition(st.conditions, sched_cond, now)

    if updating:
        breached_status, reason = "Unknown", "UpdateInProgress"
    elif scheduled < min_available:
        # Not yet scheduled: never breached (avoids pre-schedule flapping,
        # reconcilestatus.go:193-203).
        breached_status, reason = "False", "WaitingForScheduling"
    elif ready_or_starting < min_available:
        breached_status, reason = "True", "InsufficientReadyOrStartingPods"
    else:
        breached_status, reason = "False", "SufficientAvailablePods"
    st.conditions = set_condition(
        st.conditions,
        Condition(type=constants.CONDITION_MIN_AVAILABLE_BREACHED, status=breached_status, reason=reason),
        now,
    )


def clique_breached(clique: PodClique) -> bool:
    for c in clique.status.conditions:
        if c.type == constants.CONDITION_MIN_AVAILABLE_BREACHED:
            return c.status == "True"
    return False


def clique_breached_since(clique: PodClique) -> float | None:
    for c in clique.status.conditions:
        if c.type == constants.CONDITION_MIN_AVAILABLE_BREACHED and c.status == "True":
            return c.last_transition_time
    return None


def compute_pcsg_status(
    cluster: Cluster, pcsg: PodCliqueScalingGroup, now: float, updating: bool = False
) -> None:
    """Aggregate member-clique state per PCSG replica."""
    # Always populated (deviation from the reference's scaling-configured
    # gate, podcliquescalinggroup/reconcilestatus.go:245, for the same
    # reason as the clique selector above: the CRD's scale subresource
    # names .status.selector, and it is a pure function of identity).
    pcsg.status.selector = _hpa_selector(
        constants.LABEL_SCALING_GROUP, pcsg.metadata.name, pcsg.pcs_name
    )
    members = cluster.cliques_of_pcsg(pcsg.metadata.name)
    by_replica: dict[int, list[PodClique]] = defaultdict(list)
    for c in members:
        if c.pcsg_replica_index is not None:
            by_replica[c.pcsg_replica_index].append(c)

    expected_member_count = len(pcsg.spec.clique_names)
    scheduled = available = 0
    for _, cliques in sorted(by_replica.items()):
        if len(cliques) < expected_member_count:
            continue
        if all(
            any(
                c2.type == constants.CONDITION_POD_CLIQUE_SCHEDULED and c2.status == "True"
                for c2 in c.status.conditions
            )
            for c in cliques
        ):
            scheduled += 1
            if all(not clique_breached(c) for c in cliques):
                available += 1

    st = pcsg.status
    st.replicas = pcsg.spec.replicas
    st.scheduled_replicas = scheduled
    st.available_replicas = available

    min_available = pcsg.spec.min_available
    if updating:
        status, reason = "Unknown", "UpdateInProgress"
    elif scheduled < min_available:
        status, reason = "False", "WaitingForScheduling"
    elif available < min_available:
        status, reason = "True", "InsufficientAvailableReplicas"
    else:
        status, reason = "False", "SufficientAvailableReplicas"
    st.conditions = set_condition(
        st.conditions,
        Condition(type=constants.CONDITION_MIN_AVAILABLE_BREACHED, status=status, reason=reason),
        now,
    )


def clique_rolling_state(cluster: Cluster, clique, want_hash: str) -> tuple[bool, int]:
    """(has stale active pod, ready active count) — the shared input to the
    update-completion predicate (isPCLQUpdateComplete,
    rollingupdate.go:286-295). Both the PCS-replica advance decision and the
    PCSG-replica status bookkeeping MUST read it from here so the two
    granularities cannot diverge on what 'updated' means."""
    pods = [p for p in cluster.pods_of_clique(clique.metadata.name) if p.is_active]
    stale = any(p.pod_template_hash != want_hash for p in pods)
    ready = sum(1 for p in pods if p.ready)
    return stale, ready


def sync_pcsg_rolling_progress(
    cluster: Cluster,
    pcsg: PodCliqueScalingGroup,
    desired_hash,
    now: float,
    updating: bool = False,
    pcs_update_started_at: Optional[float] = None,
) -> None:
    """Maintain the PCSG-level rolling-update bookkeeping the reference keeps
    in PCSG status (scalinggroup.go:106-129): `updated_replicas` plus a
    `PCSGRollingUpdateProgress` with per-replica completion.

    A PCSG replica counts as updated when none of its member-clique pods is
    on a stale template hash AND every member clique is back to ready >=
    minAvailable (clique_rolling_state), at PCSG-replica granularity.
    `desired_hash` maps a PodClique -> its wanted hash; `updating` says the
    owning PCS has an active rolling update, and `pcs_update_started_at` is
    that update's start time (a PCS restart mid-roll restarts this progress
    too, mirroring the PCS-level reset on generation-hash change)."""
    from grove_tpu_torch.api.types import PCSGRollingUpdateProgress

    st = pcsg.status
    prog = st.rolling_update_progress
    prog_active = prog is not None and prog.update_ended_at is None
    if not updating and not prog_active:
        # Steady state: skip the per-pod hash scan entirely (this runs every
        # reconcile for every PCSG). Any staleness would have started a PCS
        # update via the generation hash, flipping `updating` next pass — so
        # every CREATED replica is on the current template, and the count
        # must keep tracking scale-out/in after an update completed (a frozen
        # post-update value would over/under-report forever).
        st.updated_replicas = len(
            {
                c.pcsg_replica_index
                for c in cluster.cliques_of_pcsg(pcsg.metadata.name)
                if c.pcsg_replica_index is not None
            }
        )
        return

    members = cluster.cliques_of_pcsg(pcsg.metadata.name)
    by_replica: dict[int, list] = defaultdict(list)
    for c in members:
        if c.pcsg_replica_index is not None:
            by_replica[c.pcsg_replica_index].append(c)

    any_stale = False
    updated: list[int] = []
    for idx in range(pcsg.spec.replicas):
        cliques = by_replica.get(idx, [])
        if not cliques:
            continue
        replica_stale = False
        replica_ready = True
        for clique in cliques:
            stale, ready = clique_rolling_state(cluster, clique, desired_hash(clique))
            if stale:
                replica_stale = True
            if ready < clique.min_available:
                replica_ready = False
        any_stale = any_stale or replica_stale
        if not replica_stale and replica_ready:
            updated.append(idx)

    st.updated_replicas = len(updated)
    restarted_mid_roll = (
        prog_active
        and pcs_update_started_at is not None
        and pcs_update_started_at > prog.update_started_at
    )
    if (any_stale and not prog_active) or restarted_mid_roll:
        prog = PCSGRollingUpdateProgress(update_started_at=now)
        st.rolling_update_progress = prog
    if prog is None or prog.update_ended_at is not None:
        return
    prog.updated_replica_indices = updated
    remaining = [i for i in range(pcsg.spec.replicas) if i not in updated]
    if remaining:
        # Still rolling — or post-replacement replicas not back to ready yet.
        prog.current_replica_index = min(remaining)
    else:
        prog.current_replica_index = None
        prog.update_ended_at = now


def pcsg_breached(pcsg: PodCliqueScalingGroup) -> bool:
    for c in pcsg.status.conditions:
        if c.type == constants.CONDITION_MIN_AVAILABLE_BREACHED:
            return c.status == "True"
    return False


def pcsg_breached_since(pcsg: PodCliqueScalingGroup) -> float | None:
    for c in pcsg.status.conditions:
        if c.type == constants.CONDITION_MIN_AVAILABLE_BREACHED and c.status == "True":
            return c.last_transition_time
    return None


def compute_podgang_status(cluster: Cluster, gang: PodGang, now: float) -> None:
    """Phase + per-group scheduled counts (scheduler podgang.go:143-168)."""
    pods = [p for p in cluster.pods_of_gang(gang.name) if p.is_active]
    by_group: dict[str, list[Pod]] = defaultdict(list)
    for p in pods:
        by_group[p.pclq_fqn].append(p)

    gang.status.scheduled_replicas = {
        grp.name: sum(1 for p in by_group.get(grp.name, []) if p.is_scheduled)
        for grp in gang.spec.pod_groups
    }
    scheduled_ok = gang.is_base_gang_scheduled() and bool(gang.spec.pod_groups)
    all_ready = scheduled_ok and all(
        sum(1 for p in by_group.get(grp.name, []) if p.ready) >= grp.min_replicas
        for grp in gang.spec.pod_groups
    )
    if all_ready:
        gang.status.phase = PodGangPhase.RUNNING
    elif scheduled_ok:
        gang.status.phase = PodGangPhase.STARTING
    else:
        gang.status.phase = PodGangPhase.PENDING
    if scheduled_ok:
        gang.status.ever_scheduled = True
    gang.status.conditions = set_condition(
        gang.status.conditions,
        Condition(
            type=constants.PODGANG_CONDITION_SCHEDULED,
            status="True" if scheduled_ok else "False",
        ),
        now,
    )
    gang.status.conditions = set_condition(
        gang.status.conditions,
        Condition(
            type=constants.PODGANG_CONDITION_READY,
            status="True" if all_ready else "False",
        ),
        now,
    )
    # Unhealthy (podgang.go:155-168): the gang HAS been scheduled but some
    # group can no longer hold its floor — pods failed with their node,
    # crash-loop, or were evicted. Distinct from a never-scheduled gang
    # (that is just Pending) and from a healthy one still starting (starting
    # pods count toward the floor, like MinAvailableBreached's grace).
    was_scheduled = gang.status.ever_scheduled
    unhealthy = (
        was_scheduled
        and bool(gang.spec.pod_groups)
        and any(
            sum(
                1
                for p in by_group.get(grp.name, [])
                if p.is_scheduled and not p.crashlooping
            )
            < grp.min_replicas
            for grp in gang.spec.pod_groups
        )
    )
    gang.status.conditions = set_condition(
        gang.status.conditions,
        Condition(
            type=constants.PODGANG_CONDITION_UNHEALTHY,
            status="True" if unhealthy else "False",
        ),
        now,
    )


def compute_pcs_status(cluster: Cluster, pcs: PodCliqueSet, now: float) -> None:
    """Roll cliques/PCSGs/gangs up into the PCS status."""
    name = pcs.metadata.name
    st = pcs.status
    st.replicas = pcs.spec.replicas
    # The PCS CRD's scale subresource points labelSelectorPath here — a
    # pod-metrics HPA targeting the PCS /scale needs a selector that
    # matches ALL the set's pods.
    st.selector = ",".join(
        f"{k}={v}"
        for k, v in (
            (constants.LABEL_MANAGED_BY, constants.LABEL_MANAGED_BY_VALUE),
            (constants.LABEL_PART_OF, name),
        )
    )
    available = 0
    for i in range(pcs.spec.replicas):
        cliques = cluster.cliques_of_pcs_replica(name, i)
        pcsgs = [g for g in cluster.pcsgs_of_pcs(name) if g.pcs_replica_index == i]
        standalone = [c for c in cliques if c.pcsg_name is None]
        if not cliques:
            continue
        replica_ok = all(not clique_breached(c) for c in standalone) and all(
            not pcsg_breached(g) for g in pcsgs
        )
        # Scheduled gate must cover PCSGs too: unscheduled PCSGs are "not
        # breached" (WaitingForScheduling), so without this a PCSG-only
        # template would report availability with zero pods placed.
        scheduled = all(
            any(
                c2.type == constants.CONDITION_POD_CLIQUE_SCHEDULED and c2.status == "True"
                for c2 in c.status.conditions
            )
            for c in standalone
        ) and all(g.status.scheduled_replicas >= g.spec.min_available for g in pcsgs)
        if replica_ok and scheduled:
            available += 1
    st.available_replicas = available
    st.pod_gang_statuses = [
        PodGangStatusSummary(name=g.name, phase=g.status.phase.value, conditions=list(g.status.conditions))
        for g in sorted(cluster.gangs_of_pcs(name), key=lambda g: g.name)
    ]
    st.observed_generation = pcs.metadata.generation
