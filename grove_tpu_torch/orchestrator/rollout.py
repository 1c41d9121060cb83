"""Make-before-break rolling updates (docs/design.md "Fleet lifecycle").

The seed rolling-update path (controller._advance_rolling_update) is
delete-then-recreate: the current replica's stale pods are released and their
replacements flow through the normal solve, so the replica is DOWN for the
whole replacement window. This module is the opt-in alternative: before
touching anything, the new generation of the current replica is planned as a
synthetic gang through plan_rescue with every incumbent binding still held —
the plan lands only on capacity that is free while the old placement holds.
Only when the whole replica fits (and a shared disruption-budget slot is
free) do the stale pods drain and the replacements bind atomically through
_bind_gang's rollback discipline. Anything less defers the replica WHOLE:
no partial-generation limbo, ever.

Infeasible replicas are priced before they wait: two what-ifs run through
the trace engine's rack-cloning (trace/whatif.clone_racks) — "would
+surge_racks racks make it fit?" and "would the next candidate replica fit
instead?" — and both verdicts are journaled, so an operator reading the
flight recorder sees WHY the rollout is parked and what would unpark it.
Deferrals are paced by utils/backoff.Backoff (decorrelated jitter, driven by
the reconcile clock so sim and wall time agree); when the per-replica
deadline is spent the replica falls back to the seed delete-then-recreate
path, which always makes progress.

The port's copy of grove_tpu/orchestrator/rollout.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

import random
import zlib

from grove_tpu_torch.api import naming
from grove_tpu_torch.api.podgang import NamespacedName
from grove_tpu_torch.orchestrator import expansion as exp
from grove_tpu_torch.utils.backoff import Backoff

__all__ = ["advance_make_before_break"]


def _stale_pods_of(ctl, pcs, replica: int, desired_hash) -> list:
    """The replica's active pods still on the old template hash."""
    c = ctl.cluster
    out = []
    for clique in c.cliques_of_pcs_replica(pcs.metadata.name, replica):
        want = desired_hash(clique)
        out.extend(
            p
            for p in c.pods_of_clique(clique.metadata.name)
            if p.is_active and p.pod_template_hash != want
        )
    return out


def _synthetic_plan_inputs(ctl, pcs, replica: int, stale: list, desired_hash):
    """Build the shadow generation: one synthetic pod per stale pod, carrying
    the NEW template's requests/labels, plus one synthetic sub-gang per
    affected PodGang. Returns (subs, merged_pods, gang_map) — gang_map is
    gang name -> {synthetic pod name: (clique fqn, pod index)} — or None when
    some affected clique has no gang yet (nothing to plan against)."""
    c = ctl.cluster
    st = pcs.status
    by_clique: dict[str, list] = {}
    for pod in stale:
        by_clique.setdefault(pod.pclq_fqn, []).append(pod)
    merged_pods = dict(c.pods)
    gang_refs: dict[str, dict[str, list]] = {}  # gang -> group -> refs
    gang_map: dict[str, dict[str, tuple]] = {}
    for fqn, pods in sorted(by_clique.items()):
        clique = c.podcliques.get(fqn)
        if clique is None or clique.pod_gang_name not in c.podgangs:
            return None
        clique_tmpl = pcs.clique_template(clique.template_name)
        svc = naming.headless_service_name(pcs.metadata.name, replica)
        gang = c.podgangs[clique.pod_gang_name]
        # A throwaway RNG: synthetic pods are renamed deterministically below
        # and must not perturb the controller's name stream.
        built = exp._build_pods(
            pcs,
            clique,
            clique_tmpl,
            svc,
            replica,
            st.updated_generation_hash,
            random.Random(0),
            tmpl_hash=desired_hash(clique),
            pcsg_fqn=clique.pcsg_name,
            pcsg_replica=clique.pcsg_replica_index,
            base_podgang_name=gang.base_podgang_name,
            initc_server_url=ctl.initc_server_url,
            initc_mode=ctl.initc_mode,
        )
        by_idx = {p.pod_index: p for p in built}
        refs = gang_refs.setdefault(gang.name, {}).setdefault(fqn, [])
        for pod in sorted(pods, key=lambda p: p.pod_index):
            synth = by_idx.get(pod.pod_index)
            if synth is None:
                return None  # template shrank under the update; seed path
            synth.name = f"{fqn}-mbb-{pod.pod_index}"
            synth.pod_index = pod.pod_index
            synth.spec.hostname = naming.pod_hostname(fqn, pod.pod_index)
            merged_pods[synth.name] = synth
            refs.append(NamespacedName(pcs.metadata.namespace, synth.name))
            gang_map.setdefault(gang.name, {})[synth.name] = (fqn, pod.pod_index)
    from grove_tpu_torch.solver.planner import build_pending_subgang

    subs = []
    for gang_name in sorted(gang_refs):
        gang = c.podgangs[gang_name]
        sub = build_pending_subgang(gang, gang_refs[gang_name], {})
        if sub is None:
            return None
        # The shadow gang must land WHOLE or not at all — lift every group
        # floor to its full reference count so the solver cannot admit a
        # partial generation — and drop the base-gang dependency: the base
        # is already running, which is what the dependency encodes.
        for grp in sub.spec.pod_groups:
            grp.min_replicas = len(grp.pod_references)
        sub.base_podgang_name = None
        subs.append(sub)
    return subs, merged_pods, gang_map


def _plan_fits(ctl, nodes, subs, merged_pods, gang_map):
    """plan_rescue verdict over `nodes`: (fits, plan). Fits means EVERY
    synthetic pod of EVERY affected gang got a target."""
    from grove_tpu_torch.solver.defrag import plan_rescue

    plan = plan_rescue(
        nodes,
        ctl.topology,
        subs,
        merged_pods,
        params=ctl.solver_params,
        warm=ctl.warm,
        pruning=ctl.pruning,
        hold_usage=True,
        device=ctl.device,
    )
    planned = {mv.gang: mv.bindings for mv in plan}
    fits = all(
        set(planned.get(gang_name, {})) >= set(synths)
        for gang_name, synths in gang_map.items()
    )
    return fits, planned


def _whatif_pricing(ctl, pcs, replica, subs, merged_pods, gang_map, desired_hash, now):
    """Price the two unpark scenarios for a parked replica and journal both:
    "+surge racks" (clone_racks through the trace what-if engine) and "next
    candidate replica" (does the following replica in update order fit on
    today's fleet?)."""
    from grove_tpu_torch.trace.whatif import clone_racks

    c = ctl.cluster
    counts = ctl.rollout_counts
    nodes = list(c.nodes.values())
    surge_fits = False
    if ctl.rollout_surge_racks > 0:
        try:
            surged = clone_racks(
                nodes, ctl.topology, ctl.rollout_surge_racks, tag="surge"
            )
            surge_fits, _ = _plan_fits(ctl, surged, subs, merged_pods, gang_map)
        except ValueError:
            surge_fits = False  # no non-host level to clone a rack in
        counts["whatifs"] += 1
        ctl._journal_action(
            now,
            "rollout.whatif",
            pcs.metadata.name,
            scenario="surge-racks",
            replica=replica,
            surgeRacks=ctl.rollout_surge_racks,
            fits=surge_fits,
        )
    prog = pcs.status.rolling_update_progress
    next_replica = next(
        (
            i
            for i in range(pcs.spec.replicas)
            if i != replica and i not in prog.updated_replica_indices
        ),
        None,
    )
    next_fits = False
    if next_replica is not None:
        next_stale = _stale_pods_of(ctl, pcs, next_replica, desired_hash)
        built = (
            _synthetic_plan_inputs(ctl, pcs, next_replica, next_stale, desired_hash)
            if next_stale
            else None
        )
        if built is not None:
            n_subs, n_pods, n_map = built
            next_fits, _ = _plan_fits(ctl, nodes, n_subs, n_pods, n_map)
        counts["whatifs"] += 1
        ctl._journal_action(
            now,
            "rollout.whatif",
            pcs.metadata.name,
            scenario="next-replica",
            replica=replica,
            nextReplica=next_replica,
            fits=next_fits,
        )
    return {"surgeFits": surge_fits, "nextReplica": next_replica, "nextFits": next_fits}


def _defer(ctl, pcs, replica: int, reason: str, pricing: dict | None, now) -> bool:
    """Park the replica whole on the decorrelated-jitter backoff. True =
    still parked (caller returns, seed path untouched); False = the deadline
    is spent — the caller falls through to delete-then-recreate."""
    key = (pcs.metadata.name, replica)
    counts = ctl.rollout_counts
    ep = ctl._rollout_backoff.get(key)
    if ep is None:
        cell = {"now": now}
        ep = ctl._rollout_backoff[key] = {
            "backoff": Backoff(
                ctl.rollout_backoff_base_seconds,
                ctl.rollout_backoff_cap_seconds,
                deadline_s=now + ctl.rollout_deadline_seconds,
                seed=zlib.crc32(f"{key[0]}:{replica}".encode()),
                clock=lambda: cell["now"],
            ),
            "cell": cell,
            "retry_at": now,
        }
    ep["cell"]["now"] = now
    delay = ep["backoff"].next_delay()
    if delay is None:
        # Deadline spent: the seed path always makes progress. One journal
        # record marks the strategy downgrade for this replica.
        counts["fallbacks"] += 1
        del ctl._rollout_backoff[key]
        ctl._journal_action(
            now,
            "rollout.fallback",
            pcs.metadata.name,
            replica=replica,
            reason=reason,
            retries=ep["backoff"].attempts,
        )
        ctl.cluster.record_event(
            now,
            pcs.metadata.name,
            f"rolling update replica {replica}: make-before-break deadline "
            f"spent ({reason}); falling back to delete-then-recreate",
        )
        return False
    ep["retry_at"] = now + delay
    counts["retries"] += 1
    counts["deferred_budget" if reason == "budget" else "deferred_capacity"] += 1
    fields = {"replica": replica, "reason": reason, "retryAt": round(ep["retry_at"], 6)}
    if pricing:
        fields.update(pricing)
    ctl._journal_action(now, "rollout.deferred", pcs.metadata.name, **fields)
    ctl.rollout_last[pcs.metadata.name] = {
        "at": now,
        "replica": replica,
        "decision": "deferred",
        **fields,
    }
    return True


def advance_make_before_break(ctl, pcs, replica: int, stale: list, desired_hash, now) -> bool:
    """Advance the current replica make-before-break. True = handled this
    pass (cut over, settling, or deferred whole); False = backoff deadline
    spent or the replica has no gang to plan — the caller runs the seed
    delete-then-recreate path."""
    c = ctl.cluster
    key = (pcs.metadata.name, replica)
    counts = ctl.rollout_counts
    if key in ctl._rollout_replacing:
        return True  # previous cutover still settling; replica_updated gates
    ep = ctl._rollout_backoff.get(key)
    if ep is not None and now < ep["retry_at"]:
        return True  # parked; the backoff decides when to look again
    built = _synthetic_plan_inputs(ctl, pcs, replica, stale, desired_hash)
    if built is None:
        return False  # no gang / template mismatch: nothing to plan against
    subs, merged_pods, gang_map = built
    budget = (
        ctl.defrag_max_concurrent
        - len(ctl._defrag_migrating)
        - len(ctl._reclaim_evicting)
        - len(ctl._rollout_replacing)
    )
    if budget <= 0:
        return _defer(ctl, pcs, replica, "budget", None, now)
    nodes = list(c.nodes.values())
    counts["planned"] += 1
    fits, planned = _plan_fits(ctl, nodes, subs, merged_pods, gang_map)
    if not fits:
        pricing = _whatif_pricing(
            ctl, pcs, replica, subs, merged_pods, gang_map, desired_hash, now
        )
        return _defer(ctl, pcs, replica, "capacity", pricing, now)
    # CUTOVER: the whole replica's free-capacity plan is in hand and the old
    # placement still holds. Drain the stale pods, recreate on the new
    # generation at the SAME indices, and commit each gang's bindings
    # atomically — _bind_gang re-validates targets (a revocation notice that
    # landed mid-plan requeues the gang instead of binding into doomed
    # capacity) and rolls back all-or-nothing on commit failure; either way
    # the replacements are never double-bound, they just re-solve gated.
    affected = sorted({fqn for synths in gang_map.values() for fqn, _ in synths.values()})
    for pod in stale:
        ctl._release_pod(pod, now, reason="rolling-update")
    for fqn in affected:
        clique = c.podcliques.get(fqn)
        if clique is not None:
            ctl._sync_clique_pods(pcs, clique, pcs.status.updated_generation_hash, now)
    pods_bound = 0
    for gang_name in sorted(gang_map):
        synths = gang_map[gang_name]
        target_by_slot = {
            synths[sname]: node for sname, node in planned[gang_name].items()
        }
        real_bindings = {}
        for fqn in {f for f, _ in synths.values()}:
            clique = c.podcliques.get(fqn)
            want = desired_hash(clique) if clique is not None else None
            for p in c.pods_of_clique(fqn):
                slot = (fqn, p.pod_index)
                if p.is_active and p.pod_template_hash == want and slot in target_by_slot:
                    real_bindings[p.name] = target_by_slot[slot]
        if real_bindings and ctl._bind_gang(gang_name, real_bindings, now):
            pods_bound += len(real_bindings)
        else:
            # Requeued or rolled back: the fresh pods stay GATED and flow
            # through the normal solve — no partial bind survives.
            counts["replans"] += 1
            ctl._journal_action(
                now, "rollout.replan", gang_name, replica=replica
            )
    ctl._rollout_replacing[key] = now
    ctl._rollout_backoff.pop(key, None)
    counts["cutovers"] += 1
    ctl._journal_action(
        now,
        "rollout.cutover",
        pcs.metadata.name,
        replica=replica,
        gangs=sorted(gang_map),
        podsBound=pods_bound,
        podsDrained=len(stale),
    )
    c.record_event(
        now,
        pcs.metadata.name,
        f"rolling update replica {replica}: make-before-break cutover "
        f"({pods_bound} pods pre-bound, {len(stale)} drained)",
    )
    ctl.rollout_last[pcs.metadata.name] = {
        "at": now,
        "replica": replica,
        "decision": "cutover",
        "podsBound": pods_bound,
    }
    return True
