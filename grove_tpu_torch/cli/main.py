"""`python -m grove_tpu_torch.cli` — the kubectl-plugin analog
(grove_tpu/cli/main.py counterpart).

Talks to a running manager (`python -m grove_tpu_torch.runtime`) over its
object API via the typed client. Commands:

  get pcs|pclq|pcsg|podgangs|pods|nodes|services|hpas|queues|topology|solver|defrag|quality|resilience|tenancy|rollout   table listing
  get <kind> <name>                             full object as JSON
  describe <kind> <name>                        human detail + object events
  apply -f <file.yaml>                          admit a PodCliqueSet
  delete pcs <name>                             cascade-delete
  top                                           per-node requested/capacity
  scale <fqn> --replicas N                      kubectl-scale analog
  validate -f <file.yaml>                       dry-run admission check
  events [--tail N]                             recent control-plane events
  trace info|replay|whatif [--path DIR]         flight-recorder journal tools
  tune sweep [--path DIR] [--k N]               offline config tuning from traces

`trace` and `tune` operate on the journal directory on local disk (the
recorder's trace.path — run them on the operator host or a copied journal),
not over the HTTP API: replay re-solves every journaled wave, which needs
the solver, not the server. `trace replay` exits 1 on any divergence (a
solver-nondeterminism regression); `trace whatif --add-racks N` scores the
recorded window against a counterfactual fleet, and repeated `--variant`
flags score N solver-config overrides in ONE batched replay pass. `tune
sweep` replays the journal once under a K-config grid (successive halving)
and emits a validated recommended config (exit 1 when validation fails).
The verbs that solve (`trace replay`, `trace whatif`, `tune sweep`) run on
the card; `--device cpu` runs them on the plain PyTorch versions, and
without a card and without it they fail (exit 1, "no CUDA device").

Exit codes: 0 ok, 1 API/transport error, 2 usage error (cli.go:35-45 shape).
"""

from __future__ import annotations

import argparse
import json
import sys

from grove_tpu_torch.client.typed import GroveApiError, GroveClient
from grove_tpu_torch.utils import serde

KIND_ALIASES = {
    "pcs": "podcliquesets",
    "podcliqueset": "podcliquesets",
    "podcliquesets": "podcliquesets",
    "pclq": "podcliques",
    "podclique": "podcliques",
    "podcliques": "podcliques",
    "pcsg": "podcliquescalinggroups",
    "podcliquescalinggroup": "podcliquescalinggroups",
    "podcliquescalinggroups": "podcliquescalinggroups",
    "pg": "podgangs",
    "podgang": "podgangs",
    "podgangs": "podgangs",
    "pod": "pods",
    "pods": "pods",
    "node": "nodes",
    "nodes": "nodes",
    "svc": "services",
    "service": "services",
    "services": "services",
    "hpa": "hpas",
    "hpas": "hpas",
    "queue": "queues",
    "queues": "queues",
    "ct": "topology",
    "topology": "topology",
    "clustertopology": "topology",
    "clustertopologies": "topology",
    "solver": "solver",
    "defrag": "defrag",
    "quality": "quality",
    "resilience": "resilience",
    "tenancy": "tenancy",
    "cell": "cells",
    "cells": "cells",
    "rollout": "rollout",
    "rollouts": "rollout",
}


def _table(rows: list[list[str]], headers: list[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [headers, *rows]) for i in range(len(headers))
    ]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*headers)]
    out.extend(fmt.format(*(str(c) for c in row)) for row in rows)
    return "\n".join(out)


def _get_table(client: GroveClient, kind: str) -> str:
    # Tables use the bulk listing (?full=1): one round trip and one
    # consistent snapshot — per-name gets would be N+1 requests at cluster
    # scale and racy against reconcile-loop churn.
    if kind == "podcliquesets":
        rows = [
            [name, obj.spec.replicas, getattr(obj.status, "available_replicas", "?")]
            for name, obj in client.list_podcliquesets_full().items()
        ]
        return _table(rows, ["NAME", "REPLICAS", "AVAILABLE"])
    if kind == "podcliques":
        rows = []
        for name, obj in client.list_podcliques_full().items():
            st = obj.status
            rows.append(
                [
                    name,
                    obj.spec.replicas,
                    st.ready_replicas,
                    st.scheduled_replicas,
                    st.schedule_gated_replicas,
                ]
            )
        return _table(rows, ["NAME", "REPLICAS", "READY", "SCHEDULED", "GATED"])
    if kind == "podcliquescalinggroups":
        rows = []
        for name, obj in client.list_scaling_groups_full().items():
            st = obj.status
            rows.append(
                [name, obj.spec.replicas, st.available_replicas, st.scheduled_replicas]
            )
        return _table(rows, ["NAME", "REPLICAS", "AVAILABLE", "SCHEDULED"])
    if kind == "podgangs":
        rows = []
        for name, obj in client.list_podgangs_full().items():
            phase = getattr(obj.status.phase, "value", obj.status.phase)
            score = obj.status.placement_score
            rows.append([name, phase, "-" if score is None else f"{score:.3f}"])
        return _table(rows, ["NAME", "PHASE", "SCORE"])
    if kind == "pods":
        rows = []
        for name, obj in client.list_pods_full().items():
            phase = getattr(obj.phase, "value", obj.phase)
            rows.append(
                [name, obj.node_name or "<none>", phase, "yes" if obj.ready else "no"]
            )
        return _table(rows, ["NAME", "NODE", "PHASE", "READY"])
    if kind == "nodes":
        rows = []
        for name, obj in client.list_nodes_full().items():
            cap = ",".join(f"{k}={v:g}" for k, v in sorted(obj.capacity.items()))
            rows.append([name, "yes" if obj.schedulable else "no", cap])
        return _table(rows, ["NAME", "SCHEDULABLE", "CAPACITY"])
    if kind == "topology":
        # kubectl get clustertopology analog: the effective level hierarchy
        # (config TAS levels + auto host level) from /statusz.
        rows = [
            [lvl.get("domain", "?"), lvl.get("nodeLabelKey", "?")]
            for lvl in client.statusz().get("topology", [])
        ]
        return _table(rows, ["DOMAIN", "NODELABELKEY"])
    if kind == "queues":
        docs = client.statusz().get("queues", {})

        def tree_path(name: str) -> tuple:
            # Root-first ancestry: sorting by it lists parents before their
            # children (depth bounded defensively — the server validates
            # acyclicity).
            out: list[str] = []
            cur: str | None = name
            for _ in range(len(docs) + 1):
                if cur is None:
                    break
                out.append(cur)
                cur = docs.get(cur, {}).get("parent")
            return tuple(reversed(out))

        rows = []
        for qname in sorted(docs, key=tree_path):
            doc = docs[qname]
            quota = ",".join(
                f"{r}={'unlimited' if q == -1 else q}"
                for r, q in sorted(doc.get("quota", {}).items())
            )
            limit = ",".join(
                f"{r}={'none' if v == -1 else v}"
                for r, v in sorted(doc.get("limit", {}).items())
            )
            used = ",".join(f"{r}={v:g}" for r, v in sorted(doc["used"].items()))
            rows.append(
                [
                    "  " * int(doc.get("depth", 0)) + qname,
                    doc.get("parent") or "-",
                    quota or "-",
                    limit or "-",
                    used or "-",
                ]
            )
        return _table(rows, ["NAME", "PARENT", "QUOTA", "LIMIT", "USED"])
    if kind == "solver":
        # Solver health at a glance: pass dispositions (damper
        # effectiveness), warm-path cache traffic, candidate-pruning
        # counters, the last drain's measured wave-harvest p50/p99, and the
        # streaming-drain config + last run (gangs/sec, bind p50/p99) —
        # all from /statusz.
        st = client.statusz()
        passes = st.get("solvePasses", {})
        rows = [
            ["solvePasses." + k, passes.get(k, 0)]
            for k in ("full", "delta", "skipped")
        ]
        rows += [
            ["warmPath." + k, v]
            for k, v in sorted(st.get("warmPath", {}).items())
        ]
        solver_doc = st.get("solver", {})
        rows += [
            ["pruning." + k, v if not isinstance(v, list) else ",".join(map(str, v))]
            for k, v in sorted(solver_doc.get("pruning", {}).items())
        ]
        rows += [
            ["mesh." + k, v]
            for k, v in sorted(solver_doc.get("mesh", {}).items())
        ]
        rows += [
            ["scan." + k, v]
            for k, v in sorted(solver_doc.get("scan", {}).items())
        ]
        # Host-stage timing: the serving path's per-pass encode/solve/decode
        # split, then the drain/stream ledgers (host* rows inside lastDrain/
        # lastStream carry the per-stage host seconds).
        rows += [
            ["hostStages." + k, v]
            for k, v in sorted(solver_doc.get("hostStages", {}).items())
        ]
        rows += [
            ["lastDrain." + k, v]
            for k, v in sorted(solver_doc.get("lastDrain", {}).items())
        ]
        rows += [
            ["streaming." + k, v]
            for k, v in sorted(solver_doc.get("streaming", {}).items())
        ]
        rows += [
            ["lastStream." + k, v]
            for k, v in sorted(solver_doc.get("lastStream", {}).items())
        ]
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "defrag":
        # Defrag loop at a glance: score vs threshold, in-flight migrations,
        # per-level stranded fractions, and the monotonic counters — all
        # from /statusz (the same doc the manager's metrics are cut from).
        doc = client.statusz().get("defrag", {})
        last = doc.get("last", {})
        counts = doc.get("counts", {})
        rows = [
            ["enabled", "yes" if doc.get("enabled") else "no"],
            ["score", f"{last.get('score', 0.0):.4f}" if last else "-"],
            ["threshold", doc.get("threshold", "-")],
            ["migrating", ",".join(doc.get("migrating", [])) or "-"],
        ]
        for entry in last.get("report", {}).get("levels", []):
            rows.append(
                [
                    f"stranded.{entry.get('level')}.{entry.get('resource')}",
                    f"{entry.get('stranded', 0.0):.4f}",
                ]
            )
        plan = last.get("plan")
        if plan:
            rows += [
                ["lastPlan.moves", plan.get("moves", 0)],
                ["lastPlan.podsMigrated", plan.get("podsMigrated", 0)],
                ["lastPlan.capacityRecovered", plan.get("capacityRecovered", 0)],
                ["lastPlan.efficiency", plan.get("efficiency", 0)],
                ["lastPlan.solveSeconds", plan.get("planSolveSeconds", 0)],
            ]
        rows += [[f"counts.{k}", v] for k, v in sorted(counts.items())]
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "rollout":
        # Fleet lifecycle at a glance: make-before-break rollout state
        # (replicas mid-replacement, last decision, monotonic counters) and
        # the revocable-capacity picture (pending notices with deadlines,
        # migrate/evict counters) — from /statusz (the grove_rollout_* and
        # grove_revocation_* metrics source doc).
        doc = client.statusz().get("rollout", {})
        last = doc.get("last", {})
        rows = [
            ["enabled", "yes" if doc.get("enabled") else "no"],
            ["surgeRacks", doc.get("surgeRacks", "-")],
            ["deadlineSeconds", doc.get("deadlineSeconds", "-")],
            ["replacing", ",".join(doc.get("replacing", [])) or "-"],
        ]
        for pcs_name, dec in sorted(last.items()):
            rows.append(
                [
                    f"last.{pcs_name}",
                    f"{dec.get('decision', '?')} replica {dec.get('replica', '?')} "
                    f"at t={dec.get('at', 0)}",
                ]
            )
        rows += [
            [f"counts.{k}", v] for k, v in sorted(doc.get("counts", {}).items())
        ]
        rev = doc.get("revocation", {})
        rows.append(
            ["revocation.evictionLeadSeconds", rev.get("evictionLeadSeconds", "-")]
        )
        for node, deadline in sorted(rev.get("pendingNodes", {}).items()):
            rows.append([f"revocation.pending.{node}", f"deadline t={deadline}"])
        rows += [
            [f"revocation.counts.{k}", v]
            for k, v in sorted(rev.get("counts", {}).items())
        ]
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "resilience":
        # Failure-domain state at a glance: ladder breaker states + step
        # counters, the bind-path hardening counters, injected-fault ledger,
        # watch reconnects, recorder counting-drops flag — from /statusz
        # (the same doc the grove_degradation_* metrics are cut from).
        doc = client.statusz().get("resilience", {})
        rows = [["enabled", "yes" if doc.get("enabled") else "no"]]
        ladder = doc.get("ladder", {})
        for sub, state in sorted(ladder.get("subsystems", {}).items()):
            rows.append(
                [
                    f"ladder.{sub}",
                    f"{state.get('state', '?')} "
                    f"(down {state.get('stepDowns', 0)}, "
                    f"up {state.get('stepUps', 0)})",
                ]
            )
        if ladder:
            rows += [
                ["ladder.waveFailures", ladder.get("waveFailures", 0)],
                ["ladder.waveSuccesses", ladder.get("waveSuccesses", 0)],
            ]
        rows += [
            [f"binds.{k}", v] for k, v in sorted(doc.get("binds", {}).items())
        ]
        rows += [
            [f"watch.{k}", v] for k, v in sorted(doc.get("watch", {}).items())
        ]
        rec = doc.get("recorder")
        if rec:
            rows += [
                ["recorder.degraded", "yes" if rec.get("degraded") else "no"],
                ["recorder.writeErrors", rec.get("writeErrors", 0)],
            ]
        fdoc = doc.get("faults")
        if fdoc:
            rows.append(["faults.seed", fdoc.get("seed", 0)])
            for site, s in sorted(fdoc.get("sites", {}).items()):
                rows.append(
                    [
                        f"faults.{site}",
                        f"{s.get('kind')} fired {s.get('fired', 0)}/"
                        f"{s.get('evaluated', 0)} evals",
                    ]
                )
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "tenancy":
        # Tenancy fairness at a glance: aging state, shared disruption
        # budget, per-tier bind latencies, and the busiest tenants' ledger
        # rows — from /statusz (the grove_tenancy_* metrics source doc).
        doc = client.statusz().get("tenancy", {})
        ledger = doc.get("ledger", {})
        budget = doc.get("disruptionBudget", {})
        rows = [
            ["enabled", "yes" if doc.get("enabled") else "no"],
            ["agingHalfLifeSeconds", doc.get("agingHalfLifeSeconds", "-")],
            ["agingMaxBoost", doc.get("agingMaxBoost", "-")],
            ["tenants", ledger.get("tenantCount", 0)],
            [
                "disruptionBudget",
                f"{budget.get('inFlight', 0)}/{budget.get('max', 0)} in flight",
            ],
            ["reclaimEvicting", ",".join(doc.get("reclaimEvicting", [])) or "-"],
            ["agedGangs", len(doc.get("aged", {}))],
        ]
        rows += [
            [f"totals.{k}", v]
            for k, v in sorted(ledger.get("totals", {}).items())
        ]
        for cls, tier in sorted(ledger.get("tiers", {}).items()):
            rows.append(
                [
                    f"tier.{cls}",
                    f"p50 {tier.get('p50BindSeconds', 0)}s "
                    f"p99 {tier.get('p99BindSeconds', 0)}s "
                    f"({tier.get('samples', 0)} binds)",
                ]
            )
        for tname, t in sorted(ledger.get("tenants", {}).items()):
            rows.append(
                [
                    f"tenant.{tname}",
                    f"admitted {t.get('admitted', 0)}/{t.get('submitted', 0)} "
                    f"(ratio {t.get('admittedRatio', 0)}, "
                    f"borrowed {t.get('borrowedShare', 0)}) "
                    f"preempted {t.get('preemptionsSuffered', 0)} "
                    f"reclaimed {t.get('reclaimsSuffered', 0)}",
                ]
            )
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "cells":
        # Cellular control plane at a glance: the partition plan (which
        # cell owns which root subtrees), per-cell lease holdership, and
        # each cell's journal path — from /statusz "cells" (the
        # grove_cell_* metrics source doc).
        doc = client.statusz().get("cells", {})
        if not doc.get("enabled"):
            return _table([["enabled", "no"]], ["METRIC", "VALUE"])
        rows = []
        for cname, c in sorted(doc.get("cells", {}).items()):
            rows.append(
                [
                    cname,
                    "held" if c.get("leaseHeld") else "lost",
                    ",".join(c.get("queues", [])) or "-",
                    ",".join(c.get("domains", [])) or "-",
                    c.get("journal", "-"),
                ]
            )
        return _table(rows, ["CELL", "LEASE", "QUEUES", "DOMAINS", "JOURNAL"])
    if kind == "quality":
        # Placement quality at a glance: the last solve wave's aggregate +
        # cumulative counters from /statusz (quality/report.py units; the
        # same doc the grove_placement_quality_* gauges are cut from).
        doc = client.statusz().get("quality", {})
        last = doc.get("last", {})
        counts = doc.get("counts", {})
        rows = [["last." + k, v] for k, v in sorted(last.items())]
        rows += [["counts." + k, v] for k, v in sorted(counts.items())]
        if not rows:
            rows = [["(no solve waves yet)", "-"]]
        return _table(rows, ["METRIC", "VALUE"])
    if kind == "services":
        return _table([[n] for n in client.list_services()], ["NAME"])
    if kind == "hpas":
        return _table([[n] for n in client.list_hpas()], ["NAME"])
    raise AssertionError(kind)


_DESCRIBE_KINDS = (
    "podcliquesets",
    "podcliques",
    "podcliquescalinggroups",
    "podgangs",
    "pods",
    "nodes",
)


def _fmt_conditions(conditions) -> list[str]:
    out = []
    for c in conditions:
        detail = ": ".join(p for p in (c.reason, c.message) if p)
        out.append(f"  {c.type}={c.status}" + (f" ({detail})" if detail else ""))
    return out


def _describe(client: GroveClient, kind: str, name: str) -> str:
    """kubectl-describe analog: key fields in human form, then the object's
    events (prefix match pulls in children — a PCS shows its gangs' events,
    matching how kubectl describe surfaces involved-object events)."""
    lines: list[str] = []
    if kind == "podcliquesets":
        obj = client.get_podcliqueset(name)
        st = obj.status
        lines += [
            f"Name:      {name}",
            f"Replicas:  {obj.spec.replicas} desired, {st.available_replicas} available, {st.updated_replicas} updated",
            f"Startup:   {getattr(obj.spec.template.startup_type, 'value', obj.spec.template.startup_type)}",
        ]
        if st.rolling_update_progress is not None:
            ru = st.rolling_update_progress
            lines.append(
                f"RollingUpdate: current={getattr(ru, 'current_replica_index', '?')}"
            )
        if st.pod_gang_statuses:
            lines.append("PodGangs:")
            lines += [
                f"  {g.name}  phase={g.phase}" for g in st.pod_gang_statuses
            ]
        if st.conditions:
            lines.append("Conditions:")
            lines += _fmt_conditions(st.conditions)
        if st.last_errors:
            lines.append("LastErrors:")
            lines += [f"  {e}" for e in st.last_errors]
    elif kind in ("podcliques", "podcliquescalinggroups"):
        # LIST-only collections on the API (by-name GET is the initc
        # readiness endpoint); describe reads the bulk listing.
        full = (
            client.list_podcliques_full()
            if kind == "podcliques"
            else client.list_scaling_groups_full()
        )
        obj = full.get(name)
        if obj is None:
            raise GroveApiError(404, [f"{kind[:-1]} {name!r} not found"])
        st = obj.status
        lines += [f"Name:      {name}"]
        if kind == "podcliques":
            lines += [
                f"Role:      {obj.spec.role_name}",
                f"Replicas:  {obj.spec.replicas} desired, {st.ready_replicas} ready, "
                f"{st.scheduled_replicas} scheduled, {st.schedule_gated_replicas} gated",
                f"MinAvail:  {obj.min_available}",
            ]
        else:
            lines += [
                f"Replicas:  {obj.spec.replicas} desired, {st.available_replicas} "
                f"available, {st.scheduled_replicas} scheduled",
                f"MinAvail:  {obj.spec.min_available}",
                f"Members:   {', '.join(obj.spec.clique_names)}",
            ]
        if st.selector:
            lines.append(f"Selector:  {st.selector}")
        if st.conditions:
            lines.append("Conditions:")
            lines += _fmt_conditions(st.conditions)
    elif kind == "podgangs":
        obj = client.get_podgang(name)
        st = obj.status
        lines += [
            f"Name:   {name}",
            f"Phase:  {getattr(st.phase, 'value', st.phase)}",
            f"Score:  {'-' if st.placement_score is None else f'{st.placement_score:.3f}'}",
        ]
        if obj.spec.priority_class_name:
            lines.append(f"PriorityClass: {obj.spec.priority_class_name}")
        lines.append("PodGroups:")
        lines += [
            f"  {g.name}  pods={len(g.pod_references)} minReplicas={g.min_replicas}"
            for g in obj.spec.pod_groups
        ]
        if st.conditions:
            lines.append("Conditions:")
            lines += _fmt_conditions(st.conditions)
    elif kind == "pods":
        obj = client.get_pod(name)
        lines += [
            f"Name:    {name}",
            f"Clique:  {obj.pclq_fqn}",
            f"PodGang: {obj.podgang_name}",
            f"Node:    {obj.node_name or '<none>'}",
            f"Phase:   {getattr(obj.phase, 'value', obj.phase)}",
            f"Ready:   {'yes' if obj.ready else 'no'}",
        ]
        if obj.scheduling_gates:
            lines.append(f"Gates:   {','.join(obj.scheduling_gates)}")
    elif kind == "nodes":
        obj = client.get_node(name)
        cap = " ".join(f"{k}={v:g}" for k, v in sorted(obj.capacity.items()))
        lines += [
            f"Name:        {name}",
            f"Schedulable: {'yes' if obj.schedulable else 'no'}",
            f"Capacity:    {cap}",
        ]
        if obj.labels:
            lines.append("Labels:")
            lines += [f"  {k}={v}" for k, v in sorted(obj.labels.items())]
    else:
        raise AssertionError(kind)  # main() gates on _DESCRIBE_KINDS
    # A PCS owns everything under its name prefix, so its describe pulls in
    # children's events (kubectl-describe involved-object behavior). Other
    # kinds match exactly — a podgang's prefix would also catch sibling
    # cliques of the same PCS replica.
    include = (
        (lambda o: o == name or o.startswith(name + "-"))
        if kind == "podcliquesets"
        else (lambda o: o == name)
    )
    matched = [
        (ts, obj_name, msg)
        for ts, obj_name, msg in client.events()
        if include(obj_name)
    ]
    lines.append("Events:" if matched else "Events:  <none>")
    lines += [f"  {ts:10.1f}  {obj_name:<30}  {msg}" for ts, obj_name, msg in matched]
    return "\n".join(lines)


def _trace_cmd(args) -> int:
    """`grove-tpu trace info|replay|whatif` — local journal tools. Solver
    imports are deferred: `info` must work on a machine without jax warmup
    cost, and errors map to the CLI exit-code contract (1 = journal/replay
    problem, incl. divergence)."""
    from grove_tpu_torch.trace.recorder import TraceSchemaError, read_journal

    try:
        records = read_journal(args.path)
    except (FileNotFoundError, TraceSchemaError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.verb == "info":
        from grove_tpu_torch.trace.recorder import journal_stats

        kinds: dict[str, int] = {}
        actions: dict[str, int] = {}
        times = []
        waves = 0
        admitted = 0
        rejections = 0
        for rec in records:
            kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
            if "now" in rec:
                times.append(rec["now"])
            if rec.get("kind") == "action":
                a = rec.get("action", "?")
                actions[a] = actions.get(a, 0) + 1
            elif rec.get("kind") == "wave":
                waves += 1
                admitted += sum(1 for v in rec.get("ok", {}).values() if v)
                rejections += len(rec.get("rejections", {}))
        jstats = journal_stats(args.path)
        rows = [["records", len(records)]]
        rows += [[f"records.{k}", v] for k, v in sorted(kinds.items())]
        rows += [
            ["waves", waves],
            ["gangsAdmitted", admitted],
            ["gangsRejected", rejections],
            # Writer-side drop counter recovered from the segments: > 0
            # means this journal is TRUNCATED (records lost under queue
            # pressure — grove_trace_dropped_total fired), not a quiet day.
            # Replay/sweep consumers need to know before trusting it.
            ["recorderDropped", jstats["dropped"]],
            ["recorderRecorded", jstats["recorded"]],
            # Counting-drops mode (ENOSPC survival): the writer dropped
            # whole SEGMENTS to failed disk writes. degraded=True means the
            # journal has a hole even if the queue never overflowed.
            ["recorderWriteErrors", jstats["writeErrors"]],
            ["degraded", jstats["degraded"]],
        ]
        if times:
            rows += [
                ["timeRange", f"{min(times):.1f} - {max(times):.1f}"],
            ]
        rows += [[f"actions.{k}", v] for k, v in sorted(actions.items())]
        # Segment manifest (manifest.json, written atomically beside the
        # segments): tail replay finds its resume point here without
        # scanning every segment file.
        from grove_tpu_torch.trace.recorder import read_manifest

        manifest = read_manifest(args.path)
        if manifest is not None:
            rows += [
                ["manifest.segments", len(manifest.get("segments", []))],
                ["manifest.waves", manifest.get("waves", 0)],
                ["manifest.lastWave", manifest.get("lastWave") or "-"],
                ["manifest.prunedSegments", manifest.get("prunedSegments", 0)],
                ["manifest.prunedWaves", manifest.get("prunedWaves", 0)],
            ]
            for seg in manifest.get("segments", []):
                wr = seg.get("waveRange")
                rows.append(
                    [
                        f"manifest.{seg.get('file', '?')}",
                        f"{seg.get('records', 0)} records, "
                        f"{seg.get('waves', 0)} waves"
                        + (f" ({wr[0]} .. {wr[1]})" if wr else ""),
                    ]
                )
        print(_table(rows, ["FIELD", "VALUE"]))
        if jstats["dropped"]:
            print(
                f"warning: recorder dropped {jstats['dropped']} record(s) — "
                "journal is truncated, replay/sweep may fail on missing "
                "fleets",
                file=sys.stderr,
            )
        if jstats["degraded"]:
            print(
                f"warning: recorder degraded — {jstats['writeErrors']} "
                "segment write(s) failed (ENOSPC/IO); the journal has holes",
                file=sys.stderr,
            )
        if manifest is not None and manifest.get("prunedSegments"):
            print(
                f"warning: rotation pruned {manifest['prunedSegments']} "
                f"segment(s) ({manifest.get('prunedWaves', 0)} wave(s)) — "
                "state rebuilt from this journal is incomplete",
                file=sys.stderr,
            )
        return 0

    if args.verb == "replay":
        from grove_tpu_torch.trace.replay import replay_journal

        try:
            report = replay_journal(records, device=args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        doc = report.to_doc()
        if args.json:
            print(json.dumps(doc, indent=2))
        else:
            rows = [
                ["waves", doc["waves"]],
                ["divergences", doc["divergences"]],
                ["recordedSolveSeconds", doc["recordedSolveSeconds"]],
                ["replayedSolveSeconds", doc["replayedSolveSeconds"]],
            ]
            print(_table(rows, ["FIELD", "VALUE"]))
            for w in doc["diverged"]:
                # The structured diff IS the evidence a nondeterminism
                # regression gets filed with — print it whole.
                print(json.dumps(w, indent=2))
        if doc["divergences"]:
            print(
                "replay DIVERGED: solver nondeterminism regression "
                f"({doc['divergences']} divergence(s))",
                file=sys.stderr,
            )
            return 1
        print("replay bit-identical: every recorded plan reproduced")
        return 0

    # whatif
    from grove_tpu_torch.trace.whatif import whatif_journal

    variants = [_parse_variant(v, i) for i, v in enumerate(args.variant or [])]
    # --variant implies a config-only what-if; --add-racks keeps its default
    # of 1 otherwise (the historical +1-rack counterfactual).
    add_racks = args.add_racks
    if add_racks is None:
        add_racks = 0 if variants else 1
    try:
        report = whatif_journal(
            records,
            add_rack_count=add_racks,
            portfolio=args.portfolio,
            variants=variants or None,
            device=args.device,
        )
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    doc = report.to_doc()
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    rows = [["waves", doc["waves"]]]
    if "variants" in doc:
        # Config-override sweep shape: incumbent row + per-variant deltas,
        # one batched replay pass (trace/whatif.whatif_configs).
        rows += [[f"recorded.{k}", v] for k, v in sorted(doc["recorded"].items())]
        for v in doc["variants"]:
            name = v["config"]["name"]
            rows += [
                [f"{name}.admitted", v["admitted"]],
                [f"{name}.admittedRatio", v["admittedRatio"]],
                [f"{name}.meanPlacementScore", v["meanPlacementScore"]],
                [f"{name}.delta.admitted", v["delta"]["admitted"]],
                [f"{name}.delta.admittedRatio", v["delta"]["admittedRatio"]],
            ]
        rows += [
            ["replayDivergences", doc["replayDivergences"]],
            ["solveSeconds", doc["solveSeconds"]],
        ]
        print(_table(rows, ["FIELD", "VALUE"]))
        if doc["replayDivergences"]:
            print(
                "warning: incumbent replay diverged from the journal "
                f"({doc['replayDivergences']} divergence(s)) — what-if "
                "deltas are measuring noise",
                file=sys.stderr,
            )
        return 0
    rows += [[f"edits.{k}", v] for k, v in sorted(doc["edits"].items()) if v]
    for side in ("recorded", "counterfactual"):
        rows += [[f"{side}.{k}", v] for k, v in sorted(doc[side].items())]
    rows += [[f"delta.{k}", v] for k, v in sorted(doc["delta"].items())]
    rows += [
        ["recordedSolveSeconds", doc["recordedSolveSeconds"]],
        ["counterfactualSolveSeconds", doc["counterfactualSolveSeconds"]],
    ]
    print(_table(rows, ["FIELD", "VALUE"]))
    return 0


_VARIANT_WEIGHT_KEYS = ("wTight", "wPref", "wReuse", "wReserve", "wSpread")


def _parse_variant(text: str, index: int) -> dict:
    """--variant 'wTight=2.0,escalatePortfolio=1,name=aggressive' -> the
    whatif_configs override spec."""
    spec: dict = {}
    weights: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"--variant[{index}]: {part!r} is not key=value"
            )
        key, val = part.split("=", 1)
        key = key.strip()
        if key in _VARIANT_WEIGHT_KEYS:
            weights[key] = float(val)
        elif key in ("portfolio", "escalatePortfolio"):
            spec[key] = int(val)
        elif key == "name":
            spec["name"] = val.strip()
        else:
            raise SystemExit(
                f"--variant[{index}]: unknown key {key!r} (weights "
                f"{'/'.join(_VARIANT_WEIGHT_KEYS)}, portfolio, "
                "escalatePortfolio, name)"
            )
    if weights:
        spec["weights"] = weights
    if not spec:
        raise SystemExit(f"--variant[{index}]: empty spec")
    return spec


def _tune_cmd(args) -> int:
    """`grove-tpu tune sweep` — batched config-sweep replay over a local
    journal: K candidate configs ride one replay pass (successive halving
    between trace chunks), and the winner is emitted as a recommended-config
    JSON only if it passes the bitwise-replay and exact-audit gates
    (exit 1 otherwise, like `trace replay` on divergence)."""
    from grove_tpu_torch.trace.recorder import (
        TraceSchemaError,
        journal_stats,
        read_journal,
    )

    try:
        records = read_journal(args.path)
    except (FileNotFoundError, TraceSchemaError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    jstats = journal_stats(args.path)
    if jstats["dropped"]:
        print(
            f"warning: recorder dropped {jstats['dropped']} record(s) — "
            "sweeping a truncated journal",
            file=sys.stderr,
        )

    from grove_tpu_torch.tuning import recommend

    try:
        doc = recommend(
            records,
            k=args.k,
            rungs=args.rungs,
            spread=args.spread,
            seed=args.seed,
            device=args.device,
        )
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    doc["journal"] = {"path": args.path, **jstats}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        rows = [
            ["waves", doc["sweep"]["waves"]],
            ["grid", doc["grid"]],
            ["winner", doc["winner"]["name"]],
            ["winner.admittedRatio", doc["winnerTally"]["admittedRatio"]],
            ["winner.meanPlacementScore", doc["winnerTally"]["meanPlacementScore"]],
            ["incumbent.admittedRatio", doc["incumbentTally"]["admittedRatio"]],
            ["incumbent.meanPlacementScore", doc["incumbentTally"]["meanPlacementScore"]],
            ["replayDivergences", doc["validation"]["journalReplayDivergences"]],
            ["bitwiseDivergences", doc["validation"]["bitwiseReplay"]["divergences"]],
            ["exactAudit.winner", doc["validation"]["exactAudit"]["winner"]["admittedRatio"]],
            ["exactAudit.incumbent", doc["validation"]["exactAudit"]["incumbent"]["admittedRatio"]],
            ["valid", doc["valid"]],
        ]
        for w in doc["winner"]["weights"]:
            rows.append([f"winner.weights.{w}", round(doc["winner"]["weights"][w], 4)])
        print(_table(rows, ["FIELD", "VALUE"]))
    if not doc["valid"]:
        print(
            "recommendation FAILED validation gates: "
            + ", ".join(doc.get("failedGates", [])),
            file=sys.stderr,
        )
        return 1
    print(
        f"recommended config {doc['winner']['name']!r} validated "
        "(bitwise replay + exact audit)"
    )
    return 0


def main(argv=None) -> int:
    from grove_tpu_torch.version import version_string

    parser = argparse.ArgumentParser(prog="grove-tpu")
    parser.add_argument(
        "--version", action="version", version=version_string("grove-tpu")
    )
    parser.add_argument("--server", default="http://127.0.0.1:2751")
    parser.add_argument("--token-file", default=None, help="bearer token file")
    parser.add_argument("--cafile", default=None, help="pinned serving cert (TLS)")
    parser.add_argument(
        "--device",
        default=None,
        help="where trace replay/whatif and tune sweep solve: the card "
        "(default) or 'cpu' (the plain PyTorch versions)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_get = sub.add_parser("get", help="list a kind, or fetch one object")
    p_get.add_argument("kind")
    p_get.add_argument("name", nargs="?", default=None)

    p_desc = sub.add_parser(
        "describe", help="human-readable object detail + its events"
    )
    p_desc.add_argument("kind")
    p_desc.add_argument("name")

    p_apply = sub.add_parser("apply", help="admit a PodCliqueSet")
    p_apply.add_argument("-f", "--filename", required=True)

    p_del = sub.add_parser("delete", help="cascade-delete a PodCliqueSet")
    p_del.add_argument("kind")
    p_del.add_argument("name")

    from grove_tpu_torch.api.constants import EVENTS_BUFFER

    def _tail(value: str) -> int:
        n = int(value)
        if not 0 <= n <= EVENTS_BUFFER:
            raise argparse.ArgumentTypeError(f"must be 0-{EVENTS_BUFFER}")
        return n

    sub.add_parser("top", help="per-node utilization from live bindings")

    p_val = sub.add_parser(
        "validate", help="dry-run admission check (defaulting + validation)"
    )
    p_val.add_argument("-f", "--filename", required=True)
    p_val.add_argument(
        "--config",
        default=None,
        help="operator config YAML; validates against ITS topology levels "
        "(omit for the default topology)",
    )

    p_scale = sub.add_parser(
        "scale", help="set a PodClique/PCSG scale subresource (kubectl scale)"
    )
    p_scale.add_argument("target", help="PodClique or PCSG FQN")
    p_scale.add_argument("--replicas", type=int, required=True)

    p_ev = sub.add_parser("events", help="recent control-plane events")
    # The server returns at most the last EVENTS_BUFFER events; larger
    # --tail values would silently truncate, so the parser rejects them.
    p_ev.add_argument(
        "--tail",
        type=_tail,
        default=20,
        help=f"lines to show (server keeps the last {EVENTS_BUFFER})",
        metavar="N",
    )

    from grove_tpu_torch.runtime.config import RUNTIME_STATE_DIR

    p_tr = sub.add_parser(
        "trace", help="flight-recorder journal tools (local journal dir)"
    )
    p_tr.add_argument("verb", choices=["info", "replay", "whatif"])
    p_tr.add_argument(
        "--path",
        default=RUNTIME_STATE_DIR + "/trace",
        help="journal directory (the operator's trace.path)",
    )
    p_tr.add_argument(
        "--add-racks",
        type=int,
        default=None,
        help="whatif: clone N racks of the recorded SKU into the fleet "
        "(default 1, or 0 when --variant is given)",
    )
    p_tr.add_argument(
        "--portfolio",
        type=int,
        default=None,
        help="whatif: override the recorded portfolio width",
    )
    p_tr.add_argument(
        "--variant",
        action="append",
        default=None,
        metavar="SPEC",
        help="whatif: config-override variant 'wTight=2.0,escalatePortfolio=1"
        ",name=x' (repeatable; all variants ride ONE batched replay pass)",
    )
    p_tr.add_argument(
        "--json", action="store_true", help="emit the full report as JSON"
    )

    p_tu = sub.add_parser(
        "tune",
        help="offline solver tuning from a local trace journal",
    )
    p_tu.add_argument("verb", choices=["sweep"])
    p_tu.add_argument(
        "--path",
        default=RUNTIME_STATE_DIR + "/trace",
        help="journal directory (the operator's trace.path)",
    )
    p_tu.add_argument(
        "--k", type=int, default=16, help="config-grid size (incumbent + K-1)"
    )
    p_tu.add_argument(
        "--rungs",
        type=int,
        default=3,
        help="successive-halving rungs over the trace (1 = no halving)",
    )
    p_tu.add_argument(
        "--spread",
        type=float,
        default=0.5,
        help="log-normal weight perturbation spread for the grid",
    )
    p_tu.add_argument(
        "--seed", type=int, default=0, help="grid generation seed"
    )
    p_tu.add_argument(
        "--out", default=None, help="write the recommended-config JSON here"
    )
    p_tu.add_argument(
        "--json", action="store_true", help="emit the full report as JSON"
    )

    args = parser.parse_args(argv)

    if args.cmd == "trace":
        return _trace_cmd(args)
    if args.cmd == "tune":
        return _tune_cmd(args)

    try:
        token = None
        if args.token_file:
            with open(args.token_file) as f:
                token = f.read().strip()
        client = GroveClient(args.server, cafile=args.cafile, token=token)
        if args.cmd == "get":
            kind = KIND_ALIASES.get(args.kind)
            if kind is None:
                print(f"unknown kind {args.kind!r}", file=sys.stderr)
                return 2
            if args.name is None:
                print(_get_table(client, kind))
            else:
                getter = {
                    "podcliquesets": client.get_podcliqueset,
                    "podgangs": client.get_podgang,
                    "pods": client.get_pod,
                    "nodes": client.get_node,
                }.get(kind)
                if getter is None:
                    print(f"get-by-name unsupported for {kind}", file=sys.stderr)
                    return 2
                print(json.dumps(serde.encode(getter(args.name)), indent=2))
        elif args.cmd == "describe":
            kind = KIND_ALIASES.get(args.kind)
            if kind not in _DESCRIBE_KINDS:
                print(
                    "describe supports: pcs, pclq, pcsg, podgangs, pods, nodes",
                    file=sys.stderr,
                )
                return 2
            print(_describe(client, kind, args.name))
        elif args.cmd == "apply":
            with open(args.filename) as f:
                name = client.apply_podcliqueset(f.read())
            print(f"podcliqueset/{name} applied")
        elif args.cmd == "delete":
            if KIND_ALIASES.get(args.kind) != "podcliquesets":
                print("delete supports: pcs", file=sys.stderr)
                return 2
            client.delete_podcliqueset(args.name)
            print(f"podcliqueset/{args.name} deleted")
        elif args.cmd == "top":
            # kubectl-top analog, computed client-side from two bulk
            # listings: requested = sum of active bound pods' requests.
            nodes = client.list_nodes_full()
            pods = client.list_pods_full()
            used: dict[str, dict[str, float]] = {}
            for pod in pods.values():
                if pod.node_name and pod.is_active:
                    acc = used.setdefault(pod.node_name, {})
                    for res, qty in pod.spec.total_requests().items():
                        acc[res] = acc.get(res, 0.0) + qty
            rows = []
            for name, node in nodes.items():
                cells = []
                for res in sorted(node.capacity):
                    cap = node.capacity[res]
                    req = used.get(name, {}).get(res, 0.0)
                    pct = f"{100.0 * req / cap:.0f}%" if cap else "-"
                    cells.append(f"{res}={req:g}/{cap:g}({pct})")
                rows.append([name, " ".join(cells)])
            print(_table(rows, ["NAME", "REQUESTED/CAPACITY"]))
        elif args.cmd == "validate":
            # kubectl --dry-run analog: the SAME AdmissionChain the server's
            # apply path runs (no hand-rolled pipeline copy that could
            # drift), against the operator config's topology when given.
            import yaml as _yaml

            from grove_tpu_torch.api import DEFAULT_CLUSTER_TOPOLOGY, PodCliqueSet
            from grove_tpu_torch.api import constants as api_constants
            from grove_tpu_torch.api.admission import AdmissionChain, AdmissionError

            topology = DEFAULT_CLUSTER_TOPOLOGY
            known_queues = None
            auto_slice = None  # config unknown: skip the feature cross-check
            slice_resource = api_constants.DEFAULT_SLICE_RESOURCE
            if args.config:
                from grove_tpu_torch.runtime.config import load_operator_config

                opcfg = load_operator_config(args.config)
                topology = opcfg.cluster_topology()
                # The server rejects unknown queues; the dry run must too
                # or validate would bless a file apply then bounces.
                known_queues = frozenset(opcfg.scheduling.queues)
                auto_slice = opcfg.network_acceleration.auto_slice_enabled
                slice_resource = opcfg.network_acceleration.slice_resource_name
            try:
                with open(args.filename) as f:
                    doc = _yaml.safe_load(f)
                pcs = AdmissionChain(
                    topology=topology,
                    known_queues=known_queues,
                    auto_slice_enabled=auto_slice,
                    slice_resource_name=slice_resource,
                ).admit_podcliqueset(PodCliqueSet.from_dict(doc))
            except AdmissionError as e:
                for err in e.errors:
                    print(f"invalid: {err}", file=sys.stderr)
                return 1
            except (
                _yaml.YAMLError,
                AttributeError,  # non-mapping top level (empty/scalar/list)
                KeyError,
                TypeError,
                ValueError,
            ) as e:
                print(f"invalid: {e}", file=sys.stderr)
                return 1
            print(f"podcliqueset/{pcs.metadata.name} valid")
        elif args.cmd == "scale":
            previous = client.scale(args.target, args.replicas)
            print(f"{args.target} scaled {previous} -> {args.replicas}")
        elif args.cmd == "events":
            tail = client.events()[-args.tail:] if args.tail > 0 else []
            for ts, obj, msg in tail:
                print(f"{ts:10.1f}  {obj:<30}  {msg}")
    except GroveApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # `grove-tpu get pods | head` closes stdout early — normal, not an
        # error. Detach stdout so interpreter shutdown doesn't re-raise.
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
