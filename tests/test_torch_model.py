"""The port's host model (grove_tpu_torch/api, orchestrator/expansion.py,
status.py, queues.py, tenancy/, solver/escalation.py, utils/backoff.py,
state/cluster.py) against the JAX package's, exactly:

  - the pod lifecycle: phase, deletion stamp, gates, readiness, crash loop
    and the `is_gated`/`is_active`/`is_scheduled` views;
  - the PodGang's namespace, queue and priority class, copied by
    `build_pending_subgang`, and its status and phase;
  - the revocation mask: a node with a pending notice is unschedulable in
    the snapshot, byte for byte as in JAX;
  - `expand_podcliqueset`'s DesiredState field by field (cliques, scaling
    groups, gangs, pods, services, HPAs, RBAC; a token's random value
    aside) for every examples/*.yaml and the sim/workloads builders, under
    the expansion options the controller passes;
  - the status rollups on fabricated stores, QueueTree parsing and
    charging, the tenancy helpers and ledger, the escalation damper and
    node digest, and the rollout backoff.
"""

from __future__ import annotations

import copy
import pathlib
import random

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest
import yaml
from test_torch_controller import TwinScenario, plain, to_port

import grove_tpu_torch.api as p_api
import grove_tpu_torch.api.pod as p_pod
import grove_tpu_torch.orchestrator.expansion as p_exp
import grove_tpu_torch.orchestrator.queues as p_queues
import grove_tpu_torch.orchestrator.status as p_status
import grove_tpu_torch.sim.workloads as p_wl
import grove_tpu_torch.solver.escalation as p_esc
import grove_tpu_torch.solver.planner as p_planner
import grove_tpu_torch.state.cluster as p_state
import grove_tpu_torch.tenancy as p_ten
import grove_tpu_torch.tenancy.slo as p_slo
import grove_tpu_torch.utils.backoff as p_backoff
from grove_tpu import api as r_api
from grove_tpu import tenancy as r_ten
from grove_tpu.api import pod as r_pod
from grove_tpu.orchestrator import expansion as r_exp
from grove_tpu.orchestrator import queues as r_queues
from grove_tpu.orchestrator import status as r_status
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import escalation as r_esc
from grove_tpu.solver import planner as r_planner
from grove_tpu.state import cluster as r_state
from grove_tpu.tenancy import slo as r_slo
from grove_tpu.utils import backoff as r_backoff
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("*.yaml")
                  if yaml.safe_load(p.read_text()).get("kind") == "PodCliqueSet")


# ---- repair 1: the pod lifecycle -----------------------------------------------------


def lifecycle_states(P):
    """The same pod in every lifecycle state, built by package P."""
    phase = P.PodPhase
    out = []
    for ph in phase:
        for node in (None, "n0"):
            for gates in ([], ["grove.io/podgang-pending-creation"]):
                for deleted in (None, 5.0):
                    out.append(P.Pod(name="p", pclq_fqn="c", podgang_name="g", phase=ph,
                                     node_name=node, scheduling_gates=list(gates),
                                     deletion_timestamp=deleted, ready=ph.value == "Running",
                                     crashlooping=deleted is not None, pod_index=3,
                                     spec=P.PodSpec(hostname="c-3", subdomain="svc")))
    return out


def test_pod_lifecycle_fields_and_views_equal_jax():
    ref, port = lifecycle_states(r_pod), lifecycle_states(p_pod)
    assert [plain(p) for p in port] == [plain(p) for p in ref]
    views = lambda ps: [(p.is_gated, p.is_active, p.is_scheduled, p.hostname) for p in ps]  # noqa: E731
    assert views(port) == views(ref)
    # A terminal or deleted pod no longer counts: is_active is not always True.
    assert sum(not p.is_active for p in port) == sum(not p.is_active for p in ref) > 0


# ---- repair 2: the PodGang's namespace, queue, priority class and status --------------


def test_pending_subgang_keeps_namespace_queue_and_priority_class():
    gangs = {}
    for name, api, exp, planner in (("jax", r_api, r_exp, r_planner),
                                    ("port", p_api, p_exp, p_planner)):
        doc = yaml.safe_load((REPO / "examples" / "simple1.yaml").read_text())
        doc["metadata"]["namespace"] = "team-a"
        doc["metadata"].setdefault("annotations", {})["grove.io/queue"] = "q1"
        doc["spec"]["template"]["priorityClassName"] = "critical"
        pcs = api.default_podcliqueset(api.PodCliqueSet.from_dict(doc))
        gang = exp.expand_podcliqueset(pcs, rng=random.Random(0)).podgangs[0]
        refs = {g.name: g.pod_references[:1] for g in gang.spec.pod_groups}
        gangs[name] = planner.build_pending_subgang(gang, refs, {})
    assert plain(gangs["port"]) == plain(gangs["jax"])
    sub = gangs["port"]
    assert (sub.namespace, sub.queue, sub.spec.priority_class_name) == \
        ("team-a", "q1", "critical")
    assert sub.status.phase == p_api.PodGangPhase.PENDING


# ---- repair 3: the revocation mask ----------------------------------------------------


@pytest.mark.parametrize("pad", [None, 16])
def test_snapshot_with_a_revocation_notice_equals_jax(pad):
    snaps = []
    for wl, state in ((r_wl, r_state), (p_wl, p_state)):
        nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=2,
                                     hosts_per_rack=3)
        nodes[4].revocable = True
        nodes[4].revocation_deadline = 30.0
        nodes[7].schedulable = False
        snaps.append(state.build_snapshot(nodes, wl.bench_topology(), pad_nodes_to=pad))
    ref, port = snaps
    assert not port.schedulable[4] and not port.schedulable[7] and port.schedulable[5]
    for name in ("capacity", "allocated", "schedulable", "node_domain_id"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


# ---- the DesiredState ------------------------------------------------------------------


def desired(api, exp, pcs_doc, **kw):
    pcs = api.default_podcliqueset(api.PodCliqueSet.from_dict(copy.deepcopy(pcs_doc)))
    topo = api.ClusterTopology(name="t", levels=[
        api.TopologyLevel(api.TopologyDomain(d), f"topology.kubernetes.io/{d}")
        for d in ("zone", "block", "rack")])
    return exp.expand_podcliqueset(pcs, topo, rng=random.Random(0), **kw)


EXPANSION_OPTIONS = {
    "default": {},
    "no-tas": {"tas_enabled": False},
    "slice": {"auto_slice_enabled": True, "slice_resource_name": "nvidia.com/gpu"},
    "kube-initc": {"initc_mode": "kubernetes", "initc_server_url": "https://op:9443"},
}


@pytest.mark.parametrize("option", sorted(EXPANSION_OPTIONS))
@pytest.mark.parametrize("example", EXAMPLES)
def test_desired_state_of_examples_equals_jax(example, option):
    doc = yaml.safe_load((REPO / "examples" / example).read_text())
    kw = EXPANSION_OPTIONS[option]
    ref, port = desired(r_api, r_exp, doc, **kw), desired(p_api, p_exp, doc, **kw)
    for field in ("podcliques", "scaling_groups", "podgangs", "pods", "services", "hpas",
                  "rbac"):
        assert plain(getattr(port, field)) == plain(getattr(ref, field)), field
    assert plain(port) == plain(ref)


def test_desired_state_under_replica_overrides_equals_jax():
    doc = yaml.safe_load((REPO / "examples" / "multi-node-disaggregated.yaml").read_text())
    ref0 = desired(r_api, r_exp, doc)
    overrides = {g.metadata.name: g.spec.replicas + 1 for g in ref0.scaling_groups}
    pclq = {c.metadata.name: c.spec.replicas + 2 for c in ref0.podcliques[:2]}
    kw = {"pcsg_replica_overrides": overrides, "pclq_replica_overrides": pclq}
    assert plain(desired(p_api, p_exp, doc, **kw)) == plain(desired(r_api, r_exp, doc, **kw))


BUILDERS = {
    "disagg": lambda wl: [wl.disagg_pcs("d0")],
    "aggregated": lambda wl: [wl.aggregated_pcs("a0")],
    "frontend": lambda wl: [wl.frontend_pcs("f0")],
    "synthetic": lambda wl: wl.synthetic_backlog(3, 2, 2),
    "contended": lambda wl: wl.contended_backlog(6),
    "mixed": lambda wl: wl.mixed_backlog(2, 2),
    "binpack": lambda wl: wl.binpack_trap_backlog(3),
    "fragmented": lambda wl: [*wl.fragmented_backlog(3)[0], wl.fragmented_backlog(3)[1]],
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_desired_state_of_workload_builders_equals_jax(builder):
    topo = {"jax": r_wl.bench_topology(), "port": p_wl.bench_topology()}
    out = {}
    for name, wl, exp in (("jax", r_wl, r_exp), ("port", p_wl, p_exp)):
        out[name] = [plain(exp.expand_podcliqueset(pcs, topo[name], rng=random.Random(7)))
                     for pcs in BUILDERS[builder](wl)]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("example", EXAMPLES)
def test_pod_template_and_generation_hashes_equal_jax(example):
    doc = yaml.safe_load((REPO / "examples" / example).read_text())
    r = r_api.default_podcliqueset(r_api.PodCliqueSet.from_dict(copy.deepcopy(doc)))
    p = p_api.default_podcliqueset(p_api.PodCliqueSet.from_dict(copy.deepcopy(doc)))
    assert p_exp.compute_generation_hash(p) == r_exp.compute_generation_hash(r)
    for rt, pt in zip(r.spec.template.cliques, p.spec.template.cliques):
        assert p_exp.compute_pod_template_hash(pt, "pc") == \
            r_exp.compute_pod_template_hash(rt, "pc")


# ---- status rollups on fabricated stores --------------------------------------------


def fabricate(s):
    """Mutate both stores alike into states a rollup must tell apart: a
    failed pod, a crash loop, a pod being deleted, an unready bound pod,
    an ungated unbound pod."""
    for side in (s.ref, s.port):
        pods = sorted(side.cluster.pods.values(), key=lambda p: p.name)
        phases = type(pods[0].phase)
        pods[0].phase = phases.FAILED
        pods[0].ready = False
        pods[1].crashlooping = True
        pods[1].ready = False
        pods[2].deletion_timestamp = 40.0
        pods[3].ready = False
        pods[4].node_name = None
        pods[4].scheduling_gates = []


@pytest.mark.parametrize("workload", ["wl1", "wl2"])
def test_status_rollups_on_fabricated_stores_equal_jax(workload):
    import scenario_harness as sh

    s = TwinScenario(12)
    s.deploy(getattr(sh, workload)())
    assert s.until_ready(10)
    fabricate(s)
    for now in (50.0, 51.0, 400.0, 20000.0):
        s.controller.update_statuses(now)  # both controllers, stores compared
    pairs = [(s.ref.cluster, r_status), (s.port.cluster, p_status)]
    rolled = []
    for cluster, status in pairs:
        row = [status.is_starting(p) for p in cluster.pods.values()]
        row += [status.clique_breached_since(c) for c in cluster.podcliques.values()]
        row += [status.pcsg_breached_since(g) for g in cluster.scaling_groups.values()]
        rolled.append(row)
    assert rolled[0] == rolled[1]
    assert plain(s.port.cluster.podcliquesets) == plain(s.ref.cluster.podcliquesets)


# ---- queues ---------------------------------------------------------------------------

QUEUE_CONFIGS = {
    "flat": {"a": {"cpu": "4", "memory": "8Gi"}, "b": {"cpu": -1}},
    "tree": {
        "org": {"resources": {"cpu": {"quota": "10", "limit": "12"}}},
        "t1": {"parentQueue": "org", "resources": {"cpu": {"quota": "4",
                                                            "overQuotaWeight": 2}}},
        "t2": {"parentQueue": "org", "resources": {"cpu": {"quota": "2"}}},
        "t3": {"parentQueue": "t1", "resources": {"cpu": {"quota": "1", "limit": "3"}}},
    },
    "bad": {"x": {"parentQueue": "nope"}, "y": {"resources": {"cpu": {"quota": "ten"}}},
            "z": {"cpu": "1", "resources": {}}},
}


@pytest.mark.parametrize("config", sorted(QUEUE_CONFIGS))
def test_queue_tree_parsing_and_charging_equal_jax(config):
    cfg = QUEUE_CONFIGS[config]
    r_err, p_err = [], []
    rt = r_queues.parse_queue_config(copy.deepcopy(cfg), r_err)
    pt = p_queues.parse_queue_config(copy.deepcopy(cfg), p_err)
    assert p_err == r_err
    if rt is None:
        assert pt is None and r_err
        return
    assert pt.describe() == rt.describe()
    names = sorted(rt.specs)
    assert [pt.depth(n) for n in names] == [rt.depth(n) for n in names]
    assert [pt.ancestors(n) for n in names] == [rt.ancestors(n) for n in names]
    assert (pt.roots(), pt.leaves()) == (rt.roots(), rt.leaves())
    rng = random.Random(3)
    usage = {n: {"cpu": rng.uniform(0, 3)} for n in names}
    r_usage = rt.hierarchical_usage(copy.deepcopy(usage))
    p_usage = pt.hierarchical_usage(copy.deepcopy(usage))
    assert p_usage == r_usage
    for i in range(40):
        q = rng.choice(names)
        demand = {"cpu": rng.choice([0.5, 1.0, 2.5, 6.0]), "memory": rng.choice([0.0, 2**30])}
        kw = rng.choice([{}, {"allow_borrow": False}, {"commit": False}])
        rv = rt.try_charge(r_usage, q, dict(demand), **kw)
        pv = pt.try_charge(p_usage, q, dict(demand), **kw)
        assert plain(pv) == plain(rv), (i, q, demand, kw)
        assert pt.borrow_weight(q, demand) == rt.borrow_weight(q, demand)
        assert p_usage == r_usage
    for root in rt.roots():
        assert pt.over_quota_queues(p_usage, root) == rt.over_quota_queues(r_usage, root)


# ---- tenancy --------------------------------------------------------------------------


def test_tenancy_helpers_equal_jax():
    classes = [None, "", "latency", "standard", "batch-preemptible", "bogus"]
    for fn in ("is_valid_slo_class", "normalized_slo_class", "slo_rank", "slo_borrow_eligible"):
        assert [getattr(p_slo, fn)(c) for c in classes] == [getattr(r_slo, fn)(c) for c in classes]
    keys = [(c, pr, f"g{pr}") for c in classes for pr in (0, 5, 100)]
    assert sorted(keys, key=lambda k: p_slo.revocation_victim_key(*k)) == \
        sorted(keys, key=lambda k: r_slo.revocation_victim_key(*k))
    grid = [(w, h, m) for w in (0.0, 4.9, 5.0, 14.0, 15.0, 35.0, 1e6) for h in (0.0, 5.0, 300.0)
            for m in (0, 3, 4)]
    assert [p_ten.aging_boost(*g) for g in grid] == [r_ten.aging_boost(*g) for g in grid]
    samples = [0.3, 1.0, 2.5, 0.1, 9.0]
    assert [p_ten.quantile(samples, q) for q in (0, 0.5, 0.99, 1)] == \
        [r_ten.quantile(samples, q) for q in (0, 0.5, 0.99, 1)]


def test_tenant_ledger_equals_jax():
    ledgers = [r_ten.TenantLedger(), p_ten.TenantLedger()]
    rng = random.Random(5)
    ops = []
    for _ in range(200):
        t = rng.choice(["qa", "qb", "(unqueued)"])
        op = rng.choice(["submitted", "admitted", "bound", "preemption", "reclaim", "aging",
                         "deferred"])
        ops.append((op, t, rng.choice(["latency", "standard", ""]), rng.uniform(0, 9),
                    rng.random() < 0.5))
    for led in ledgers:
        for op, t, slo, lat, flag in ops:
            {"submitted": lambda: led.note_submitted(t),
             "admitted": lambda: led.note_admitted(t, borrowed=flag),
             "bound": lambda: led.note_bound(t, slo, lat),
             "preemption": lambda: led.note_preemption(t, "qa"),
             "reclaim": lambda: led.note_reclaim(t, "qb"),
             "aging": lambda: led.note_aging(t),
             "deferred": led.note_reclaim_deferred}[op]()
    assert ledgers[1].snapshot() == ledgers[0].snapshot()
    assert ledgers[1].snapshot(top=2) == ledgers[0].snapshot(top=2)
    assert ledgers[1].tier_latencies() == ledgers[0].tier_latencies()


# ---- the escalation damper and the node digest ------------------------------------


def test_escalation_damper_and_node_digest_equal_jax():
    nodes = {}
    for name, wl in (("jax", r_wl), ("port", p_wl)):
        ns = wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2,
                                  hosts_per_rack=3)
        ns[1].schedulable = False
        ns[2].revocable = True
        ns[2].revocation_deadline = 12.0
        ns[3].taints = [{"key": "k", "value": "v", "effect": "NoSchedule"}]
        nodes[name] = ns
    assert p_esc.node_state_digest(nodes["port"]) == r_esc.node_state_digest(nodes["jax"])
    assert p_esc.escalation_fingerprint(["a", "b"], [("p", "n")], nodes["port"]) == \
        r_esc.escalation_fingerprint(["a", "b"], [("p", "n")], nodes["jax"])
    dampers = [r_esc.EscalationDamper(), p_esc.EscalationDamper()]
    rng = random.Random(9)
    for _ in range(100):
        key, fp = rng.choice([True, False]), rng.choice(["x", "y", "z"])
        esc, rej = rng.random() < 0.5, rng.random() < 0.5
        widths = [d.effective_width(key, fp, 1, 4) for d in dampers]
        assert widths[0] == widths[1]
        for d in dampers:
            d.record(key, fp, esc, rej)


def test_rollout_backoff_equals_jax():
    for seed in (0, 3, 17):
        clock = {"t": 0.0}
        out = []
        for mod in (r_backoff, p_backoff):
            clock["t"] = 0.0
            b = mod.Backoff(0.5, 30.0, deadline_s=40.0, seed=seed, clock=lambda: clock["t"])
            seq = []
            while (d := b.next_delay()) is not None:
                seq.append(d)
                clock["t"] += d
            out.append((seq, b.attempts))
        assert out[0] == out[1]


def test_release_binding_equals_jax():
    snaps = []
    for wl, state, api in ((r_wl, r_state, r_api), (p_wl, p_state, p_api)):
        nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=1,
                                     hosts_per_rack=2)
        pod = api.Pod(name="p", spec=api.PodSpec(containers=[api.Container(
            name="c", requests={"cpu": 3.0})]), node_name=nodes[0].name)
        snap = state.build_snapshot(nodes, wl.bench_topology(), bound_pods=[pod])
        state.release_binding(snap, pod)
        state.release_binding(snap, pod)  # clamped at 0
        snaps.append(snap.allocated)
    assert np.array_equal(snaps[0], snaps[1]) and not snaps[1].any()


def test_host_objects_round_trip_through_both_codecs():
    pcs = r_wl.disagg_pcs("rt")
    ds = r_exp.expand_podcliqueset(pcs, r_wl.bench_topology(), rng=random.Random(0))
    for obj in (pcs, *ds.podcliques, *ds.scaling_groups, *ds.podgangs, *ds.pods[:5]):
        assert plain(to_port(obj)) == plain(obj)
