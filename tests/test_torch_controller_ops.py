"""The port's controller operations against the JAX controller's, store to
store after every simulator step (plain PyTorch versions, device="cpu";
`TwinScenario` in tests/test_torch_controller.py):

  - priority preemption (tests/test_disruption.py), with its cooldown;
  - quota reclaim under tenancy, evicting batch-preemptible first, and its
    deferral on the disruption budget; tenancy aging up the boost ladder
    (tests/test_tenancy.py);
  - defrag_tick's make-before-break migrations recovering a rack-packed gang
    (tests/test_defrag.py);
  - revocation: migrate with free capacity, evict inside the lead when the
    budget is spent, eviction in SLO order (tests/test_revocation.py);
  - the delete-and-recreate rolling update (RU7, RU8, RU10;
    tests/test_scenarios_ru.py);
  - the make-before-break rollout: cutover, whole deferral with what-if
    pricing and the deadline fallback (tests/test_rollout.py).

Each recorded run's port journal equals the JAX journal, seconds aside, and
replays on the port with 0 divergences.
"""

from __future__ import annotations

import copy

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
from scenario_harness import build_pcs, clique, e2e_nodes, wl1
from test_torch_controller import TwinScenario, normalize_journal

from grove_tpu.api import constants
from grove_tpu.api.types import TopologyDomain, get_condition
from grove_tpu.sim import workloads as r_wl
from grove_tpu.state import Node as RNode
from grove_tpu_torch.trace.replay import replay_journal as p_replay


def journals_agree(s) -> list[dict]:
    """Stop both recorders; the port's journal equals the JAX one (seconds
    aside) and replays on the port with 0 divergences. Returns it."""
    r_records, p_records = s.journals()
    assert normalize_journal(p_records) == normalize_journal(r_records)
    assert p_replay(p_records, device="cpu").divergence_count == 0
    return p_records


def actions(records, name):
    return [r for r in records if r.get("kind") == "action" and r.get("action") == name]


# ---- priority preemption -----------------------------------------------------------


def bench_nodes(hosts=4, cpu=4.0):
    return r_wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=1,
                                  hosts_per_rack=hosts, cpu=cpu, tpu=0.0)


def one_clique(name, replicas=4, cpu="2", priority=""):
    pcs = r_wl._pcs(name, cliques=[r_wl._clique("w", replicas, cpu)])
    if priority:
        pcs.spec.template.priority_class_name = priority
    return pcs


def test_priority_preemption_equals_jax(tmp_path):
    s = TwinScenario(0, nodes=bench_nodes(), topology=r_wl.bench_topology(),
                     priority_classes={"critical": 100, "batch": 0}, sim={})
    s.record(tmp_path)
    s.deploy(one_clique("low", cpu="4", priority="batch"))
    assert s.until(lambda: all(p.is_scheduled for p in s.cluster.pods.values()), 60)
    s.deploy(one_clique("high", cpu="4", priority="critical"))
    assert s.until(lambda: all(p.is_scheduled for p in s.scheduled("high")) and
                   len(s.scheduled("high")) == 4, 60)
    low = next(g for g in s.cluster.podgangs.values() if g.pcs_name == "low")
    cond = get_condition(low.status.conditions, constants.PODGANG_CONDITION_DISRUPTION_TARGET)
    assert cond is not None and cond.status == "True"
    s.settle(5)
    records = journals_agree(s)
    assert actions(records, "preemption")


def test_preemption_cooldown_equals_jax():
    """A contender whose rejection is not capacity-caused (more cpu than the
    fleet has) preempts at most once per cooldown window."""
    s = TwinScenario(0, nodes=bench_nodes(), topology=r_wl.bench_topology(),
                     priority_classes={"critical": 100}, sim={})
    s.deploy(one_clique("low", replicas=2, cpu="4"))
    assert s.until(lambda: len(s.scheduled("low")) == 2, 60)
    s.deploy(one_clique("impossible", replicas=8, cpu="4", priority="critical"))
    s.settle(10)
    assert not s.scheduled("impossible")
    assert len([e for e in s.cluster.events if "gang preempted" in e[2]]) <= 1


# ---- quota reclaim and tenancy aging -----------------------------------------------

RECLAIM_QUEUES = {
    "org": {"resources": {"cpu": {"quota": "0.26"}}},
    "qb": {"parentQueue": "org", "resources": {"cpu": {"quota": "0.01"}}},
    "qs": {"parentQueue": "org", "resources": {"cpu": {"quota": "0.01"}}},
    "qd": {"parentQueue": "org", "resources": {"cpu": {"quota": "0.13"}}},
}


def tenancy_nodes(n=8):
    return [
        RNode(name=f"n{i}", capacity={"cpu": 64.0, "memory": 256 * 2**30},
              labels={"topology.kubernetes.io/zone": "z0",
                      "topology.kubernetes.io/block": "b0",
                      "topology.kubernetes.io/rack": f"r{i % 2}"})
        for i in range(n)
    ]


def workload(simple1, name, queue=None, slo=None):
    pcs = copy.deepcopy(simple1)
    pcs.metadata.name = name
    if queue:
        pcs.metadata.annotations[constants.ANNOTATION_QUEUE] = queue
    if slo:
        pcs.spec.template.slo_class = slo
    return pcs


def bound(s, prefix):
    return [p for p in s.scheduled() if p.pclq_fqn.startswith(prefix + "-")]


@pytest.mark.parametrize("budget", [1, 2])
def test_quota_reclaim_equals_jax(simple1, budget, tmp_path):
    """Two borrowers fill org's headroom; an in-quota latency contender
    arrives. Budget 2: the batch-preemptible family is evicted and the
    contender lands. Budget 1: the two-gang family defers whole until the
    budget grows."""
    s = TwinScenario(0, nodes=tenancy_nodes(), queues=RECLAIM_QUEUES,
                     ctl={"tenancy_enabled": True, "defrag_max_concurrent": budget})
    s.record(tmp_path)
    s.deploy(workload(simple1, "batchw", queue="qb", slo="batch-preemptible"))
    s.settle(1)
    s.deploy(workload(simple1, "stdw", queue="qs", slo="standard"))
    s.settle(1)
    assert len(bound(s, "batchw")) == 13 and len(bound(s, "stdw")) == 13
    s.deploy(workload(simple1, "latw", queue="qd", slo="latency"))
    s.settle(4)
    if budget == 1:
        assert len(bound(s, "batchw")) == 13 and not bound(s, "latw")
        assert s.controller.tenancy_ledger.totals["reclaim_deferred"] >= 1
        s.controller.defrag_max_concurrent = 2
    assert s.until(lambda: len(bound(s, "latw")) == 13, 20)
    assert len(bound(s, "stdw")) == 13 and not bound(s, "batchw")
    assert s.controller.tenancy_ledger.totals["reclaims"] == 2
    s.settle(3)
    assert actions(journals_agree(s), "quota-reclaim")


def test_tenancy_aging_equals_jax(simple1, tmp_path):
    """A quota-starved gang climbs the aging ladder (half-life 5 s, cap 3)
    on both controllers at the same ticks, journaled alike."""
    s = TwinScenario(0, nodes=tenancy_nodes(), queues={"team": {"cpu": "1m"}},
                     ctl={"tenancy_enabled": True, "tenancy_aging_half_life_seconds": 5.0,
                          "tenancy_aging_max_boost": 3})
    s.record(tmp_path)
    s.deploy(workload(simple1, "w", queue="team"))
    s.settle(45)
    gangs = list(s.cluster.podgangs)
    assert gangs and all(s.controller._aging_boost.get(g, 0) == 3 for g in gangs)
    assert s.controller.tenancy_ledger.totals["aging_boosts"] == 3 * len(gangs)
    assert actions(journals_agree(s), "tenancy.aging")


# ---- defrag -------------------------------------------------------------------------


def test_defrag_tick_migrations_equal_jax(tmp_path):
    """tests/test_defrag.py's chaos case: one 2-pod squatter per rack (racks
    of 4 one-pod nodes), a rack-packed 4-pod gang that fits nowhere, then
    defrag on: make-before-break migrations under a budget of 2 until the
    big gang is Ready."""
    nodes = e2e_nodes(16, hosts_per_rack=4, racks_per_block=2, blocks_per_zone=2)
    s = TwinScenario(0, nodes=nodes)
    s.record(tmp_path)
    for r in range(4):
        for i, n in enumerate(nodes):
            s.set_schedulable(n.name, i // 4 == r)
        s.deploy(build_pcs(f"sq{r}", cliques=[clique("w", 2, 2)]))
        assert s.until_ready(2 * (r + 1))
    for n in nodes:
        s.set_schedulable(n.name, True)
    s.settle(2)
    s.deploy(build_pcs("big", cliques=[clique("b", 4, 4, pack="rack")]))
    s.settle(5)
    assert not s.scheduled("big")
    s.controller.defrag_enabled = True
    s.controller.defrag_threshold = 0.2
    s.controller.defrag_interval_seconds = 2.0
    s.controller.defrag_max_concurrent = 2
    s.controller.defrag_cooldown_seconds = 30.0
    assert s.until(lambda: len(s.ready("big")) == 4, 60)
    assert len(s.domain_of_pods("big", TopologyDomain.RACK)) == 1
    counts = s.controller.defrag_counts
    assert counts["plans"] >= 1 and counts["migrations"] >= 1
    assert normalize_journal([s.port.controller.defrag_last]) == \
        normalize_journal([s.ref.controller.defrag_last])
    s.settle(3)
    assert actions(journals_agree(s), "defrag-migration")


# ---- revocation ---------------------------------------------------------------------


def test_revocation_migrates_with_free_capacity(tmp_path):
    s = TwinScenario(20)
    s.record(tmp_path)
    s.deploy(wl1())
    assert s.until_ready(10)
    victim = sorted({p.node_name for p in s.scheduled()})[0]
    s.sim.revoke_node(victim)
    assert s.until(lambda: not any(p.node_name == victim for p in s.scheduled()), 25)
    rc = s.controller.revocation_counts
    assert rc["notices"] == 1 and rc["migrated"] >= 1 and rc["evicted"] == 0
    assert s.until_ready(10, timeout=60)
    s.settle(35)  # past the deadline: the node dies empty
    assert actions(journals_agree(s), "revocation.migrated")


def test_revocation_evicts_inside_the_lead_when_the_budget_is_spent(tmp_path):
    s = TwinScenario(20)
    s.record(tmp_path)
    s.deploy(wl1())
    assert s.until_ready(10)
    s.controller.defrag_max_concurrent = 0
    victim = sorted({p.node_name for p in s.scheduled()})[0]
    s.sim.revoke_node(victim)
    assert s.until(lambda: s.controller.revocation_counts["evicted"] >= 1, 35)
    assert s.controller.revocation_counts["migration_deferred"] >= 1
    assert s.until_ready(10, timeout=120)
    assert actions(journals_agree(s), "revocation.evicted")


def test_revocation_eviction_order_equals_jax(tmp_path):
    s = TwinScenario(0, nodes=bench_nodes(hosts=1), topology=r_wl.bench_topology(), sim={})
    s.record(tmp_path)
    lat = r_wl._pcs("lat", cliques=[r_wl._clique("w", 1, "2")])
    lat.spec.template.slo_class = constants.SLO_CLASS_LATENCY
    bat = r_wl._pcs("bat", cliques=[r_wl._clique("w", 1, "2")])
    bat.spec.template.slo_class = constants.SLO_CLASS_BATCH
    s.deploy(lat)
    s.deploy(bat)
    assert s.until(lambda: len(s.scheduled()) == 2, 60)
    s.sim.revoke_node(next(iter(s.cluster.nodes)))
    assert s.until(lambda: s.controller.revocation_counts["evicted"] >= 2, 35)
    evictions = actions(journals_agree(s), "revocation.evicted")
    assert [r["sloClass"] for r in evictions[:2]] == [constants.SLO_CLASS_BATCH,
                                                      constants.SLO_CLASS_LATENCY]


# ---- the delete-and-recreate rolling update ---------------------------------------


def update_ended(pcs) -> bool:
    prog = pcs.status.rolling_update_progress
    return prog is not None and prog.update_ended_at is not None


@pytest.mark.parametrize("case", ["ru7", "ru8", "ru10"])
def test_recreate_rolling_update_equals_jax(case, tmp_path):
    s = TwinScenario(10)
    s.record(tmp_path)
    pcs = s.deploy(wl1())
    assert s.until(lambda: len(s.ready()) == 10, 240)
    if case == "ru10":
        s.cordon_all()
    s.change_clique_spec(pcs, {"ru7": "pc-a", "ru8": "pc-b", "ru10": "pc-a"}[case])
    if case == "ru10":
        s.settle(5)
        assert len(s.pending_unscheduled()) == 1
        for name in list(s.cluster.nodes):
            s.sim.uncordon(name)
    assert s.until(lambda: update_ended(pcs), 300)
    assert update_ended(s.port_pcs(pcs))
    assert actions(journals_agree(s), "rolling-update-complete")


# ---- the make-before-break rollout --------------------------------------------------


def mbb(pcs):
    pcs.metadata.annotations[constants.ANNOTATION_ROLLOUT_STRATEGY] = (
        constants.ROLLOUT_STRATEGY_MAKE_BEFORE_BREAK)
    return pcs


def test_mbb_cutover_equals_jax(tmp_path):
    s = TwinScenario(20)
    s.record(tmp_path)
    pcs = s.deploy(mbb(wl1()))
    assert s.until_ready(10)
    s.change_clique_spec(pcs, "pc-a")
    assert s.until(lambda: update_ended(pcs), 120)
    assert s.until_ready(10, timeout=60)
    counts = s.controller.rollout_counts
    assert counts["cutovers"] >= 1 and counts["fallbacks"] == 0
    assert s.port.controller.rollout_status() == s.ref.controller.rollout_status()
    assert actions(journals_agree(s), "rollout.cutover")


def test_mbb_defers_whole_then_falls_back_equals_jax(tmp_path):
    s = TwinScenario(10, ctl={"rollout_deadline_seconds": 12.0})
    s.record(tmp_path)
    pcs = s.deploy(mbb(wl1()))
    assert s.until_ready(10)
    s.change_clique_spec(pcs, "pc-a")
    s.settle(6)
    counts = s.controller.rollout_counts
    assert counts["deferred_capacity"] >= 1 and counts["whatifs"] >= 1
    assert s.until(lambda: update_ended(pcs), 300)
    assert s.controller.rollout_counts["fallbacks"] >= 1
    records = journals_agree(s)
    assert actions(records, "rollout.whatif") and actions(records, "rollout.fallback")
