"""The port's migration and rescue planners (grove_tpu_torch/solver/
defrag.py, solver/planner.py, sim/workloads.fragmented_backlog; plain
PyTorch versions, device="cpu") against the JAX package's:

  - largest_placeable, candidate_ladder and fragmented_backlog equal JAX's;
  - plan_migrations on the defrag bench's fragmented world (one squatter
    gang bound into every rack; 2 blocks x 4 racks x 8 hosts): the
    consolidating plan's moves, pods_migrated, capacity_recovered,
    binding_level and candidates_evaluated equal JAX's, the big gang is
    admitted after the moves and not before, and a second plan prepares
    no launch; None when nothing improves; the min_efficiency gate;
  - plan_rescue with two racks cordoned, hold_usage True and False, and a
    PCSG child gang whose base is absent from the batch: its moves equal
    JAX's, land on schedulable nodes only and leave no node over capacity;
  - build_pending_subgang, sort_pending and build_spread_avoid equal JAX's.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest

from grove_tpu.api.podgang import NamespacedName as RName
from grove_tpu.api.types import TopologyDomain as RDomain
from grove_tpu.orchestrator import expand_podcliqueset as r_expand
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import defrag as r_defrag
from grove_tpu.solver import planner as r_planner
from grove_tpu.solver.core import decode_assignments as r_decode
from grove_tpu.solver.core import solve as r_solve
from grove_tpu.solver.encode import encode_gangs as r_encode
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu.state.cluster import pod_request_vector as r_request
from grove_tpu_torch.api.podgang import NamespacedName as PName
from grove_tpu_torch.api.types import TopologyDomain as PDomain
from grove_tpu_torch.orchestrator import expand_podcliqueset as p_expand
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import defrag as p_defrag
from grove_tpu_torch.solver import planner as p_planner
from grove_tpu_torch.solver.core import decode_bindings as p_decode
from grove_tpu_torch.solver.core import solve as p_solve
from grove_tpu_torch.solver.encode import encode_gangs as p_encode
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from grove_tpu_torch.state import build_snapshot as p_snapshot
from grove_tpu_torch.state.cluster import pod_request_vector as p_request
from torch_jax_programs import _release_jax_programs  # noqa: F401

PKG = {
    "jax": dict(wl=r_wl, expand=r_expand, defrag=r_defrag, warm=RWarm, snap=r_snapshot,
                domain=RDomain, request=r_request, kw={}),
    "port": dict(wl=p_wl, expand=p_expand, defrag=p_defrag, warm=PWarm, snap=p_snapshot,
                 domain=PDomain, request=p_request, kw={"device": "cpu"}),
}
RESOURCES = ("cpu", "memory", "google.com/tpu")


@pytest.fixture(autouse=True, scope="module")
def _no_shared_xla_cache():
    """This module's JAX compiles stay out of the suite's persistent XLA
    cache (tests/conftest.py): a worker reading an entry another worker is
    writing in place can crash."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    cc.reset_cache()


def frag_world(pkg, blocks=2, racks_per_block=4, hosts=8, compact=False):
    """The defrag bench's world at a small size: squatter i bound into rack i
    (every squatter into rack 0 and 1 with `compact`)."""
    m = PKG[pkg]
    wl = m["wl"]
    topo = wl.bench_topology()
    nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=blocks,
                                 racks_per_block=racks_per_block, hosts_per_rack=hosts)
    racks = blocks * racks_per_block
    squat, big = wl.fragmented_backlog(racks, hosts_per_rack=hosts)
    rack_nodes: dict = {}
    for n in nodes:
        rack_nodes.setdefault((n.labels[wl.BLOCK_KEY], n.labels[wl.RACK_KEY]), []).append(n.name)
    rack_list = sorted(rack_nodes)
    gangs, pods = [], {}
    for i, pcs in enumerate(squat[:4] if compact else squat):
        ds = m["expand"](pcs, topo)
        gangs.extend(ds.podgangs)
        for j, pod in enumerate(ds.pods):
            rack, slot = (i // 4, 2 * (i % 4) + j) if compact else (i, j)
            pod.node_name = rack_nodes[rack_list[rack]][slot]
            pods[pod.name] = pod
    ds_big = m["expand"](big, topo)
    return topo, nodes, gangs, pods, ds_big, rack_nodes, rack_list


def moves_of(plan_or_moves) -> list:
    moves = plan_or_moves.moves if hasattr(plan_or_moves, "moves") else plan_or_moves
    return [(m.gang, m.bindings, m.pods_total) for m in moves]


PLAN_KEYS = ("pods_migrated", "capacity_recovered", "binding_level", "binding_resource",
             "candidates_evaluated", "gangs_considered", "score_before", "score_after",
             "efficiency")


def test_fragmented_backlog_equals_jax():
    for racks, hosts in ((4, 8), (3, 6)):
        out = {}
        for pkg, m in PKG.items():
            topo = m["wl"].bench_topology()
            squat, big = m["wl"].fragmented_backlog(racks, hosts_per_rack=hosts)
            docs = []
            for pcs in [*squat, big]:
                ds = m["expand"](pcs, topo)
                docs.append(([gang_doc(g) for g in ds.podgangs],
                             [(p.name, p.podgang_name, m["request"](p, RESOURCES).tolist())
                              for p in ds.pods]))
            out[pkg] = docs
        assert out["port"] == out["jax"]
        assert len(out["port"]) == racks + 1


@pytest.mark.parametrize("n,cap", [(1, 8), (5, 8), (16, 8), (3, 8), (32, 32), (7, 0)])
def test_candidate_ladder_equals_jax(n, cap):
    assert p_defrag.candidate_ladder(n, cap) == r_defrag.candidate_ladder(n, cap)


def test_largest_placeable_equals_jax():
    out = {}
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, *_ = frag_world(pkg)
        snap = m["snap"](nodes, topo, bound_pods=list(pods.values()))
        dom = m["domain"]
        out[pkg] = [m["defrag"].largest_placeable(snap, req, lvl)
                    for req in ({"google.com/tpu": 8.0}, {"cpu": 4.0, "google.com/tpu": 8.0},
                                {"cpu": 1.0}, {"memory": 0.0})
                    for lvl in (dom.RACK, dom.BLOCK, dom.ZONE, dom.HOST)]
    assert out["port"] == out["jax"]
    assert out["port"][0] == 6  # 8 hosts a rack, 2 squatted


@pytest.fixture(scope="module")
def plans():
    """Each package's plan of the fragmented world, the launch-cache entries
    its re-plan of the same state prepared, and the big gang's admission
    before and after the moves."""
    out = {}
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, big, *_ = frag_world(pkg)
        wp = m["warm"]()
        plan = m["defrag"].plan_migrations(nodes, topo, gangs, dict(pods), warm=wp,
                                           max_moves=len(gangs), **m["kw"])
        low0 = wp.executables.lowerings
        plan2 = m["defrag"].plan_migrations(nodes, topo, gangs, dict(pods), warm=wp,
                                            max_moves=len(gangs), **m["kw"])
        moved = {name: node for mv in plan.moves for name, node in mv.bindings.items()}
        admitted = [admit(pkg, topo, nodes, pods, {}, big),
                    admit(pkg, topo, nodes, pods, moved, big)]
        out[pkg] = (plan, plan2, wp.executables.lowerings - low0, admitted)
    return out


def admit(pkg, topo, nodes, pods, moved, big) -> int:
    """Solve the big gang on `nodes` with `pods` bound, each moved pod on
    its target: how many gangs admit."""
    import copy

    m = PKG[pkg]
    bound = []
    for p in pods.values():
        q = copy.copy(p)
        q.node_name = moved.get(p.name, p.node_name)
        bound.append(q)
    snap = m["snap"](nodes, topo, bound_pods=bound)
    all_pods = {**{q.name: q for q in bound}, **{p.name: p for p in big.pods}}
    if pkg == "jax":
        batch, decode = r_encode(big.podgangs, all_pods, snap)
        return len(r_decode(r_solve(snap, batch), decode, snap))
    batch, decode = p_encode(big.podgangs, all_pods, snap)
    res = p_solve(snap, batch, device="cpu")
    return len(p_decode(res.ok.numpy(), res.assigned.numpy(), decode, snap))


def test_plan_migrations_consolidates_equal_to_jax(plans):
    (p_plan, p_plan2, p_low, p_adm), (r_plan, r_plan2, r_low, r_adm) = plans["port"], plans["jax"]
    assert p_plan is not None and r_plan is not None
    assert moves_of(p_plan) == moves_of(r_plan)
    assert {k: getattr(p_plan, k) for k in PLAN_KEYS} == {k: getattr(r_plan, k) for k in PLAN_KEYS}
    assert p_plan.score_after < p_plan.score_before and p_plan.pods_migrated > 0
    assert p_plan.efficiency == pytest.approx(p_plan.capacity_recovered / p_plan.pods_migrated)
    assert p_plan.lowerings == r_plan.lowerings > 0
    assert p_adm == r_adm == [0, 1]  # the big gang: refused before, admitted after
    assert moves_of(p_plan2) == moves_of(p_plan)
    assert p_plan2.lowerings == 0 and p_low == 0 == r_low
    doc = p_plan.to_doc()
    assert set(doc) == set(r_plan.to_doc())
    assert doc["moves"] == len(p_plan.moves) and doc["lowerings"] == p_plan.lowerings


def test_plan_migrations_none_when_nothing_improves():
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, *_ = frag_world(pkg, compact=True)
        assert m["defrag"].plan_migrations(nodes, topo, gangs, dict(pods), warm=m["warm"](),
                                           **m["kw"]) is None
        assert m["defrag"].plan_migrations(nodes, topo, [], dict(pods), **m["kw"]) is None


def test_plan_migrations_min_efficiency_gate():
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, *_ = frag_world(pkg)
        assert m["defrag"].plan_migrations(nodes, topo, gangs, dict(pods), warm=m["warm"](),
                                           min_efficiency=1e18, **m["kw"]) is None


@pytest.mark.parametrize("sizes", [[1, 2], [3], [8]])
def test_plan_migrations_candidate_sizes_equal_jax(sizes):
    out = {}
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, *_ = frag_world(pkg)
        plan = m["defrag"].plan_migrations(nodes, topo, gangs, dict(pods), warm=m["warm"](),
                                           candidate_sizes=sizes, **m["kw"])
        out[pkg] = None if plan is None else (moves_of(plan), plan.candidates_evaluated,
                                              plan.capacity_recovered)
    assert out["port"] == out["jax"]


def rescue_world(pkg):
    """The fragmented world plus one disaggregated set (a base gang and a
    PCSG child gang) placed by each package's own solve; racks 0 and 1
    then cordoned."""
    m = PKG[pkg]
    topo, nodes, gangs, pods, _, rack_nodes, rack_list = frag_world(pkg)
    ds = m["expand"](m["wl"].disagg_pcs("dz"), topo)
    snap = m["snap"](nodes, topo, bound_pods=list(pods.values()))
    new = {p.name: p for p in ds.pods}
    allp = {**pods, **new}
    if pkg == "jax":
        batch, decode = r_encode(ds.podgangs, allp, snap)
        placed = r_decode(r_solve(snap, batch), decode, snap)
    else:
        batch, decode = p_encode(ds.podgangs, allp, snap)
        res = p_solve(snap, batch, device="cpu")
        placed = p_decode(res.ok.numpy(), res.assigned.numpy(), decode, snap)
    assert set(placed) == {g.name for g in ds.podgangs}
    for gang_bindings in placed.values():
        for pod_name, node in gang_bindings.items():
            new[pod_name].node_name = node
    cordoned = set(rack_nodes[rack_list[0]]) | set(rack_nodes[rack_list[1]])
    child = next(g for g in ds.podgangs if g.base_podgang_name is not None)
    cordoned |= {new[r.name].node_name for grp in child.spec.pod_groups
                 for r in grp.pod_references}
    for n in nodes:
        n.schedulable = n.name not in cordoned
    return topo, nodes, gangs[:2] + [child], allp, cordoned


@pytest.mark.parametrize("hold_usage", [True, False])
def test_plan_rescue_equals_jax(hold_usage):
    out = {}
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, cordoned = rescue_world(pkg)
        moves = m["defrag"].plan_rescue(nodes, topo, gangs, pods, warm=m["warm"](),
                                        hold_usage=hold_usage, **m["kw"])
        out[pkg] = moves_of(moves)
        if pkg == "port":
            assert {mv.gang for mv in moves} == {g.name for g in gangs}  # the child too
            targets = {node for mv in moves for node in mv.bindings.values()}
            assert targets and not targets & cordoned
            moved = {name: node for mv in moves for name, node in mv.bindings.items()}
            bound = []
            for p in pods.values():
                if p.node_name is None:
                    continue
                q = type(p)(**vars(p))
                q.node_name = moved.get(p.name, p.node_name)
                bound.append(q)
            for n in nodes:
                n.schedulable = True
            snap = p_snapshot(nodes, topo, bound_pods=bound)
            assert bool((snap.free >= -1e-3).all()), "a node is over capacity"
    assert out["port"] == out["jax"]


def test_plan_rescue_child_gang_needs_its_base_counted_scheduled():
    for pkg, m in PKG.items():
        topo, nodes, gangs, pods, _ = rescue_world(pkg)
        child = gangs[-1]
        moves = m["defrag"].plan_rescue(nodes, topo, [child], pods, **m["kw"])
        assert [mv.gang for mv in moves] == [child.name]
        assert m["defrag"].plan_rescue(nodes, topo, [], pods, **m["kw"]) == []


# ---- the planner's shared discipline ------------------------------------------------


def gang_doc(g) -> tuple:
    if g is None:
        return None
    return (g.name, g.pcs_name, g.pcs_replica_index, g.base_podgang_name, g.scaled_index,
            g.slo_class, g.spec.spread_key,
            [(grp.name, [r.name for r in grp.pod_references], grp.min_replicas,
              repr(grp.topology_constraint)) for grp in g.spec.pod_groups],
            [(gc.name, gc.pod_group_names) for gc in g.spec.topology_constraint_group_configs],
            repr(g.spec.topology_constraint))


def expanded(pkg):
    m = PKG[pkg]
    wl, topo = m["wl"], m["wl"].bench_topology()
    gangs = []
    for pcs in (wl.disagg_pcs("a"), wl.aggregated_pcs("b"), wl.frontend_pcs("c"),
                wl.disagg_pcs("e")):
        gangs.extend(m["expand"](pcs, topo).podgangs)
    return gangs


@pytest.mark.parametrize("bound", [0, 1, 3])
def test_build_pending_subgang_equals_jax(bound):
    out = {}
    for pkg, (planner, name_t) in {"jax": (r_planner, RName), "port": (p_planner, PName)}.items():
        subs = []
        for g in expanded(pkg):
            unbound, counts = {}, {}
            for i, grp in enumerate(g.spec.pod_groups):
                refs = grp.pod_references[min(bound, len(grp.pod_references)):]
                if i % 2 == 0:
                    unbound[grp.name] = [name_t(r.namespace, r.name) for r in refs]
                counts[grp.name] = bound
            subs.append(gang_doc(planner.build_pending_subgang(g, unbound, counts)))
        out[pkg] = subs
    assert out["port"] == out["jax"]


def test_sort_pending_equals_jax():
    out = {}
    for pkg, planner in (("jax", r_planner), ("port", p_planner)):
        gangs = expanded(pkg)
        prio = {g.name: (i * 7) % 5 for i, g in enumerate(gangs)}
        tier = {g.name: (i * 3) % 2 for i, g in enumerate(gangs)}
        out[pkg] = (
            [g.name for g in planner.sort_pending(gangs, lambda g: prio[g.name])],
            [g.name for g in planner.sort_pending(gangs, lambda g: prio[g.name],
                                                  lambda g: tier[g.pcs_name + "-0"])],
        )
    assert out["port"] == out["jax"]


def test_build_spread_avoid_equals_jax():
    out = {}
    for pkg, planner in (("jax", r_planner), ("port", p_planner)):
        gangs = [g for g in expanded(pkg) if g.base_podgang_name is None]
        occupied = {(g.pcs_name, g.pcs_replica_index): {f"n{i}", f"n{i + 1}"}
                    for i, g in enumerate(gangs)}
        occupied[("a", 1)] = {"n9"}
        got = planner.build_spread_avoid(gangs, occupied)
        out[pkg] = {k: sorted(v) for k, v in got.items()}
    assert out["port"] == out["jax"] and out["port"]


def test_port_pod_is_scheduled_and_active():
    from grove_tpu_torch.api.pod import Pod

    p = Pod(name="x")
    assert not p.is_scheduled and p.is_active
    p.node_name = "n0"
    assert p.is_scheduled


def test_snapshot_pad_rows_are_unschedulable():
    topo, nodes, gangs, pods, *_ = frag_world("port", blocks=1, racks_per_block=3, hosts=6)
    snap = p_snapshot(nodes, topo, bound_pods=list(pods.values()), pad_nodes_to=32)
    assert snap.capacity.shape[0] == 32 and len(nodes) == 18
    assert not snap.schedulable[18:].any() and not np.asarray(snap.capacity[18:]).any()
