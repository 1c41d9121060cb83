"""Host stages of the PyTorch port against the JAX package: expansion ->
snapshot -> encode_gangs must be byte-equal (values and dtypes).

Also home of the scenario corpus the other test_torch_* files share: each
scenario is built twice from the same description, once with the JAX
package's host modules and once with grove_tpu_torch's.
"""

from __future__ import annotations

import pathlib
import types

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest
import yaml

import grove_tpu_torch.api as p_api
import grove_tpu_torch.api.pod as p_pod
import grove_tpu_torch.api.types as p_types
import grove_tpu_torch.orchestrator as p_orch
import grove_tpu_torch.sim.workloads as p_wl
import grove_tpu_torch.solver.encode as p_enc
import grove_tpu_torch.state as p_state
import scenario_harness as sh
from grove_tpu import api as r_api
from grove_tpu import orchestrator as r_orch
from grove_tpu import state as r_state
from grove_tpu.api import pod as r_pod
from grove_tpu.api import types as r_types
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import encode as r_enc
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


def _pkg(api, types_mod, pod, orch, state, wl, enc):
    return types.SimpleNamespace(
        PodCliqueSet=api.PodCliqueSet,
        default_podcliqueset=api.default_podcliqueset,
        ClusterTopology=types_mod.ClusterTopology,
        TopologyLevel=types_mod.TopologyLevel,
        TopologyDomain=types_mod.TopologyDomain,
        Container=types_mod.Container,
        PodSpec=types_mod.PodSpec,
        Pod=pod.Pod,
        Node=state.Node,
        build_snapshot=state.build_snapshot,
        expand=orch.expand_podcliqueset,
        wl=wl,
        encode_gangs=enc.encode_gangs,
    )


REF = _pkg(r_api, r_types, r_pod, r_orch, r_state, r_wl, r_enc)
PORT = _pkg(p_api, p_types, p_pod, p_orch, p_state, p_wl, p_enc)
ZONE, BLOCK, RACK = sh.ZONE_KEY, sh.BLOCK_KEY, sh.RACK_KEY


def pcs_of(P, doc):
    return P.default_podcliqueset(P.PodCliqueSet.from_dict(doc))


def harness_pcs(P, fn, *args, **kwargs):
    """Call a tests/scenario_harness workload builder with package P's
    PodCliqueSet classes (the harness builds docs, then parses them)."""
    saved = sh.PodCliqueSet, sh.default_podcliqueset
    sh.PodCliqueSet, sh.default_podcliqueset = P.PodCliqueSet, P.default_podcliqueset
    try:
        return fn(*args, **kwargs)
    finally:
        sh.PodCliqueSet, sh.default_podcliqueset = saved


def topology(P, levels=((ZONE, "zone"), (BLOCK, "block"), (RACK, "rack")), name="t"):
    return P.ClusterTopology(
        name=name,
        levels=[P.TopologyLevel(P.TopologyDomain(dom), key) for key, dom in levels],
    )


def nodes_from(P, ref_nodes):
    """Copy reference Node objects into package P's Node class."""
    return [
        P.Node(
            name=n.name,
            capacity=dict(n.capacity),
            labels=dict(n.labels),
            schedulable=n.schedulable,
            taints=[dict(t) for t in n.taints],
        )
        for n in ref_nodes
    ]


def mk_nodes(P, count, cpu=4.0, racks=2, zones=1, pool_from=None):
    """tests/test_solver.py mk_nodes; nodes from index `pool_from` on carry
    pool=tpu, the rest pool=cpu (nodeSelector scenarios)."""
    out = []
    for i in range(count):
        labels = {ZONE: f"z{i % zones}", RACK: f"r{i % racks}"}
        if pool_from is not None:
            labels["pool"] = "tpu" if i >= pool_from else "cpu"
        out.append(P.Node(name=f"n{i}", capacity={"cpu": cpu, "memory": 8 * 2**30}, labels=labels))
    return out


def expand_all(P, pcs_list, topo):
    gangs, pods = [], {}
    for pcs in pcs_list:
        ds = P.expand(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods


def _simple1(P, selector=None):
    doc = yaml.safe_load((REPO / "examples" / "simple1.yaml").read_text())
    topo = topology(P, ((ZONE, "zone"), (RACK, "rack")))
    gangs, pods = expand_all(P, [pcs_of(P, doc)], topo)
    if selector is not None:
        for p in pods.values():
            if "frontend" in p.pclq_fqn:
                p.spec.node_selector = dict(selector)
    nodes = mk_nodes(P, 8, pool_from=6 if selector is not None else None)
    return gangs, pods, P.build_snapshot(nodes, topo)


def _wl(P, fn, n_nodes=12, **kwargs):
    topo = topology(P)
    gangs, pods = expand_all(P, [harness_pcs(P, fn, **kwargs)], topo)
    return gangs, pods, P.build_snapshot(nodes_from(P, sh.e2e_nodes(n_nodes)), topo)


def _bench(P, racks_per_block=1, n=(6, 4, 5), **cluster):
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.synthetic_backlog(*n), topo)
    nodes = P.wl.synthetic_cluster(racks_per_block=racks_per_block, **cluster)
    return gangs, pods, P.build_snapshot(nodes, topo)


def _bench_spread(P, n=(6, 4, 5), every=2):
    """The bench backlog with every `every`-th PodCliqueSet at two replicas
    spread across zones (the replica-spread planes at bench shapes)."""
    topo = P.wl.bench_topology()
    backlog = P.wl.synthetic_backlog(*n)
    for pcs in backlog[::every]:
        pcs.spec.replicas = 2
        pcs.spec.topology_spread_domain = P.TopologyDomain("zone")
    gangs, pods = expand_all(P, backlog, topo)
    return gangs, pods, P.build_snapshot(P.wl.synthetic_cluster(racks_per_block=1), topo)


def _contended(P, n_gangs=48):
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.contended_backlog(n_gangs), topo)
    nodes, squatters = P.wl.contended_cluster()
    return gangs, pods, P.build_snapshot(nodes, topo, bound_pods=squatters)


def _mixed(P):
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.mixed_backlog(), topo)
    return gangs, pods, P.build_snapshot(P.wl.quality_cluster(), topo)


def _binpack_trap(P):
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.binpack_trap_backlog(), topo)
    return gangs, pods, P.build_snapshot(P.wl.binpack_trap_cluster(), topo)


def _spread_doc(name="spr", pack=False):
    clique = {
        "name": "w",
        "spec": {
            "roleName": "w",
            "replicas": 2,
            "podSpec": {
                "containers": [
                    {"name": "w", "image": "r.local/w:latest",
                     "resources": {"requests": {"cpu": "1"}}}
                ]
            },
        },
    }
    if pack:
        clique["topologyConstraint"] = {"packDomain": "rack"}
    return {
        "apiVersion": "grove.io/v1alpha1",
        "kind": "PodCliqueSet",
        "metadata": {"name": name},
        "spec": {"replicas": 2, "topologySpreadDomain": "zone",
                 "template": {"cliques": [clique]}},
    }


def _spread(P, pack=False):
    """tests/test_spread.py: two zones of one rack each; with `pack`, z0 is
    pre-loaded so best-fit favours it and spread must steer the pick."""
    topo = topology(P, ((ZONE, "zone"), (RACK, "rack")))
    nodes = [
        P.Node(name=f"z{z}h{h}", capacity={"cpu": 16.0, "memory": 64 * 2**30},
               labels={ZONE: f"z{z}", RACK: f"r{z}"})
        for z in range(2) for h in range(3)
    ]
    bound = None
    if pack:
        bound = [P.Pod(name="squat", node_name="z0h0", spec=P.PodSpec(
            containers=[P.Container(name="c", requests={"cpu": 10.0})]))]
    gangs, pods = expand_all(P, [pcs_of(P, _spread_doc(pack=pack))], topo)
    return gangs, pods, P.build_snapshot(nodes, topo, bound_pods=bound)


def _nondyadic_doc(i):
    """Requests that are no dyadic rationals (100m/300m cpu, 300Mi/700Mi):
    a rack-packed scaling group, a preferred-rack standalone clique, all
    under a block-level gang pack."""

    def clique(name, replicas, cpu, mem):
        return {
            "name": name,
            "spec": {
                "roleName": name,
                "replicas": replicas,
                "podSpec": {"containers": [{"name": name, "resources": {
                    "requests": {"cpu": cpu, "memory": mem}}}]},
            },
        }

    router = clique("router", 3, "100m", "300Mi")
    router["topologyConstraint"] = {"preferredDomain": "rack"}
    return {
        "apiVersion": "grove.io/v1alpha1",
        "kind": "PodCliqueSet",
        "metadata": {"name": f"nd-{i}"},
        "spec": {
            "replicas": 2,
            "template": {
                "topologyConstraint": {"packDomain": "block"},
                "cliques": [router, clique("worker", 5, "300m", "700Mi")],
                "podCliqueScalingGroups": [{
                    "name": "workers", "cliqueNames": ["worker"], "replicas": 2,
                    "minAvailable": 1, "topologyConstraint": {"packDomain": "rack"},
                }],
            },
        },
    }


def _nondyadic_fleet(P):
    """sim/workloads.py's nondyadic_cluster and nondyadic_backlog (160
    nodes, pods of 100m-multiple CPU and non-power-of-two MiB memory bound
    on them and in the 24-gang backlog): nodes that take several pods of one
    group, so the free update's product is inexact too. The JAX package has
    no such function: its objects are the port's through the journal codec,
    which both packages read."""
    nodes, bound = p_wl.nondyadic_cluster()
    backlog = p_wl.nondyadic_backlog()
    if P is REF:
        from grove_tpu.trace import recorder as _r_rec  # noqa: F401  (the codec's types)
        from grove_tpu.utils import serde as r_serde
        from grove_tpu_torch.trace import recorder as _p_rec  # noqa: F401
        from grove_tpu_torch.utils import serde as p_serde

        nodes, bound, backlog = (r_serde.decode(p_serde.encode(x))
                                 for x in (nodes, bound, backlog))
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, backlog, topo)
    return gangs, pods, P.build_snapshot(nodes, topo, bound_pods=bound)


def _nondyadic(P):
    """80 hosts of 31.7 cpu, a third of them part-filled by squatters of
    0.3-cpu steps: free capacity and its domain sums are not exact in f32,
    so the order of every domain sum shows in its last bits."""
    topo = P.wl.bench_topology()
    nodes = P.wl.synthetic_cluster(zones=2, blocks_per_zone=2, racks_per_block=2,
                                   hosts_per_rack=10, cpu=31.7, memory=100.3 * 2**30, tpu=0.0)
    squat = [
        P.Pod(name=f"squat-{k}", node_name=node.name, spec=P.PodSpec(containers=[P.Container(
            name="c", requests={"cpu": 0.3 * (k % 7 + 1), "memory": 300 * 2**20 * (k % 3 + 1)})]))
        for k, node in enumerate(nodes[::3])
    ]
    gangs, pods = expand_all(P, [pcs_of(P, _nondyadic_doc(i)) for i in range(6)], topo)
    return gangs, pods, P.build_snapshot(nodes, topo, bound_pods=squat)


SCENARIOS = {
    "simple1": _simple1,
    "wl1": lambda P: _wl(P, sh.wl1, replicas=2),
    "wl2": lambda P: _wl(P, sh.wl2, n_nodes=9),
    "wl3": lambda P: _wl(P, sh.wl3),
    "wl4": lambda P: _wl(P, sh.wl4, n_nodes=7),
    "wl5": lambda P: _wl(P, sh.wl5),
    "wl6": lambda P: _wl(P, sh.wl6),
    "bench_small": _bench,
    "contended": _contended,
    "mixed": _mixed,
    "binpack_trap": _binpack_trap,
    # Every node identical and empty, no pack constraints on the frontends:
    # every top-k step of stage 2 ties.
    "uniform": lambda P: _bench(P, n=(0, 0, 12), zones=1, blocks_per_zone=1,
                                racks_per_block=2, hosts_per_rack=8),
    "selector": lambda P: _simple1(P, selector={"pool": "tpu"}),
    "spread": _spread,
    "spread_pack": lambda P: _spread(P, pack=True),
    "bench_spread": _bench_spread,
    "nondyadic": _nondyadic,
    "nondyadic_fleet": _nondyadic_fleet,
}
HOST_SCENARIOS = [
    "simple1", "wl1", "wl2", "wl3", "wl4", "wl5", "wl6", "bench_small", "contended",
    "mixed", "binpack_trap", "selector", "spread_pack", "bench_spread", "nondyadic",
]


def build_pair(name):
    """(reference (gangs, pods, snapshot), port (gangs, pods, snapshot))."""
    fn = SCENARIOS[name]
    return fn(REF), fn(PORT)


def assert_batches_equal(rb, pb):
    for f in rb._fields:
        a, b = getattr(rb, f), getattr(pb, f)
        assert (a is None) == (b is None), f"{f}: None on one side only"
        if a is not None:
            assert a.dtype == b.dtype, f"{f}: {a.dtype} != {b.dtype}"
            assert np.array_equal(a, b), f"{f} differs"


@pytest.mark.parametrize("name", HOST_SCENARIOS)
def test_host_stages_byte_equal(name):
    (rg, rp, rs), (pg, pp, ps) = build_pair(name)
    assert [g.name for g in rg] == [g.name for g in pg]
    assert list(rp) == list(pp)
    for attr in ("free", "capacity", "schedulable", "node_domain_id", "num_domains"):
        a, b = getattr(rs, attr), getattr(ps, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert rs.node_names == ps.node_names
    rb, rdec = REF.encode_gangs(rg, rp, rs)
    pb, pdec = PORT.encode_gangs(pg, pp, ps)
    assert_batches_equal(rb, pb)
    assert rdec.gang_names == pdec.gang_names and rdec.pod_names == pdec.pod_names


@pytest.mark.parametrize("scale", [0.02, 0.05])
def test_bench_backlog_encode_byte_equal_per_wave(scale):
    """The bench backlog at a small scale, encoded wave by wave the way the
    drain encodes it (shape classes, gang pads, global index)."""
    from grove_tpu.solver.drain import plan_waves as r_plan
    from grove_tpu_torch.solver.drain import plan_waves as p_plan

    n = tuple(max(1, round(k * scale)) for k in (350, 250, 300))
    (rg, rp, rs), (pg, pp, ps) = _bench(REF, n=n), _bench(PORT, n=n)
    rw, pw = r_plan(rg, 8), p_plan(pg, 8)
    assert [(len(w), s, pad) for w, s, pad in rw] == [(len(w), s, pad) for w, s, pad in pw]
    rgi = {g.name: i for i, g in enumerate(rg)}
    pgi = {g.name: i for i, g in enumerate(pg)}
    for (rwv, (mg, ms, mp), pad), (pwv, _, _) in zip(rw, pw):
        kw = dict(max_groups=mg, max_sets=ms, max_pods=mp, pad_gangs_to=pad)
        rb, _ = REF.encode_gangs(rwv, rp, rs, global_index_of=rgi, **kw)
        pb, _ = PORT.encode_gangs(pwv, pp, ps, global_index_of=pgi, **kw)
        assert_batches_equal(rb, pb)


def test_reuse_and_spread_seeds_encode_equal():
    (rg, rp, rs), (pg, pp, ps) = build_pair("spread")
    reuse = {rg[0].name: [0, 2]}
    avoid = {rg[1].name: [3]}
    rb, _ = REF.encode_gangs(rg, rp, rs, reuse_nodes_by_gang=reuse, spread_avoid_by_gang=avoid)
    pb, _ = PORT.encode_gangs(pg, pp, ps, reuse_nodes_by_gang=reuse, spread_avoid_by_gang=avoid)
    assert pb.reuse_nodes is not None and pb.spread_level is not None
    assert_batches_equal(rb, pb)


def test_pod_request_vectors_equal():
    (rg, rp, rs), (pg, pp, ps) = build_pair("bench_small")
    for name in list(rp)[:50]:
        a = r_state.pod_request_vector(rp[name], rs.resource_names)
        b = p_state.pod_request_vector(pp[name], ps.resource_names)
        assert a.dtype == b.dtype and np.array_equal(a, b)
