"""The node-sharded solve (B7) on the card (`gpu` marker; run there with
`python -m pytest -m gpu tests/test_torch_shard_card.py`): place_wave_sharded
on S = 2, 4 and 8 virtual shards equals its plain version
(solver/reference.py `sharded_solve_ref`) on the same card inputs and the
single launch (B1), dense and pruned; solve(mesh=) through the launch cache
(a captured sharded entry, replayed) and a sharded drain equal the CPU's
plain versions. This file imports no JAX, so it runs on a machine that has
none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.orchestrator import expand_podcliqueset
from grove_tpu_torch.parallel import mesh as mesh_mod
from grove_tpu_torch.sim import workloads as W
from grove_tpu_torch.solver.core import SolverParams, batch_to, solve
from grove_tpu_torch.solver.drain import drain_backlog
from grove_tpu_torch.solver.encode import encode_gangs
from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates
from grove_tpu_torch.solver.reference import sharded_solve_ref
from grove_tpu_torch.solver.warm import WarmPath
from grove_tpu_torch.state import build_snapshot

FIELDS = ("assigned", "ok", "placement_score", "free_after", "ok_global")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_shard_card.py` on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _real_devices():
    yield
    mesh_mod.force_virtual_devices(0)


def problem(name):
    topo = W.bench_topology()
    bound = None
    if name == "synthetic":
        nodes = W.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=4)
        backlog = W.synthetic_backlog(n_disagg=14, n_agg=10, n_frontend=10)
    elif name == "contended":
        nodes, bound = W.contended_cluster()
        backlog = W.contended_backlog(n_gangs=24)
    else:
        nodes, backlog = W.quality_cluster(), W.mixed_backlog()
    gangs, pods = [], {}
    for pcs in backlog:
        ds = expand_podcliqueset(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods, build_snapshot(nodes, topo, bound_pods=bound)


def node_tensors(snap, dev):
    return (torch.as_tensor(snap.free, dtype=torch.float32, device=dev),
            torch.as_tensor(snap.capacity, device=dev),
            torch.as_tensor(snap.schedulable, device=dev),
            torch.as_tensor(snap.node_domain_id, device=dev))


def assert_equal(got, want, label):
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f"{label}: {name} differs at {torch.nonzero(a != b)[:8].tolist()}"


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["synthetic", "contended", "mixed"])
def test_b7_equals_plain_and_b1(cuda, name, shards):
    gangs, pods, snap = problem(name)
    batch, _ = encode_gangs(gangs, pods, snap,
                            global_index_of={g.name: i for i, g in enumerate(gangs)})
    tb = batch_to(batch, cuda)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
    node = node_tensors(snap, cuda)
    n = node[1].shape[0]
    spans = [(s * n // shards, (s + 1) * n // shards) for s in range(shards)]
    want = sharded_solve_ref(node[0].clone(), *node[1:], tb, SolverParams(), okg.clone(), spans)
    b1 = pwm.place_wave(node[0].clone(), *node[1:], tb, SolverParams(), okg.clone(),
                        domains=pwm.domain_index(snap.node_domain_id, cuda))
    n0 = pwm.place_wave.variant_launches["sharded"]
    got = pwm.place_wave_sharded(node[0].clone(), *node[1:], tb, SolverParams(), okg.clone(),
                                 shards=shards,
                                 domains=pwm.domain_index_sharded(snap.node_domain_id, shards,
                                                                  cuda))
    torch.cuda.synchronize()
    assert pwm.place_wave.variant_launches["sharded"] == n0 + 1
    assert_equal(got, want, f"B7 {name} S={shards} vs plain")
    assert_equal(got, b1, f"B7 {name} S={shards} vs B1")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_b7_pruned_equals_plain_and_b1(cuda, shards):
    gangs, pods, snap = problem("synthetic")
    batch, _ = encode_gangs(gangs, pods, snap,
                            global_index_of={g.name: i for i, g in enumerate(gangs)})
    plan = plan_candidates(snap, batch, PruningConfig(enabled=True, max_candidates=60,
                                                      min_fleet=16, min_pad=8),
                           mesh_axis=shards)
    assert plan is not None and plan.pad % shards == 0
    pt = plan.tensors(cuda)
    tb = batch_to(plan.gather_batch(batch), cuda)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
    free = torch.as_tensor(snap.free, dtype=torch.float32, device=cuda)
    rest = (pt.capacity, pt.schedulable, pt.node_domain_id)
    spans = [(s * plan.pad // shards, (s + 1) * plan.pad // shards) for s in range(shards)]
    want = sharded_solve_ref(free.clone(), *rest, tb, SolverParams(), okg.clone(), spans,
                             pt.cand_idx, plan.count)
    b1 = pwm.place_wave(free.clone(), *rest, tb, SolverParams(), okg.clone(), domains=pt.domains,
                        cand_idx=pt.cand_idx, cand_count=plan.count)
    n0 = pwm.place_wave.variant_launches["sharded_pruned"]
    got = pwm.place_wave_sharded(free.clone(), *rest, tb, SolverParams(), okg.clone(),
                                 shards=shards,
                                 domains=pwm.domain_index_sharded(pt.node_domain_id, shards, cuda),
                                 cand_idx=pt.cand_idx, cand_count=plan.count)
    torch.cuda.synchronize()
    assert pwm.place_wave.variant_launches["sharded_pruned"] == n0 + 1
    assert_equal(got, want, f"B7 pruned S={shards} vs plain")
    assert_equal(got, b1, f"B7 pruned S={shards} vs B1")


@pytest.mark.gpu
@pytest.mark.parametrize("pruned", [False, True])
def test_solve_under_a_layout_through_the_cache_equals_cpu(cuda, pruned):
    """solve(mesh=) on 4 virtual shards of the card: a captured sharded
    entry, replayed for the second solve with no new entry, == the CPU's
    plain sharded solve and its unsharded one."""
    gangs, pods, snap = problem("synthetic")
    batch, _ = encode_gangs(gangs, pods, snap)
    kw = {"pruning": PruningConfig(enabled=True, max_candidates=60, min_fleet=16, min_pad=8)} \
        if pruned else {}
    n = int(snap.free.shape[0])
    mesh_mod.force_virtual_devices(4, "cpu")
    cpu = solve(snap, batch, device="cpu", warm=WarmPath(),
                mesh=mesh_mod.solve_layout_for(n), **kw)
    base = solve(snap, batch, device="cpu", warm=WarmPath(), **kw)
    mesh_mod.force_virtual_devices(4, cuda)
    layout = mesh_mod.solve_layout_for(n)
    wp = WarmPath()
    n0 = dict(pwm.place_wave.variant_launches)
    first = solve(snap, batch, device=cuda, warm=wp, mesh=layout, **kw)
    lowerings = wp.executables.lowerings
    again = solve(snap, batch, device=cuda, warm=wp, mesh=layout, **kw)
    torch.cuda.synchronize()
    assert wp.executables.lowerings == lowerings
    variant = "sharded_pruned" if pruned else "sharded"
    assert pwm.place_wave.variant_launches[variant] >= n0[variant] + 2
    for res in (first, again):
        for name in ("assigned", "ok", "placement_score", "free_after"):
            a, b, c = (getattr(r, name).cpu() for r in (res, cpu, base))
            assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.gpu
@pytest.mark.parametrize("harvest", ["chained", "pipeline"])
def test_sharded_drain_on_card_equals_cpu(cuda, harvest):
    gangs, pods, snap = problem("synthetic")
    mesh_mod.force_virtual_devices(8, cuda)
    cfg = mesh_mod.MeshConfig(enabled=True, min_nodes=64)
    got, gstats = drain_backlog(gangs, pods, snap, wave_size=16, harvest=harvest, device=cuda,
                                warm_path=WarmPath(), mesh=cfg)
    want, wstats = drain_backlog(gangs, pods, snap, wave_size=16, harvest=harvest, device="cpu",
                                 warm_path=WarmPath())
    assert got == want
    assert gstats.shard_devices == 8 and gstats.shard_fallbacks == 0
    assert np.array_equal(gstats.free_after, wstats.free_after)
