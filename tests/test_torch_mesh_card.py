"""The two compositions of B7 on the card (`gpu` marker; run there with
`python -m pytest -m gpu tests/test_torch_mesh_card.py`): B5 x B7 (a
portfolio under a (portfolio, node) mesh, `place_wave_stacked_sharded`) at
(4, 2) and (2, 4) and B4 x B7 (a scan over shards, `place_wave_scan_sharded`)
at S = 2, 4, 8, dense and pruned, each equal to its plain version on the
same card inputs and to the unsharded kernel (B5, B4); the launch cache's
captured sharded scan entries, replayed; and drains on virtual devices of the
card (scan, resident, a portfolio=4 drain) equal to the CPU's plain
versions. This file imports no JAX, so it runs on a machine that has none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.parallel import mesh as mesh_mod
from grove_tpu_torch.parallel.portfolio import params_population
from grove_tpu_torch.solver import reference as ref
from grove_tpu_torch.solver.core import (
    SolverParams,
    batch_to,
    scan_pruned_solve,
    scan_solve,
    stack_on,
    stacked_dispatch,
)
from grove_tpu_torch.solver.drain import drain_backlog
from grove_tpu_torch.solver.encode import encode_gangs, stack_batches
from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates, stack_plan_arrays
from grove_tpu_torch.solver.warm import WarmPath
from test_torch_shard_card import cuda, node_tensors, problem  # noqa: F401

SEL = ("assigned", "ok", "placement_score", "free_after", "ok_global", "winner", "objectives")
SCAN = ("assigned", "ok", "placement_score", "free_in", "okg_in", "free_after", "ok_global")


@pytest.fixture(autouse=True)
def _real_devices():
    yield
    mesh_mod.force_virtual_devices(0)


def equal(names, got, want, label):
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), (label, name)
        if a is not None:
            assert torch.equal(a, b), f"{label}: {name} differs at {torch.nonzero(a != b)[:8]}"


def spans_of(n, shards):
    return [(s * n // shards, (s + 1) * n // shards) for s in range(shards)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,shards", [(4, 2), (2, 4)])
@pytest.mark.parametrize("name", ["synthetic", "contended", "mixed"])
def test_b5_b7_equals_plain_and_b5(cuda, name, rows, shards):
    gangs, pods, snap = problem(name)
    batch, _ = encode_gangs(gangs, pods, snap,
                            global_index_of={g.name: i for i, g in enumerate(gangs)})
    tb = batch_to(batch, cuda)
    okg = torch.as_tensor(np.random.default_rng(5).random(len(gangs)) < 0.3, device=cuda)
    node = node_tensors(snap, cuda)
    pstack = stack_on(params_population(rows), cuda)
    mesh_mod.force_virtual_devices(rows * shards, cuda)
    layout = mesh_mod.solver_mesh_for(rows, int(node[1].shape[0]), cuda)
    assert (layout.portfolio_devices, layout.node_devices) == (rows, shards)
    plain = ref.sharded_stacked_solve_ref(node[0], *node[1:], tb, pstack, okg,
                                          spans_of(node[1].shape[0], shards))
    want = ref.portfolio_select_ref(*plain, tb, okg.clone())
    n0 = pwm.place_wave.variant_launches["portfolio_sharded"]
    got = stacked_dispatch(node[0].clone(), *node[1:], tb, pstack, okg.clone(), select=True,
                           device=cuda, domains=None, layout=layout)
    b5 = pwm.place_wave_stacked(node[0].clone(), *node[1:], tb, pstack, okg.clone(),
                                domains=pwm.domain_index(snap.node_domain_id, cuda), select=True)
    rows_got = stacked_dispatch(node[0].clone(), *node[1:], tb, pstack, okg.clone(),
                                select=False, device=cuda, domains=None, layout=layout)
    torch.cuda.synchronize()
    assert pwm.place_wave.variant_launches["portfolio_sharded"] == n0 + 1
    equal(SEL, got, want, f"B5xB7 {name} {rows}x{shards} vs plain")
    equal(SEL, got, b5, f"B5xB7 {name} {rows}x{shards} vs B5")
    equal(SEL[:4], rows_got, plain, f"B5xB7 rows {name} {rows}x{shards} vs plain")


def chunk(gangs, pods, snap, waves=3, pad_to=4):
    gidx = {g.name: i for i, g in enumerate(gangs)}
    full, _ = encode_gangs(gangs, pods, snap, global_index_of=gidx)
    per = -(-len(gangs) // waves)
    steps = [encode_gangs(gangs[w * per:(w + 1) * per], pods, snap, global_index_of=gidx,
                          max_groups=full.group_req.shape[1], max_sets=full.set_member.shape[1],
                          max_pods=full.pod_group.shape[1], pad_gangs_to=per)[0]
             for w in range(waves)]
    return steps, stack_batches(steps, pad_to=pad_to)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["synthetic", "contended"])
def test_b4_b7_equals_plain_and_b4(cuda, name, shards):
    gangs, pods, snap = problem(name)
    _, sb = chunk(gangs, pods, snap)
    tb = batch_to(sb, cuda)
    node = node_tensors(snap, cuda)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
    mesh_mod.force_virtual_devices(shards, cuda)
    layout = mesh_mod.solve_layout_for(int(node[1].shape[0]))
    assert layout.node_devices == shards
    want = ref.sharded_scan_solve_ref(node[0], *node[1:], tb, SolverParams(), okg, True,
                                      spans_of(node[1].shape[0], shards))
    n0 = pwm.place_wave.variant_launches["scan_sharded"]
    got = scan_solve(node[0].clone(), *node[1:], tb, SolverParams(), okg.clone(), retain=True,
                     device=cuda, layout=layout)
    b4 = scan_solve(node[0].clone(), *node[1:], tb, SolverParams(), okg.clone(), retain=True,
                    device=cuda)
    torch.cuda.synchronize()
    assert pwm.place_wave.variant_launches["scan_sharded"] == n0 + 1
    equal(SCAN, got, want, f"B4xB7 {name} S={shards} vs plain")
    equal(SCAN, got, b4, f"B4xB7 {name} S={shards} vs B4")


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_b4_b7_pruned_equals_plain_and_b4(cuda, shards):
    gangs, pods, snap = problem("synthetic")
    steps, _ = chunk(gangs, pods, snap)
    cfg = PruningConfig(enabled=True, max_candidates=120, min_fleet=16, min_pad=128)
    plans = [plan_candidates(snap, b, cfg, mesh_axis=shards) for b in steps]
    assert all(p is not None and p.pad == plans[0].pad for p in plans)
    cand, cap, sched, ndid, pbatch = stack_plan_arrays(plans, steps, pad_to=4)
    args = tuple(torch.as_tensor(x, device=cuda) for x in (cand, cap, sched, ndid))
    tb = batch_to(pbatch, cuda)
    free = torch.as_tensor(snap.free, dtype=torch.float32, device=cuda)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
    mesh_mod.force_virtual_devices(shards, cuda)
    layout = mesh_mod.solve_layout_for(int(cap.shape[1]))
    want = ref.sharded_scan_pruned_solve_ref(free, *args, tb, SolverParams(), okg, True,
                                             spans_of(cap.shape[1], shards))
    got = scan_pruned_solve(free.clone(), *args, tb, SolverParams(), okg.clone(), retain=True,
                            device=cuda, layout=layout)
    b4 = scan_pruned_solve(free.clone(), *args, tb, SolverParams(), okg.clone(), retain=True,
                           device=cuda)
    torch.cuda.synchronize()
    equal(SCAN, got, want, f"B4xB7 pruned S={shards} vs plain")
    equal(SCAN, got, b4, f"B4xB7 pruned S={shards} vs B4")


@pytest.mark.gpu
def test_cache_entries_of_the_sharded_scan_replay(cuda):
    """A captured sharded scan entry, dense and pruned, retained, replayed
    twice with no new entry, equals the direct launch."""
    gangs, pods, snap = problem("synthetic")
    steps, sb = chunk(gangs, pods, snap)
    node = node_tensors(snap, cuda)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
    mesh_mod.force_virtual_devices(4, cuda)
    layout = mesh_mod.solve_layout_for(int(node[1].shape[0]))
    wp = WarmPath()
    cache = wp.executables
    direct = scan_solve(node[0].clone(), *node[1:], batch_to(sb, cuda), SolverParams(),
                        okg.clone(), retain=True, device=cuda, layout=layout)
    for i in range(2):
        res = cache.solve_scan(node[0], *node[1:], sb, SolverParams(), okg, retain=True,
                               device=cuda, layout=layout)
        equal(SCAN, res, direct, f"cached B4xB7 replay {i}")
    assert cache.lowerings == 1 and cache.hits == 1
    cfg = PruningConfig(enabled=True, max_candidates=120, min_fleet=16, min_pad=128)
    plans = [plan_candidates(snap, b, cfg, mesh_axis=4) for b in steps]
    cand, cap, sched, ndid, pbatch = stack_plan_arrays(plans, steps, pad_to=4)
    pdirect = scan_pruned_solve(node[0].clone(), cand, cap, sched, ndid, pbatch, SolverParams(),
                                okg.clone(), retain=True, device=cuda, layout=layout)
    for i in range(2):
        res = cache.solve_scan_pruned(node[0], cand, cap, sched, ndid, pbatch, SolverParams(),
                                      okg, retain=True, device=cuda, layout=layout)
        equal(SCAN, res, pdirect, f"cached pruned B4xB7 replay {i}")
    assert cache.lowerings == 2


@pytest.mark.gpu
@pytest.mark.parametrize("harvest,pruned", [("scan", False), ("resident", False),
                                            ("scan", True)])
def test_scanned_drains_under_a_mesh_on_card_equal_cpu(cuda, harvest, pruned):
    gangs, pods, snap = problem("synthetic")
    kw = {"pruning": PruningConfig(enabled=True, max_candidates=60, min_fleet=16,
                                   min_pad=8)} if pruned else {}
    mesh_mod.force_virtual_devices(8, cuda)
    n0 = dict(pwm.place_wave.variant_launches)
    got, gstats = drain_backlog(gangs, pods, snap, wave_size=8, harvest=harvest, device=cuda,
                                warm_path=WarmPath(), mesh=mesh_mod.MeshConfig(
                                    enabled=True, min_nodes=64), **kw)
    torch.cuda.synchronize()
    want, wstats = drain_backlog(gangs, pods, snap, wave_size=8, harvest=harvest, device="cpu",
                                 warm_path=WarmPath(), **kw)
    assert got == want and np.array_equal(gstats.free_after, wstats.free_after)
    assert gstats.shard_devices == 8 and gstats.scan_chunks > 0
    variant = "scan_sharded_pruned" if pruned else "scan_sharded"
    assert pwm.place_wave.variant_launches[variant] - n0[variant] == \
        gstats.scan_chunks + gstats.scan_rechains


@pytest.mark.gpu
def test_portfolio_drain_on_8_virtual_devices_equals_cpu(cuda):
    gangs, pods, snap = problem("synthetic")
    mesh_mod.force_virtual_devices(8, cuda)
    n0 = pwm.place_wave.variant_launches["portfolio_sharded"]
    got, gstats = drain_backlog(gangs, pods, snap, wave_size=16, portfolio=4, device=cuda,
                                warm_path=WarmPath())
    torch.cuda.synchronize()
    mesh_mod.force_virtual_devices(0)
    want, wstats = drain_backlog(gangs, pods, snap, wave_size=16, portfolio=4, device="cpu",
                                 warm_path=WarmPath())
    assert got == want and np.array_equal(gstats.free_after, wstats.free_after)
    assert pwm.place_wave.variant_launches["portfolio_sharded"] - n0 == gstats.waves
