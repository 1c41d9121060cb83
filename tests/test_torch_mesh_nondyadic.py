"""The node-sharded solves on a fleet whose free capacity f32 holds
inexactly, against the JAX package's sharded solves on the same layouts, at
tolerance 0, on the suite's 8 virtual CPU devices (tests/conftest.py; the
port's plain versions on 8 virtual devices of the CPU).

The fleet is sim/workloads.py's `nondyadic_cluster`: the synthetic fleet
(160 nodes) with pods of 100m-multiple CPU and non-power-of-two MiB memory
bound on it, and `nondyadic_backlog`, pods of the same kind. Free CPU then
lies in tenths, so a domain's free sum depends on the order it is added in,
and a sharded solve's partials (summed per shard in node order, then over
the shards in shard order) must meet JAX's bit for bit:

  - B7: solve() at S = 2, 4, 8, dense and pruned;
  - B5 x B7: portfolio_solve and portfolio_solve_batch under the (4, 2)
    mesh solver_mesh_for negotiates;
  - B4 x B7: drain_backlog in "scan" mode under a 4-device layout.

The JAX package has no such function: the port's objects reach it through
the journal codec (utils/serde), which both packages read
(tests/test_torch_host.py `_nondyadic_fleet`, where the unsharded solve
and kernel B1's source in host emulation are held on it too).

Found here: stage 2's free update, free - take * req (core.py:482), is one
fused multiply-add in XLA's CPU code, rounded once; the port rounded the
product and the difference apart, one ulp off where take * req is inexact.
The plain versions (`take_free_ref`) and the kernel (`pw_take_free`) now
round once; the sharded solves' own sums matched JAX's throughout.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.parallel import mesh as r_mesh
from grove_tpu.parallel import portfolio as rpf
from grove_tpu.solver import core as rc
from grove_tpu.solver.core import solve as r_solve
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.pruning import PruningConfig as RPruning
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu_torch.parallel import mesh as p_mesh
from grove_tpu_torch.parallel import portfolio as ppf
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.solver import reference as ref
from grove_tpu_torch.solver.core import batch_to
from grove_tpu_torch.solver.core import solve as p_solve
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.encode import stack_batches
from grove_tpu_torch.solver.pruning import PruningConfig as PPruning
from grove_tpu_torch.solver.pruning import plan_candidates
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from test_torch_host import PORT, REF
from test_torch_host import _nondyadic_fleet as nondyadic
from test_torch_mesh import _emulated_vs_plain, arrays, assert_same, jax_layout
from test_torch_mesh import host_sharded  # noqa: F401  (a fixture)
from test_torch_mesh_kernels import OUT, SCAN_OUT, assert_equal, chunk, launch_scan, node_state
from test_torch_mesh_kernels import lib  # noqa: F401  (a fixture)
from test_torch_mesh_kernels import spans_of
from test_torch_mesh_portfolio import jarrays, parrays
from test_torch_mesh_scan import same_drain
from test_torch_solver import assert_exact
from torch_jax_programs import _release_jax_programs  # noqa: F401

PRUNED = dict(enabled=True, max_candidates=120, min_fleet=16, min_pad=8)


@pytest.fixture(autouse=True)
def virtual8():
    assert len(jax.devices()) == 8
    p_mesh.force_virtual_devices(8, "cpu")
    yield p_mesh.mesh_devices()
    p_mesh.force_virtual_devices(0)


_WORLD: dict = {}


def world():
    """{"jax": (gangs, snapshot, batch), "port": (snapshot, batch as numpy)},
    built once per module."""
    if not _WORLD:
        for key, P in (("jax", REF), ("port", PORT)):
            gangs, pods, snap = nondyadic(P)
            batch, _ = P.encode_gangs(gangs, pods, snap,
                                      global_index_of={g.name: i for i, g in enumerate(gangs)})
            _WORLD[key] = (gangs, snap, batch)
    return _WORLD


def test_the_fleet_is_non_dyadic_and_the_same_in_both_packages():
    """Free CPU off the quarter grid, a rack's free sum that depends on its
    order, and both packages' snapshots and batches equal."""
    w = world()
    (rg, rs, rb), (pg, ps, pb) = w["jax"], w["port"]
    assert [g.name for g in rg] == [g.name for g in pg] and len(pg) == 24
    for name in ("free", "capacity", "schedulable", "node_domain_id"):
        np.testing.assert_array_equal(np.asarray(getattr(ps, name)),
                                      np.asarray(getattr(rs, name)), err_msg=name)
    for f in rb._fields:
        a, b = getattr(rb, f), getattr(pb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f)
    cpu = np.asarray(ps.free, np.float32)[:len(ps.node_names), 0]
    assert not np.all((cpu * 4) % 1 == 0)

    def total(xs):
        acc = np.float32(0)
        for x in xs:
            acc = np.float32(acc + x)
        return acc

    racks = [cpu[i:i + 20] for i in range(0, cpu.shape[0], 20)]
    assert any(total(r) != total(r[::-1]) for r in racks) or total(cpu) != total(cpu[::-1])


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_solve_on_a_non_dyadic_fleet_equals_jax(shards, pruned, virtual8):
    """B7's plain version at S shards == JAX's sharded solve on the same
    layout, and == the port's unsharded solve."""
    w = world()
    (rg, rs, rb), (_, ps, pb) = w["jax"], w["port"]
    n = int(rs.free.shape[0])
    okg = np.zeros(len(rg), bool)
    rkw = {"pruning": RPruning(**PRUNED)} if pruned else {}
    pkw = {"pruning": PPruning(**PRUNED)} if pruned else {}
    want = arrays(r_solve(rs, rb, rc.SolverParams(), ok_global=okg,
                          mesh=jax_layout(shards, n), **rkw))
    wp = PWarm()
    got = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=wp,
                         mesh=p_mesh.solve_layout_for(n, virtual8[:shards]), **pkw))
    if pruned:
        assert wp.prune.pruned_solves == 1
        base = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=PWarm(),
                              mesh_axis=shards, **pkw))
    else:
        base = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=PWarm()))
    assert int(want["ok"].sum()) > 0
    assert_same(got, want, f"non-dyadic S={shards} pruned={pruned} vs JAX")
    assert_same(got, base, f"non-dyadic S={shards} pruned={pruned} vs unsharded")


def test_portfolio_mesh_on_a_non_dyadic_fleet_equals_jax(monkeypatch):
    """B5 x B7 at (4, 2): portfolio_solve's winner and portfolio_solve_batch's
    winner and objectives == JAX's under its auto mesh."""
    calls = []
    orig = pc.sharded_stacked_solve_ref

    def spy(*a, **kw):
        calls.append(len(a[-1]))
        return orig(*a, **kw)

    monkeypatch.setattr(pc, "sharded_stacked_solve_ref", spy)
    w = world()
    (rg, rs, rb), (_, ps, pb) = w["jax"], w["port"]
    pb = pc.GangBatch(*(None if x is None else np.asarray(x) for x in pb))
    n = int(rs.free.shape[0])
    okg = np.random.default_rng(3).random(len(rg)) < 0.3
    args = jarrays(rs, rb)
    mesh = r_mesh.solver_mesh_for(4, n)
    assert (int(mesh.shape["portfolio"]), int(mesh.shape["node"])) == (4, 2)
    want = rpf.portfolio_solve(*args, rc.SolverParams(), 4, jnp.asarray(okg))
    stack = rpf.params_population(4)
    bbest, bwin, bobj = rpf.portfolio_solve_batch(*rpf.shard_solver_inputs(mesh, *args, stack))
    layout = p_mesh.solver_mesh_for(4, n, "cpu")
    assert (layout.portfolio_devices, layout.node_devices) == (4, 2)
    got = ppf.portfolio_solve(*parrays(ps), pb, pc.SolverParams(), 4, torch.as_tensor(okg),
                              device="cpu", mesh=layout)
    assert_exact(want, got)
    pbest, pwin, pobj = ppf.portfolio_solve_batch(*parrays(ps), pb, ppf.params_population(4),
                                                  device="cpu", mesh=layout)
    assert_exact(bbest, pbest)
    assert int(pwin) == int(bwin)
    assert pobj.numpy().tobytes() == np.asarray(bobj).tobytes()
    assert calls == [2, 2]


def test_scan_under_a_layout_on_a_non_dyadic_fleet_equals_jax(monkeypatch):
    """B4 x B7 at S = 4: a scan drain in waves of 8 under a 4-device layout,
    bindings, scores and ledger == JAX's, bindings and free capacity after
    == the port's unsharded scan drain."""
    calls = []
    orig = pc.sharded_scan_solve_ref

    def spy(*a, **kw):
        calls.append(len(a[-1]))
        return orig(*a, **kw)

    monkeypatch.setattr(pc, "sharded_scan_solve_ref", spy)
    (rg, rpods, rs), (pg, ppods, ps) = nondyadic(REF), nondyadic(PORT)
    kw = dict(wave_size=8, harvest="scan")
    r = r_drain(rg, rpods, rs, warm_path=RWarm(), **kw,
                mesh=r_mesh.MeshConfig(enabled=True, min_nodes=16, max_devices=4))
    p = p_drain(pg, ppods, ps, device="cpu", warm_path=PWarm(), **kw,
                mesh=p_mesh.MeshConfig(enabled=True, min_nodes=16, max_devices=4))
    base = p_drain(pg, ppods, ps, device="cpu", warm_path=PWarm(), **kw)
    same_drain(r, p, base)
    assert p[1].shard_devices == 4 and calls and set(calls) == {4}


# ---- the kernel source in host emulation (each shard a thread) ---------------------


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_kernel_source_sharded_on_a_non_dyadic_fleet_equals_plain(host_sharded, shards, pruned):
    """B7's source == sharded_solve_ref on the fleet, walks staged in chunks."""
    _, _, snap, batch = port_case()
    plan = plan_candidates(snap, batch, PPruning(**PRUNED), mesh_axis=shards) if pruned else None
    want = _emulated_vs_plain(host_sharded, snap, batch, shards, plan=plan, plane_words=64)
    assert bool(want[1].any())


def port_case():
    gangs, pods, snap = nondyadic(PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap,
                                 global_index_of={g.name: i for i, g in enumerate(gangs)})
    return gangs, pods, snap, batch


def test_kernel_source_stacked_sharded_on_a_non_dyadic_fleet_equals_plain(lib):
    """B5 x B7's source at (4, 2), then the select: every row and the
    winner == the plain versions."""
    gangs, _, snap, batch = port_case()
    tb = batch_to(batch, "cpu")
    free, cap, sched, ndid = node_state(snap)
    okg = torch.as_tensor(np.random.default_rng(5).random(len(gangs)) < 0.3)
    pstack = torch.as_tensor(np.array(ppf.params_population(4)))
    plain = ref.sharded_stacked_solve_ref(free, cap, sched, ndid, tb, pstack, okg,
                                          spans_of(cap.shape[0], 2))
    want = ref.portfolio_select_ref(*plain, tb, okg.clone())
    got_free, got_okg = free.clone(), okg.clone()
    args, smem, out, _keep = pwm.build_args(
        got_free, cap, sched, ndid, tb, None, got_okg, pwm.domain_index_sharded(ndid, 2, "cpu"),
        params_stack=pstack, select=True, shards=2, plane_words=64)
    assert lib.place_wave_stacked_sharded_launch(ctypes.byref(args), None, smem, 1) == 0
    assert_equal(OUT, (out["assigned"][:, 0], out["ok"][:, 0], out["score"][:, 0],
                       out["free_after"]), plain, "non-dyadic (4, 2) rows")
    assert_equal(("assigned", "ok", "score", "free", "ok_global", "winner", "objectives"),
                 (out["win_assigned"], out["win_ok"], out["win_score"], got_free, got_okg,
                  out["winner"], out["objectives"]), want, "non-dyadic (4, 2) select")


def test_kernel_source_scan_sharded_on_a_non_dyadic_fleet_equals_plain(lib):
    """B4 x B7's source at S = 4 over three steps with the carries retained
    == sharded_scan_solve_ref."""
    gangs, pods, snap, batch = port_case()
    sb = batch_to(stack_batches(chunk(gangs, pods, snap, batch, 3), pad_to=4), "cpu")
    free, cap, sched, ndid = node_state(snap)
    okg = torch.zeros(len(gangs), dtype=torch.bool)
    want = ref.sharded_scan_solve_ref(free, cap, sched, ndid, sb, pc.SolverParams(), okg, True,
                                      spans_of(cap.shape[0], 4))
    got = launch_scan(lib, free, cap, sched, ndid, sb, okg,
                      pwm.domain_index_sharded(ndid, 4, "cpu"), 4)
    assert_equal(SCAN_OUT, got, want, "non-dyadic S=4")
    assert bool(want[1].any())
