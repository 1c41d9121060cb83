"""The portfolio mesh (parallel/mesh.py `solver_mesh_for`;
parallel/portfolio.py `portfolio_solve` and `portfolio_solve_batch` under
a mesh) against the JAX package's on the suite's 8 virtual CPU devices
(tests/conftest.py); the port runs on 8 virtual devices of the CPU
(`force_virtual_devices`), its sharded portfolio the plain version of
B5 x B7 (`sharded_stacked_solve_ref` and the select).

  - negotiation: solver_mesh_for over 1-8 devices and P in
    {1, 2, 3, 4, 8, 16}, the fallback ledger's moves;
  - solves: portfolio_solve under the mesh solver_mesh_for negotiates at
    P = 2, 4, 8 ((2, 4), (4, 2), (8, 1)) against JAX's auto mesh,
    portfolio_solve_batch under that mesh and tune_solve_step against
    JAX's on the mesh's sharded inputs (winner, objectives, next
    generation), each exactly equal to JAX and to the port's unsharded
    portfolio;
  - solve(portfolio=4, mesh=layout) and an escalation under a layout;
  - a portfolio=4 drain;
  - the sidecar's contended Solve, whose escalation reaches the portfolio
    mesh through solve();
  - devices the portfolio cannot shard over (distinct cards, virtual
    devices of another device): solve(portfolio=4), an escalation and a
    portfolio drain solve unsharded and equal the unsharded port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.parallel import mesh as r_mesh
from grove_tpu.parallel import portfolio as rpf
from grove_tpu.solver import core as rc
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu_torch.parallel import mesh as p_mesh
from grove_tpu_torch.parallel import portfolio as ppf
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from test_torch_host import REF, build_pair
from test_torch_mesh import both, jax_layout
from test_torch_portfolio import _jax_stack
from test_torch_solver import assert_exact
from torch_jax_programs import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True)
def virtual8():
    assert len(jax.devices()) == 8
    p_mesh.force_virtual_devices(8, "cpu")
    yield p_mesh.mesh_devices()
    p_mesh.force_virtual_devices(0)


@pytest.fixture
def sharded_calls(monkeypatch):
    """Counts the plain B5 x B7 runs (the stacked solve over node shards)."""
    calls = []
    orig = pc.sharded_stacked_solve_ref

    def spy(*a, **kw):
        calls.append(len(a[-1]))  # the spans
        return orig(*a, **kw)

    monkeypatch.setattr(pc, "sharded_stacked_solve_ref", spy)
    return calls


def _shape(mesh):
    return None if mesh is None else (int(mesh.shape["portfolio"]), int(mesh.shape["node"]))


def _pshape(layout):
    return None if layout is None else (layout.portfolio_devices, layout.node_devices)


# ---- negotiation ---------------------------------------------------------------


@pytest.mark.parametrize("nd", range(1, 9))
def test_solver_mesh_for_equals_jax(nd):
    jd = jax.devices()[:nd]
    pd = p_mesh.force_virtual_devices(nd, "cpu")
    for p in (1, 2, 3, 4, 8, 16):
        for n in (1024, 160, 96, 13, 6, 7, 32):
            b0, p0 = r_mesh.shard_fallbacks(), p_mesh.shard_fallbacks()
            want = _shape(r_mesh.solver_mesh_for(p, n, jd))
            got = p_mesh.solver_mesh_for(p, n, "cpu")
            assert _pshape(got) == want, (nd, p, n)
            assert p_mesh.shard_fallbacks() - p0 == r_mesh.shard_fallbacks() - b0, (nd, p, n)
            if got is not None:
                assert got.fingerprint() == {"portfolio": want[0], "node": want[1]}
                assert [d.id for d in got.mesh.flat] == [d.id for d in pd]


# ---- solves ------------------------------------------------------------------------


_JAX: dict = {}


def pair(name):
    """(JAX (gangs, snapshot, batch), port (snapshot, batch as numpy)) of a
    scenario: the mesh module's quality and synthetic worlds, the host
    module's contended and bin-packing trap."""
    if name in ("quality", "synthetic"):
        w = both(name)
        (rg, _, rs, rb), (_, _, ps, pb) = w["jax"], w["port"]
    else:
        (rg, rp, rs), (_, _, ps) = build_pair(name)
        rb, _ = REF.encode_gangs(rg, rp, rs, global_index_of={g.name: i for i, g in enumerate(rg)})
        pb = rb
    pb = pc.GangBatch(*(None if x is None else np.asarray(x) for x in pb))
    return (rg, rs, rb), (ps, pb)


def jarrays(rs, rb):
    return (jnp.asarray(rs.free), jnp.asarray(rs.capacity), jnp.asarray(rs.schedulable),
            jnp.asarray(rs.node_domain_id),
            rc.GangBatch(*(None if x is None else jnp.asarray(x) for x in rb)))


def parrays(ps):
    return (ps.free, ps.capacity, ps.schedulable, ps.node_domain_id)


def jax_portfolio(name, p):
    """The JAX package's portfolio_solve (its auto mesh) and, on that mesh's
    sharded inputs, portfolio_solve_batch and tune_solve_step: computed
    once per module."""
    key = (name, p)
    if key not in _JAX:
        (rg, rs, rb), _ = pair(name)
        okg = np.random.default_rng(2).random(len(rg)) < 0.4
        args = jarrays(rs, rb)
        stack = rpf.params_population(p)
        best = rpf.portfolio_solve(*args, rc.SolverParams(), p, jnp.asarray(okg))
        mesh = r_mesh.solver_mesh_for(p, int(rs.free.shape[0]))
        _JAX[key] = dict(okg=okg, mesh=_shape(mesh), best=best)
        if mesh is not None:
            sharded = rpf.shard_solver_inputs(mesh, *args, stack)
            bbest, bwin, bobj = rpf.portfolio_solve_batch(*sharded)
            tbest, tnext, tobj = rpf.tune_solve_step(*sharded)
            _JAX[key].update(batch=(bbest, int(bwin), np.asarray(bobj)),
                             tune=(tbest, _jax_stack(tnext), np.asarray(tobj)))
    return _JAX[key]


@pytest.mark.parametrize("name,p,mesh", [
    (name, p, mesh) for name in ("quality", "binpack_trap")
    for p, mesh in ((2, (2, 4)), (4, (4, 2)), (8, (8, 1)))] + [("contended", 4, (4, 2))])
def test_portfolio_solve_under_its_mesh_equals_jax_and_unsharded(name, p, mesh, sharded_calls):
    """Under the mesh solver_mesh_for negotiates (the JAX package's auto
    mesh) portfolio_solve's winner equals JAX's and the port's unsharded
    portfolio; portfolio_solve_batch under that mesh, and tune_solve_step,
    equal JAX's on the mesh's sharded inputs: winner, objectives and next
    generation (B5 x B7 where the node axis is over 1, the plain B5 at
    (8, 1))."""
    want = jax_portfolio(name, p)
    _, (ps, pb) = pair(name)
    n = int(ps.free.shape[0])
    layout = p_mesh.solver_mesh_for(p, n, "cpu")
    assert _pshape(layout) == want["mesh"]
    if name != "binpack_trap":  # 6 nodes: no split of 8 devices under P = 2
        assert want["mesh"] == mesh
    okg = torch.as_tensor(want["okg"])
    got = ppf.portfolio_solve(*parrays(ps), pb, pc.SolverParams(), p, okg.clone(), device="cpu",
                              mesh=layout)
    assert_exact(want["best"], got)
    base = ppf.portfolio_solve(*parrays(ps), pb, pc.SolverParams(), p, okg.clone(),
                               device="cpu")
    assert_exact(want["best"], base)
    if layout is None:
        return
    stack = ppf.params_population(p)
    bbest, bwin, bobj = ppf.portfolio_solve_batch(*parrays(ps), pb, stack, device="cpu",
                                                  mesh=layout)
    assert_exact(want["batch"][0], bbest)
    assert int(bwin) == want["batch"][1]
    assert bobj.numpy().tobytes() == want["batch"][2].tobytes()
    tbest, tnext, tobj = ppf.tune_solve_step(*parrays(ps), pb, stack, device="cpu")
    assert_exact(want["tune"][0], tbest)
    assert tnext.numpy().tobytes() == want["tune"][1].tobytes()
    assert tobj.numpy().tobytes() == want["tune"][2].tobytes()
    # portfolio_solve and portfolio_solve_batch under the mesh: B5 x B7 only
    # where the node axis splits.
    assert sharded_calls == ([layout.node_devices] * 2 if layout.node_devices > 1 else [])


@pytest.mark.parametrize("kw", [dict(portfolio=4), dict(escalate_portfolio=4)])
def test_solve_with_a_portfolio_under_a_layout_equals_jax(kw, sharded_calls):
    """solve(portfolio=4, mesh=layout) ignores the layout, as the JAX
    package's does, and solves under the portfolio's own (4, 2) mesh; an
    escalation under a layout re-solves there too. Both equal JAX."""
    (rg, rs, rb), (ps, pb) = pair("contended")
    n = int(rs.free.shape[0])
    want = rc.solve(rs, rb, rc.SolverParams(), mesh=jax_layout(8, n), **kw)
    got = pc.solve(ps, pb, device="cpu", warm=PWarm(), mesh=p_mesh.solve_layout_for(n), **kw)
    assert_exact(want, got)
    assert sharded_calls == [2]


def test_portfolio_drain_on_8_devices_equals_jax(sharded_calls):
    """A portfolio=4 drain: every wave under the (4, 2) mesh hoisted once
    per drain; bindings, scores and the ledger equal the JAX drain's (the
    unsharded portfolio drain's equality is tests/test_torch_portfolio.py's)."""
    from test_torch_mesh import drain_world

    rg, rp, rs = drain_world("jax")
    pg, pp, ps = drain_world("port")
    b0, p0 = r_mesh.shard_fallbacks(), p_mesh.shard_fallbacks()
    want, rstats = r_drain(rg, rp, rs, wave_size=16, harvest="chained", portfolio=4)
    got, pstats = p_drain(pg, pp, ps, wave_size=16, harvest="chained", portfolio=4,
                          device="cpu")
    assert got == want and list(got) == list(want)
    assert p_mesh.shard_fallbacks() - p0 == r_mesh.shard_fallbacks() - b0 == 0
    assert (pstats.waves, pstats.dispatches, pstats.shard_devices, pstats.shard_fallbacks) == (
        rstats.waves, rstats.dispatches, rstats.shard_devices, rstats.shard_fallbacks)
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    assert sharded_calls and set(sharded_calls) == {2} and len(sharded_calls) == pstats.waves


def test_sidecar_contended_solve_reaches_the_portfolio_mesh(sharded_calls):
    """The sidecar's Solve with portfolio escalation on 16 nodes, 8 devices:
    the escalated re-solve goes through solve() to the (4, 2) mesh, as the
    JAX sidecar's does, and the responses are equal."""
    from test_backend_hardening import _gang_spec
    from test_torch_backend import admitted, bench_twin

    t = bench_twin(nodes=16, portfolio_escalation=4)
    for i in range(9):
        t.sync(_gang_spec(f"j{i}", n_pods=2, cpu=12.0))
    resp = t.solve()
    assert len(admitted(resp)) == 8
    assert sharded_calls == [2]


# ---- devices the portfolio does not shard over -------------------------------------


def _distinct_cards():
    return [p_mesh.MeshDevice(torch.device("cuda", i), i) for i in range(2)]


def _virtual_of_another_device():
    return [p_mesh.MeshDevice(torch.device("cuda", 0), i, True) for i in range(4)]


@pytest.mark.parametrize("devices", [_distinct_cards, _virtual_of_another_device])
@pytest.mark.parametrize("path", ["portfolio", "escalation", "drain"])
def test_portfolio_off_its_own_device_solves_unsharded(path, devices, monkeypatch,
                                                       sharded_calls):
    """Where mesh_devices() lists two distinct cards, or virtual devices of
    a card while the solve runs on the CPU, solver_mesh_for gives no layout
    and counts no fallback: solve(portfolio=4), an escalation and a
    portfolio drain solve unsharded on the solve's device and equal the
    port on one device."""
    from test_torch_mesh import drain_world

    def run():
        if path == "drain":
            gangs, pods, snap = drain_world("port")
            return p_drain(gangs, pods, snap, wave_size=16, harvest="chained", portfolio=4,
                           device="cpu")[0]
        _, (ps, pb) = pair("contended")
        kw = dict(portfolio=4) if path == "portfolio" else dict(escalate_portfolio=4)
        return pc.solve(ps, pb, device="cpu", warm=PWarm(), **kw)

    p_mesh.force_virtual_devices(0)
    want = run()
    monkeypatch.setattr(p_mesh, "mesh_devices", devices)
    assert p_mesh.solver_mesh_for(4, 16, "cpu") is None
    p0 = p_mesh.shard_fallbacks()
    got = run()
    assert p_mesh.shard_fallbacks() == p0
    if path == "drain":
        assert got == want and list(got) == list(want)
    else:
        assert_exact(want, got)
    assert sharded_calls == []
