"""The port's portfolio path (plain PyTorch versions, device="cpu") against
the JAX package's on the CPU, tolerance 0: the weight population, the
objective and its quality sum, the stacked solve, the portfolio's winner,
the tuning step, the serving solve with a portfolio and with portfolio
escalation, the portfolio drain, and the greedy baseline, fragmentation and
placement-quality reports the bench line reads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.parallel import portfolio as rpf
from grove_tpu.quality.report import evaluate_placement as r_evaluate
from grove_tpu.solver import core as rc
from grove_tpu.solver.defrag import fragmentation_report as r_fragmentation
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.greedy import greedy_drain as r_greedy
from grove_tpu_torch.convert import params_stack_from_reference
from grove_tpu_torch.parallel import portfolio as ppf
from grove_tpu_torch.quality.report import evaluate_placement as p_evaluate
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver.defrag import fragmentation_report as p_fragmentation
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.greedy import greedy_drain as p_greedy
from grove_tpu_torch.solver.reference import xla_sum_ref
from grove_tpu_torch.state import pod_request_vector
from test_torch_host import PORT, REF, _bench, _contended, build_pair
from test_torch_solver import assert_exact
from torch_jax_programs import _release_jax_programs  # noqa: F401

BASE = rc.SolverParams(w_tight=1.5, w_pref=3.0, w_reuse=2.5, w_reserve=6.0, w_spread=1.25)


def _port_params(p):
    return pc.SolverParams(*(float(x) for x in p))


def _jarrays(snap, batch):
    return (jnp.asarray(snap.free), jnp.asarray(snap.capacity), jnp.asarray(snap.schedulable),
            jnp.asarray(snap.node_domain_id),
            rc.GangBatch(*(None if x is None else jnp.asarray(x) for x in batch)))


def _coarse(snap, mode):
    return None if mode == "segment" else int(snap.num_domains[:-1].max())


def _jax_stack(stack):
    return np.stack([np.asarray(x) for x in stack], axis=1)


# ---- the population and the objective ----------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("base", ["default", "custom"])
def test_population_and_mutations_are_byte_equal(p, base):
    rbase = rc.SolverParams() if base == "default" else BASE
    want = _jax_stack(rpf.params_population(p, base=rbase))
    got = ppf.params_population(p, base=_port_params(rbase))
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert got is ppf.params_population(p, base=_port_params(rbase)), "the memo"
    assert ppf._mutation_factors(p).tobytes() == rpf._mutation_factors(p).tobytes()
    assert ppf._mutation_factors(p, seed=3).tobytes() == rpf._mutation_factors(p, seed=3).tobytes()
    assert np.array_equal(got[0], np.asarray(list(rbase), np.float32)), "slot 0 is the base"
    assert (got[1::2, 0] < 0).all(), "odd slots are worst-fit"
    stack = params_stack_from_reference(rpf.params_population(p, base=rbase)._asdict(), "cpu")
    assert stack.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("g", [8, 32, 48, 64, 100, 256])
def test_objective_equals_jax(g):
    """Admitted count and quality sum, row by row, as the JAX package
    computes them for a portfolio (vmapped in one jitted program); the
    quality sum's order shows in its last bits for most rows."""
    rng = np.random.default_rng(g)
    rows = 40
    ok = rng.random((rows, g)) < 0.8
    score = (0.5 + 0.5 * rng.random((rows, g))).astype(np.float32)
    res = rc.SolveResult(assigned=jnp.zeros((rows, g, 1), jnp.int32), ok=jnp.asarray(ok),
                         placement_score=jnp.asarray(score), free_after=jnp.zeros((rows, 1, 1)))
    want_adm, want_q = jax.jit(jax.vmap(rpf._objective))(res)
    seq_differs = 0
    for k in range(rows):
        adm, q = ppf._objective(torch.as_tensor(ok[k]), torch.as_tensor(score[k]))
        assert adm.dtype == torch.int32 and int(adm) == int(want_adm[k])
        assert q.dtype == torch.float32 and q.numpy().tobytes() == np.asarray(want_q[k]).tobytes()
        seq = np.float32(0)
        for x in np.where(ok[k], score[k], 0).astype(np.float32):
            seq = np.float32(seq + x)
        seq_differs += seq != want_q[k]
    if g > 32:
        assert seq_differs > 0, "no row tells XLA's order from index order"


@pytest.mark.parametrize("sizes", ["1-79", "wide"])
def test_xla_sum_recurses_over_windows(sizes):
    """The plain sum equals XLA's for every n up to 79 — odd padding (n =
    33: 15 zeros in front, 16 behind) included — and for wide sums past 32
    windows (n = 1100: 35 windows, then 2)."""
    ns = range(1, 80) if sizes == "1-79" else (96, 127, 200, 300, 513, 1024, 1100)
    for n in ns:
        x = np.random.default_rng(n).random(n).astype(np.float32)
        want = jax.jit(jnp.sum)(jnp.asarray(x))
        got = xla_sum_ref(torch.as_tensor(x))
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), n


# ---- stacked solve and portfolio winner --------------------------------------

STACKED = [(name, 2, "segment") for name in ("bench_small", "contended", "binpack_trap",
                                             "bench_spread", "nondyadic")]
STACKED += [(name, 4, "matmul") for name in ("bench_small", "binpack_trap", "spread_pack",
                                             "nondyadic")]


@pytest.mark.parametrize("name, k, mode", STACKED)
def test_stacked_solve_equals_jax(name, k, mode):
    """Every row of the stacked solve (odd rows worst-fit) equals the JAX
    stacked solve's, on both of its domain-sum paths."""
    (rg, rp, rs), _ = build_pair(name)
    batch, _ = REF.encode_gangs(rg, rp, rs)
    stack = rpf.params_population(k)
    jres = rc.stacked_solve_batch(*_jarrays(rs, batch), stack, coarse_dmax=_coarse(rs, mode))
    pbatch = pc.GangBatch(*(None if x is None else np.asarray(x) for x in batch))
    pres = pc.stacked_solve_batch(rs.free, rs.capacity, rs.schedulable, rs.node_domain_id,
                                  pbatch, ppf.params_population(k), device="cpu")
    assert pres.ok_global is None
    assert_exact(jres, pres)


@pytest.mark.parametrize("name", ["binpack_trap", "contended"])
def test_portfolio_solve_batch_and_tune_step_equal_jax(name):
    (rg, rp, rs), _ = build_pair(name)
    gidx = {g.name: i for i, g in enumerate(rg)}
    batch, _ = REF.encode_gangs(rg, rp, rs, global_index_of=gidx)
    stack = rpf.params_population(4)
    okg = np.random.default_rng(1).random(len(rg)) < 0.5
    jbest, jwin, jobj = rpf.portfolio_solve_batch(*_jarrays(rs, batch), stack, jnp.asarray(okg))
    pbatch = pc.GangBatch(*(None if x is None else np.asarray(x) for x in batch))
    args = (rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, pbatch)
    pbest, pwin, pobj = ppf.portfolio_solve_batch(*args, ppf.params_population(4), okg,
                                                  device="cpu")
    assert_exact(jbest, pbest)
    assert int(pwin) == int(jwin) and pwin.dtype == torch.int32
    assert pobj.numpy().tobytes() == np.asarray(jobj).tobytes()
    jbest, jnext, jobj = rpf.tune_solve_step(*_jarrays(rs, batch), stack)
    pbest, pnext, pobj = ppf.tune_solve_step(*args, ppf.params_population(4), device="cpu")
    assert_exact(jbest, pbest)
    assert pnext.numpy().tobytes() == _jax_stack(jnext).tobytes()
    assert pobj.numpy().tobytes() == np.asarray(jobj).tobytes()


# ---- the serving solve ---------------------------------------------------------


def _solve_pair(name, build=None, **kw):
    (rg, rp, rs), (pg, pp, ps) = (build(REF), build(PORT)) if build else build_pair(name)
    rbatch, _ = REF.encode_gangs(rg, rp, rs)
    pbatch, _ = PORT.encode_gangs(pg, pp, ps)
    jres = rc.solve(rs, rbatch, rc.SolverParams(), **kw)
    pres = pc.solve(ps, pbatch, pc.SolverParams(), device="cpu", **kw)
    assert_exact(jres, pres)
    return int(np.asarray(jres.ok).sum()), int(np.asarray(rbatch.gang_valid).sum())


def test_portfolio_solve_admits_the_binpack_trap():
    base, valid = _solve_pair("binpack_trap")
    assert base < valid, "the trap strands no gang under the base weights"
    for p in (2, 8):
        assert _solve_pair("binpack_trap", portfolio=p) == (valid, valid)


@pytest.mark.parametrize("scenario", ["binpack_trap", "contended24", "contended48"])
def test_escalated_solve_equals_jax(scenario):
    build = None
    if scenario.startswith("contended"):
        build = lambda P: _contended(P, n_gangs=int(scenario[-2:]))  # noqa: E731
    admitted, valid = _solve_pair(scenario, build, escalate_portfolio=4)
    if scenario == "binpack_trap":
        assert admitted == valid


def test_escalated_solve_threads_ok_global():
    """Scaled gangs gated by a cross-wave bitmap: a gang whose base failed
    is not a valid rejection, and the escalated winner scatters its
    verdicts into the bitmap."""
    (rg, rp, rs), (pg, pp, ps) = build_pair("wl2")
    gidx = {g.name: i for i, g in enumerate(rg)}
    okg = np.random.default_rng(4).random(len(rg)) < 0.5
    scaled = [[g for g in gangs if g.base_podgang_name is not None] for gangs in (rg, pg)]
    for portfolio, esc in ((1, 4), (2, 1)):
        rbatch, _ = REF.encode_gangs(scaled[0], rp, rs, global_index_of=gidx)
        pbatch, _ = PORT.encode_gangs(scaled[1], pp, ps, global_index_of=gidx)
        jres = rc.solve(rs, rbatch, rc.SolverParams(), ok_global=jnp.asarray(okg),
                        portfolio=portfolio, escalate_portfolio=esc)
        okg_t = torch.as_tensor(okg)
        pres = pc.solve(ps, pbatch, pc.SolverParams(), ok_global=okg_t, portfolio=portfolio,
                        escalate_portfolio=esc, device="cpu")
        assert torch.equal(okg_t, torch.as_tensor(okg)), "solve changed the caller's bitmap"
        assert_exact(jres, pres)
    assert (np.asarray(rbatch.depends_global) >= 0).any()


# ---- the portfolio drain --------------------------------------------------------


def test_portfolio_drain_equals_jax():
    """At the small bench scale (320 nodes): bindings, scores and the carry
    equal the JAX portfolio drain's."""
    build = lambda P: _bench(P, racks_per_block=1, n=(18, 12, 15))  # noqa: E731
    rg, rp, rs = build(REF)
    pg, pp, ps = build(PORT)
    rb, rstats = r_drain(rg, rp, rs, wave_size=64, harvest="chained", portfolio=4)
    pb, pstats = p_drain(pg, pp, ps, wave_size=64, portfolio=4, device="cpu")
    assert pb == rb and list(pb) == list(rb)
    assert (pstats.admitted, pstats.pods_bound, pstats.waves, pstats.portfolio) == (
        rstats.admitted, rstats.pods_bound, rstats.waves, 4)
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    single, _ = p_drain(pg, pp, ps, wave_size=64, device="cpu")
    assert set(single) == set(pb) and pstats.admitted == len(pg)
    # The carry the winners leave equals the snapshot minus every bound pod.
    free = ps.free.astype(np.float32)
    for pods in pb.values():
        for pod, node in pods.items():
            i = ps.node_index(node)
            free[i] = free[i] - pod_request_vector(pp[pod], ps.resource_names)
    assert np.array_equal(pstats.free_after, free)


# ---- the bench line's yardsticks ----------------------------------------------------


@pytest.mark.parametrize("name", ["simple1", "wl2", "bench_small", "contended", "mixed", "selector"])
def test_greedy_drain_equals_jax(name):
    (rg, rp, rs), (pg, pp, ps) = build_pair(name)
    r, p = r_greedy(rg, rp, rs), p_greedy(pg, pp, ps)
    assert (p.admitted, p.rejected, p.pods_bound, p.scores, p.bindings) == (
        r.admitted, r.rejected, r.pods_bound, r.scores, r.bindings)


@pytest.mark.parametrize("name", ["simple1", "bench_small", "contended", "mixed"])
def test_fragmentation_and_placement_reports_equal_jax(name):
    (rg, rp, rs), (pg, pp, ps) = build_pair(name)
    assert p_fragmentation(ps).to_doc() == r_fragmentation(rs).to_doc()
    assert p_fragmentation(ps, ("cpu",)).to_doc() == r_fragmentation(rs, ("cpu",)).to_doc()
    plans = {"greedy": r_greedy(rg, rp, rs).bindings}
    batch, decode = REF.encode_gangs(rg, rp, rs)
    plans["solver"] = rc.decode_assignments(rc.solve(rs, batch), decode, rs)
    for label, bindings in plans.items():
        want = r_evaluate(rg, rp, rs, bindings)
        got = p_evaluate(pg, pp, ps, bindings)
        assert vars(got) == vars(want), label
