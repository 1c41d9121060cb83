"""The port's solve_batch (plain PyTorch versions, device="cpu") against the
JAX package's solve_batch on the CPU: exactly equal (tolerance 0) on ok,
assigned, placement_score, free_after and ok_global, for both of the JAX
package's domain-sum paths (segment_sum with coarse_dmax=None, the one-hot
matmul with coarse_dmax set). The reference's own encoded batch reaches the
port through grove_tpu_torch.convert.from_reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.solver import core as rc
from grove_tpu_torch.convert import from_reference
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver import reference as pref
from test_torch_host import REF, SCENARIOS, build_pair

FIELDS = ("assigned", "ok", "placement_score", "free_after", "ok_global")


def jax_solve(free, snap, batch, ok_global, coarse_dmax):
    jbatch = rc.GangBatch(*(None if x is None else jnp.asarray(x) for x in batch))
    return rc.solve_batch(
        jnp.asarray(free), jnp.asarray(snap.capacity), jnp.asarray(snap.schedulable),
        jnp.asarray(snap.node_domain_id), jbatch, rc.SolverParams(),
        None if ok_global is None else jnp.asarray(ok_global), coarse_dmax=coarse_dmax,
    )


def port_solve(free, snap, batch, ok_global):
    tensors = from_reference(
        free, snap.capacity, snap.schedulable, snap.node_domain_id,
        {f: (None if x is None else np.asarray(x)) for f, x in batch._asdict().items()},
        rc.SolverParams()._asdict(), device="cpu",
    )
    free_t, cap_t, sched_t, ndid_t, pbatch, params = tensors
    return pc.solve_batch(free_t, cap_t, sched_t, ndid_t, pbatch, params, ok_global, device="cpu")


def assert_exact(jres, pres):
    for f in FIELDS:
        a, b = getattr(jres, f), getattr(pres, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, f"{f}: {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{f}: {a.shape} != {b.shape}"
        diff = np.argwhere(a != b)
        assert diff.size == 0, f"{f} differs at {diff[:8].tolist()}"


def coarse_of(snap, mode):
    return None if mode == "segment" else int(snap.num_domains[:-1].max())


def solve_both(name, mode, encode_kw=None, ok_global=None):
    (rg, rp, rs), _ = build_pair(name)
    batch, _ = REF.encode_gangs(rg, rp, rs, **(encode_kw or {}))
    jres = jax_solve(rs.free, rs, batch, ok_global, coarse_of(rs, mode))
    pres = port_solve(rs.free, rs, batch, ok_global)
    return jres, pres, batch


MODES = ["segment", "matmul"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_solve_batch_exact(name, mode):
    jres, pres, _ = solve_both(name, mode)
    assert_exact(jres, pres)


@pytest.mark.parametrize("mode", MODES)
def test_solve_batch_exact_with_reuse_seed(mode):
    (rg, rp, rs), _ = build_pair("bench_small")
    reuse = {g.name: [3 * i % rs.capacity.shape[0], 7] for i, g in enumerate(rg[::3])}
    jres, pres, batch = solve_both("bench_small", mode, {"reuse_nodes_by_gang": reuse})
    assert batch.reuse_nodes is not None
    assert_exact(jres, pres)


def pinned_bench_small():
    """bench_small encoded by the JAX package with every other gang's groups
    already bound somewhere, so required pack-sets carry domain pins (the
    port's own encoder never pins)."""
    (rg, rp, rs), _ = build_pair("bench_small")
    n = rs.capacity.shape[0]
    bound = {
        g.name: {grp.name: [(5 * i + 3 * k) % n] for k, grp in enumerate(g.spec.pod_groups)}
        for i, g in enumerate(rg)
        if i % 2 == 0
    }
    batch, _ = REF.encode_gangs(rg, rp, rs, bound_nodes_by_group=bound)
    assert (np.asarray(batch.set_pinned) >= 0).any()
    return rg, rs, batch


@pytest.mark.parametrize("mode", MODES)
def test_solve_batch_exact_with_pins(mode):
    _, rs, batch = pinned_bench_small()
    jres = jax_solve(rs.free, rs, batch, None, coarse_of(rs, mode))
    pres = port_solve(rs.free, rs, batch, None)
    assert_exact(jres, pres)
    unpinned = batch._replace(set_pinned=np.full_like(np.asarray(batch.set_pinned), -1))
    free_res = jax_solve(rs.free, rs, unpinned, None, coarse_of(rs, mode))
    assert not np.array_equal(np.asarray(jres.assigned), np.asarray(free_res.assigned)), (
        "the pins moved no pod"
    )


@pytest.mark.parametrize("mode", MODES)
def test_solve_batch_exact_ok_global_chain(mode):
    """Two waves chained through free_after and ok_global: the second wave's
    scaled gangs resolve their base verdicts from the first wave's bitmap."""
    (rg, rp, rs), _ = build_pair("wl2")
    gidx = {g.name: i for i, g in enumerate(rg)}
    base = [g for g in rg if g.base_podgang_name is None]
    scaled = [g for g in rg if g.base_podgang_name is not None]
    assert base and scaled
    okg = np.zeros((len(rg),), dtype=bool)
    free = rs.free
    cd = coarse_of(rs, mode)
    for wave in (base, scaled):
        batch, _ = REF.encode_gangs(wave, rp, rs, global_index_of=gidx)
        jres = jax_solve(free, rs, batch, okg, cd)
        pres = port_solve(free, rs, batch, okg)
        assert_exact(jres, pres)
        free, okg = np.array(jres.free_after), np.array(jres.ok_global)
    assert (np.asarray(batch.depends_global) >= 0).any()
    assert okg.any()


def test_global_deps_fold_and_scatter():
    """B2 alone: fold ok_global into gang_valid, scatter-max the verdicts."""
    (rg, rp, rs), _ = build_pair("wl2")
    gidx = {g.name: i for i, g in enumerate(rg)}
    scaled = [g for g in rg if g.base_podgang_name is not None]
    batch, _ = REF.encode_gangs(scaled, rp, rs, global_index_of=gidx)
    rng = np.random.default_rng(3)
    okg = rng.random(len(rg)) < 0.5
    jb = rc.GangBatch(*(None if x is None else jnp.asarray(x) for x in batch))
    tb = pc.batch_to(batch, "cpu")
    want = np.asarray(rc._apply_global_deps(jb, jnp.asarray(okg)))
    got = pref.apply_global_deps_ref(tb, torch.as_tensor(okg)).numpy()
    assert np.array_equal(want, got)
    ok = rng.random(len(scaled)) < 0.5
    want = np.asarray(rc._scatter_global_ok(jb, jnp.asarray(ok), jnp.asarray(okg)))
    got = pref.scatter_global_ok_ref(tb, torch.as_tensor(ok), torch.as_tensor(okg)).numpy()
    assert np.array_equal(want, got)


def test_group_slots_exact():
    rng = np.random.default_rng(7)
    free = (rng.integers(0, 64, size=(40, 4)) * 0.25).astype(np.float32)
    req = (rng.integers(0, 5, size=(3, 4)) * 0.25).astype(np.float32)
    req[2] = 0.0  # zero-request group: SLOT_CAP
    want = np.asarray(rc._group_slots(jnp.asarray(free), jnp.asarray(req)))
    got = pref.group_slots_ref(torch.as_tensor(free), torch.as_tensor(req)).numpy()
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_solve_batch_requires_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (rg, rp, rs), _ = build_pair("mixed")
    batch, _ = REF.encode_gangs(rg, rp, rs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.solve_batch(rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, batch)
