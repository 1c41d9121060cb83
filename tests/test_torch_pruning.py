"""Candidate pruning in the port (grove_tpu_torch/solver/pruning.py, the
pruned solve and the pruned chained drain, plain PyTorch versions on the
CPU) against the JAX package's, on tests/test_pruning.py's fleets:

  - plan_candidates cuts byte-equal plans;
  - a pruned solve_batch equals the JAX pruned solve exactly (ok, assigned
    in fleet ordinals, placement_score, free_after), the JAX plan carried
    across through grove_tpu_torch.convert;
  - the pruned chained drain binds exactly what the JAX pruned drain binds,
    with the same escalation and round-trip ledger (dispatches,
    device_roundtrips), and admits the dense drain's set.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.solver import core as rc
from grove_tpu.solver import pruning as rp
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.warm import WarmPath
from grove_tpu_torch.convert import (
    from_reference,
    plan_from_reference,
    pruning_config_from_reference,
)
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver import reference as pref
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.state import pod_request_vector
from test_torch_host import PORT, REF, _contended, expand_all
from torch_jax_programs import _release_jax_programs  # noqa: F401

CFG = dict(enabled=True, max_candidates=60, min_fleet=16, min_pad=8)
BUDGET40 = dict(enabled=True, max_candidates=40, min_fleet=16, min_pad=8)
CLIPPED = dict(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)
CONTENDED = dict(enabled=True, max_candidates=48, min_fleet=16, min_pad=8)


def _setup(P, racks=2, n=(6, 4, 5), half_full=False):
    """tests/test_pruning.py `_setup` (one zone, one block); `half_full`
    fills half the fleet and cordons three nodes, as its first test does."""
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.synthetic_backlog(*n), topo)
    nodes = P.wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=racks)
    snap = P.build_snapshot(nodes, topo)
    if half_full:
        k = snap.capacity.shape[0]
        snap.allocated[: k // 2] = snap.capacity[: k // 2]
        snap.schedulable[k // 2 : k // 2 + 3] = False
    return gangs, pods, snap


FLEETS = {
    # (fleet factory, pruning config)
    "racks4": (lambda P: _setup(P, racks=4), CFG),
    "budget40": (lambda P: _setup(P, racks=4), BUDGET40),
    "half_full": (lambda P: _setup(P, racks=4, half_full=True), CFG),
    "clipped": (lambda P: _setup(P, racks=4), CLIPPED),
    "adopt": (lambda P: _setup(P, racks=2, n=(10, 10, 10)), CLIPPED),
    "contended": (_contended, CONTENDED),
    "too_small": (lambda P: _setup(P, racks=1), CFG),
}


def _plans(name):
    build, cfg = FLEETS[name]
    rg, rpods, rs = build(REF)
    pg, ppods, ps = build(PORT)
    rb, _ = REF.encode_gangs(rg, rpods, rs)
    pb, _ = PORT.encode_gangs(pg, ppods, ps)
    rplan = rp.plan_candidates(rs, rb, rp.PruningConfig(**cfg))
    pplan = pp.plan_candidates(ps, pb, pp.PruningConfig(**cfg))
    return rs, rb, rplan, pplan


PLAN_FIELDS = ("idx", "gang_lossy", "capacity", "schedulable", "node_domain_id", "num_domains")


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_plan_candidates_byte_equal(name):
    _, _, rplan, pplan = _plans(name)
    if name == "too_small":
        assert rplan is None and pplan is None
        return
    assert rplan is not None and pplan is not None
    for f in ("count", "pad", "fleet_pad", "clipped"):
        assert getattr(rplan, f) == getattr(pplan, f), f
    for f in PLAN_FIELDS:
        a, b = getattr(rplan, f), getattr(pplan, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert rplan._remap == pplan._remap
    assert np.array_equal(rplan._padded_idx(), pplan.padded_idx())
    if name in ("clipped", "adopt"):
        assert pplan.clipped and pplan.gang_lossy.any()


def test_candidate_pad_ladder_matches_reference():
    for count, cfg in [
        (10, dict(min_pad=8)), (15, dict(min_pad=8)), (16, dict(min_pad=8)),
        (3, dict(min_pad=64)), (100, dict(min_pad=32)),
        (300, dict(min_pad=256)), (511, dict(min_pad=512)), (8191, {}),
    ]:
        assert pp.candidate_pad(count, pp.PruningConfig(**cfg)) == rp.candidate_pad(
            count, rp.PruningConfig(**cfg)
        )


def _jax_pruned_solve(rs, rb, rplan, coarse):
    free = np.asarray(rs.free, np.float32)
    jb = rplan.gather_batch(rb)
    res = rc.solve_batch(
        jnp.asarray(rplan.gather_free(free)), jnp.asarray(rplan.capacity),
        jnp.asarray(rplan.schedulable), jnp.asarray(rplan.node_domain_id),
        rc.GangBatch(*(None if x is None else jnp.asarray(x) for x in jb)), rc.SolverParams(),
        coarse_dmax=None if coarse is None else int(rplan.num_domains[:-1].max()),
    )
    return (
        rplan.remap_assigned(np.asarray(res.assigned)),
        np.asarray(res.ok),
        np.asarray(res.placement_score),
        rplan.scatter_free(free, np.asarray(res.free_after)),
    )


@pytest.mark.parametrize("mode", ["segment", "matmul"])
@pytest.mark.parametrize("name", ["half_full", "clipped", "adopt", "contended"])
def test_pruned_solve_equals_jax_pruned_solve(name, mode):
    rs, rb, rplan, _ = _plans(name)
    want = _jax_pruned_solve(rs, rb, rplan, None if mode == "segment" else mode)
    plan = plan_from_reference(vars(rplan))
    batch_np = {f: None if x is None else np.asarray(x) for f, x in rb._asdict().items()}
    free, cap, sched, ndid, batch, params = from_reference(
        rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, batch_np,
        rc.SolverParams()._asdict(), device="cpu",
    )
    got = pc.solve_batch(free, cap, sched, ndid, batch, params, plan=plan, device="cpu")
    for f, a, b in zip(("assigned", "ok", "placement_score", "free_after"), want, got):
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f"{f} differs at {np.argwhere(a != b)[:8].tolist()}"
    assert want[1].any()


def test_b3_plain_versions_equal_reference_plan_ops():
    rs, _, rplan, pplan = _plans("half_full")
    rng = np.random.default_rng(4)
    free = np.asarray(rs.free, np.float32)
    cand_idx = torch.as_tensor(pplan.padded_idx())
    got = pref.gather_free_ref(torch.as_tensor(free), cand_idx).numpy()
    assert np.array_equal(got, rplan.gather_free(free))
    assert not got[pplan.count :].any()
    new = (rng.random((pplan.pad, free.shape[1])) * 8).astype(np.float32)
    got = pref.scatter_free_ref(torch.as_tensor(free), torch.as_tensor(new), cand_idx).numpy()
    assert np.array_equal(got, rplan.scatter_free(free, new))
    assigned = rng.integers(-1, pplan.count, size=(9, 16)).astype(np.int32)
    got = pref.remap_assigned_ref(torch.as_tensor(assigned), cand_idx, pplan.count).numpy()
    want = rplan.remap_assigned(assigned)
    assert np.array_equal(got, want)


def test_convert_carries_the_pruning_config():
    cfg = rp.PruningConfig(enabled=True, max_candidates=40, min_pad=16, min_fleet=32)
    assert pruning_config_from_reference(dataclasses.asdict(cfg)) == pp.PruningConfig(
        enabled=True, max_candidates=40, min_pad=16, min_fleet=32
    )
    with pytest.raises(ValueError, match="unknown PruningConfig"):
        pruning_config_from_reference({"bogus": 1})
    # The pad ladder carries over (replay builds its config from a journal's
    # recorded padLadder).
    assert pruning_config_from_reference(
        dataclasses.asdict(rp.PruningConfig(enabled=True, pad_ladder=(64, 128)))
    ) == pp.PruningConfig(enabled=True, pad_ladder=(64, 128))


def _drains(name, wave_size=8):
    build, cfg = FLEETS[name]
    rg, rpods, rs = build(REF)
    pg, ppods, ps = build(PORT)
    rbind, rstats = r_drain(
        rg, rpods, rs, wave_size=wave_size, warm_path=WarmPath(),
        pruning=rp.PruningConfig(**cfg), harvest="chained",
    )
    pbind, pstats = p_drain(
        pg, ppods, ps, wave_size=wave_size, pruning=pp.PruningConfig(**cfg), device="cpu"
    )
    dbind, dstats = p_drain(pg, ppods, ps, wave_size=wave_size, device="cpu")
    return (rbind, rstats), (pbind, pstats), (dbind, dstats)


@pytest.mark.parametrize("name", ["budget40", "adopt"])
def test_pruned_drain_equals_jax_pruned_drain(name):
    """tests/test_pruning.py:196 (every wave prunes, nothing escalates) and
    :210 (a clipped budget strands gangs: escalations confirm and adopt)."""
    (rbind, rstats), (pbind, pstats), (dbind, dstats) = _drains(name)
    assert pbind == rbind and list(pbind) == list(rbind)
    for f in ("escalations", "escalations_adopted", "pruned_waves", "candidate_nodes",
              "candidate_pad", "admitted", "pods_bound", "waves", "dispatches",
              "device_roundtrips"):
        assert getattr(pstats, f) == getattr(rstats, f), f
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    assert set(pbind) == set(dbind) and pstats.admitted == dstats.admitted
    assert pstats.pruned_waves > 0
    if name == "adopt":
        assert pstats.escalations >= 1 and pstats.escalations_adopted >= 1
        assert pstats.device_roundtrips > 1 + pstats.escalations
    else:
        assert pstats.escalations == 0 and pstats.device_roundtrips == 1
    # The carry left behind equals the snapshot minus every bound pod.
    _, ppods, ps = FLEETS[name][0](PORT)
    free = ps.free.astype(np.float32)
    for pods in pbind.values():
        for pod, node in pods.items():
            i = ps.node_index(node)
            free[i] = free[i] - pod_request_vector(ppods[pod], ps.resource_names)
    assert np.array_equal(pstats.free_after, free)
    assert (free >= 0).all()


def test_disabled_pruning_is_the_dense_drain():
    build, _ = FLEETS["racks4"]
    pg, ppods, ps = build(PORT)
    a, sa = p_drain(pg, ppods, ps, wave_size=8, device="cpu",
                    pruning=pp.PruningConfig(enabled=False))
    b, sb = p_drain(pg, ppods, ps, wave_size=8, device="cpu")
    assert a == b and sa.pruned_waves == 0 and np.array_equal(sa.free_after, sb.free_after)
