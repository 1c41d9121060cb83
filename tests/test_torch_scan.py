"""The scan (B4) and the five harvest disciplines of the port's drain
(plain PyTorch versions, device="cpu") against the JAX package:

  - scan_solve_ref / scan_pruned_solve_ref equal JAX scan_solve_fn /
    scan_pruned_solve_fn(retain=True) on a stacked chunk, tolerance 0, with
    a base gang in one step gating its scaled gang in the next (admitted and
    rejected) and a trailing null wave;
  - drain_backlog(harvest=m) binds exactly what the JAX drain binds, in the
    same order, with the same round-trip, scan and escalation ledger and
    the same per-wave admitted counts, for every m in HARVEST_MODES, dense
    (the 320-node bench at wave sizes 4 and 16, the contended fleet) and
    pruned (escalations that confirm, and adoptions re-chained mid-scan);
  - the fallbacks, the argument checks, latency_percentiles' edge cases and
    scan_config_from_reference;
  - B6's plain version, stacked_scan_solve_ref, equals JAX
    stacked_scan_solve_fn (the tuning sweep's run batcher) at tolerance 0,
    a trailing null wave included.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.solver import core as rc
from grove_tpu.solver import pruning as rp
from grove_tpu.solver.drain import DrainStats as RDrainStats
from grove_tpu.solver.drain import ScanConfig as RScanConfig
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.warm import WarmPath
from grove_tpu_torch.convert import from_reference, scan_config_from_reference
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver.core import batch_to
from grove_tpu_torch.solver.drain import HARVEST_MODES, DrainStats, ScanConfig
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.drain import plan_waves as p_plan
from grove_tpu_torch.solver.encode import stack_batches
from grove_tpu_torch.solver.core import stacked_scan_solve
from grove_tpu_torch.solver.reference import (
    scan_pruned_solve_ref,
    scan_solve_ref,
    stacked_scan_solve_ref,
)
from test_torch_host import PORT, REF, _bench, _contended, expand_all

LEDGER = ("admitted", "pods_bound", "waves", "dispatches", "device_roundtrips", "scan_chunks",
          "scanned_waves", "scan_rechains", "escalations", "escalations_adopted",
          "pruned_waves")
SCAN_FIELDS = ("assigned", "ok", "placement_score", "free_in", "okg_in", "free_after",
               "ok_global")


def bench_small(P):
    """synthetic_cluster(racks_per_block=1) = 320 nodes, the backlog at
    scale 0.05."""
    return _bench(P, racks_per_block=1, n=(18, 12, 15))


def adopt_fleet(P):
    """tests/test_scan.py:143-169: a clipped budget strands gangs the dense
    fleet would admit."""
    topo = P.wl.bench_topology()
    gangs, pods = expand_all(P, P.wl.synthetic_backlog(10, 10, 10), topo)
    nodes = P.wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2)
    return gangs, pods, P.build_snapshot(nodes, topo)


# ---- the plain scan against JAX's scan -----------------------------------------


def scan_chunk():
    """(snapshot, ref batches, gangs): three waves of the bench encoded to
    one shape — the base gangs whose scaled gangs come next, with every
    other one made invalid (its scaled gangs must be rejected across the
    step), then those scaled gangs — stacked before a null wave."""
    rg, rpods, rs = bench_small(REF)
    gidx = {g.name: i for i, g in enumerate(rg)}
    scaled = [g for g in rg if g.base_podgang_name is not None][:12]
    base_names = list(dict.fromkeys(g.base_podgang_name for g in scaled))
    bases = [g for g in rg if g.name in base_names]
    others = [g for g in rg if g.base_podgang_name is None and g.name not in base_names][:10]

    def enc(wave):
        batch, _ = REF.encode_gangs(wave, rpods, rs, max_groups=3, max_sets=2, max_pods=16,
                                    pad_gangs_to=16, global_index_of=gidx)
        return {f: None if x is None else np.asarray(x) for f, x in batch._asdict().items()}

    first = enc(others)
    second = enc(bases)
    second["gang_valid"] = second["gang_valid"] & (np.arange(16) % 2 == 0)
    third = enc(scaled)
    assert (third["depends_global"] >= 0).sum() == len(scaled)
    null = {f: None if x is None else np.zeros_like(x) for f, x in first.items()}
    return rs, [first, second, third, null], rg


def _jax_batch(steps):
    return rc.GangBatch(*(
        None if steps[0][f] is None else jnp.asarray(np.stack([s[f] for s in steps]))
        for f in rc.GangBatch._fields
    ))


def _port_stacked(steps):
    """The same stacked steps as the port's GangBatch of tensors, with the
    port's dtypes (convert.from_reference)."""
    stacked = {f: None if steps[0][f] is None else np.stack([s[f] for s in steps])
               for f in rc.GangBatch._fields}
    dummy = np.zeros((1, 1))
    return batch_to(from_reference(dummy, dummy, np.zeros(1), dummy, stacked, {},
                                   device="cpu")[4], "cpu")


def _equal(name, want, got):
    want = None if want is None else np.asarray(want)
    got = None if got is None else got.numpy()
    if want is None or got is None:
        assert want is None and got is None, name
        return
    assert want.dtype == got.dtype and want.shape == got.shape, name
    assert np.array_equal(want, got), f"{name} differs at {np.argwhere(want != got)[:8].tolist()}"


def test_scan_solve_ref_equals_jax_scan():
    rs, steps, rg = scan_chunk()
    okg0 = np.zeros(len(rg), bool)
    want = rc.scan_solve_fn(retain=True)(
        jnp.asarray(np.asarray(rs.free, np.float32)), jnp.asarray(rs.capacity),
        jnp.asarray(rs.schedulable), jnp.asarray(rs.node_domain_id), _jax_batch(steps),
        rc.SolverParams(), jnp.asarray(okg0),
    )
    free, cap, sched, ndid, _, params = from_reference(
        rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, {}, rc.SolverParams()._asdict(),
        device="cpu",
    )
    got = scan_solve_ref(free, cap, sched, ndid, _port_stacked(steps), params,
                         torch.as_tensor(okg0), retain=True)
    for name, a, b in zip(SCAN_FIELDS, want, got):
        _equal(name, a, b)
    ok = np.asarray(want.ok)
    assert ok[0].any() and ok[1].any() and not ok[3].any()
    # Step 2's scaled gangs: admitted where step 1 admitted their base, not
    # where it rejected it.
    third, second = steps[2], steps[1]
    base_ok = np.asarray(want.okg_in)[2][third["depends_global"][:12]]
    assert base_ok.any() and not base_ok.all()
    assert not (ok[2][:12] & ~base_ok).any() and ok[2][:12][base_ok].any()
    assert np.array_equal(np.asarray(want.free_in)[3], np.asarray(want.free_after)), "null step moved"
    assert second["gang_valid"].sum() < 16


def test_scan_pruned_solve_ref_equals_jax_scan():
    rs, steps, rg = scan_chunk()
    cfg = rp.PruningConfig(enabled=True, max_candidates=63, min_fleet=16, min_pad=64)
    plans, gathered = [], []
    for s in steps[:3]:
        rb = rc.GangBatch(**s)
        plan = rp.plan_candidates(rs, rb, cfg)
        assert plan is not None and plan.pad == 64
        plans.append(plan)
        gathered.append({f: None if x is None else np.asarray(x)
                         for f, x in plan.gather_batch(rb)._asdict().items()})
    n_fleet = rs.free.shape[0]
    idx = [p._padded_idx() for p in plans] + [np.full(64, n_fleet, np.int32)]
    cap = [np.asarray(p.capacity, np.float32) for p in plans] + [np.zeros((64, 4), np.float32)]
    sched = [np.asarray(p.schedulable) for p in plans] + [np.zeros(64, bool)]
    ndid = [np.asarray(p.node_domain_id) for p in plans]
    ndid.append(np.zeros_like(ndid[0]))
    gathered.append({f: None if x is None else np.zeros_like(x) for f, x in gathered[0].items()})
    okg0 = np.zeros(len(rg), bool)
    want = rc.scan_pruned_solve_fn(retain=True)(
        jnp.asarray(np.asarray(rs.free, np.float32)), jnp.asarray(np.stack(idx)),
        jnp.asarray(np.stack(cap)), jnp.asarray(np.stack(sched)), jnp.asarray(np.stack(ndid)),
        _jax_batch(gathered), rc.SolverParams(), jnp.asarray(okg0),
    )
    got = scan_pruned_solve_ref(
        torch.as_tensor(np.asarray(rs.free, np.float32)), torch.as_tensor(np.stack(idx)),
        torch.as_tensor(np.stack(cap)), torch.as_tensor(np.stack(sched)),
        torch.as_tensor(np.stack(ndid)), _port_stacked(gathered),
        from_reference(rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, {},
                       rc.SolverParams()._asdict(), device="cpu")[5],
        torch.as_tensor(okg0), retain=True,
    )
    # JAX's scan leaves candidate ordinals for the host to remap at decode.
    asg = np.asarray(want.assigned)
    remapped = np.stack([p.remap_assigned(asg[w]) for w, p in enumerate(plans)] + [asg[3]])
    _equal("assigned", remapped, got[0])
    for name, a, b in zip(SCAN_FIELDS[1:], want[1:], got[1:]):
        _equal(name, a, b)
    ok = np.asarray(want.ok)
    assert ok[0].any() and ok[2].any() and not ok[3].any()
    assert np.array_equal(np.asarray(want.free_in)[3], np.asarray(want.free_after))
    assert np.asarray(want.free_in).shape == (4, n_fleet, 4), "free_in is fleet-shaped"


# ---- the five harvest disciplines against the JAX drain ------------------------

DENSE = {
    "bench_w4": (bench_small, 4),
    "bench_w16": (bench_small, 16),
    "contended": (_contended, 16),
}
PRUNED = {
    # tests/test_scan.py:124-140: the dense re-solves confirm (and, on this
    # fleet, adopt some) the pruned rejections.
    "confirm": (_contended, dict(enabled=True, max_candidates=32, min_fleet=16, min_pad=8)),
    # tests/test_scan.py:143-169, tests/test_resident.py:149-178.
    "adopt": (adopt_fleet, dict(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)),
}


def _drain_pair(build, mode, wave_size, pruning=None):
    rg, rpods, rs = build(REF)
    pg, ppods, ps = build(PORT)
    rkw, pkw = {}, {}
    if pruning is not None:
        rkw["pruning"] = rp.PruningConfig(**pruning)
        pkw["pruning"] = pp.PruningConfig(**pruning)
    rb, rstats = r_drain(rg, rpods, rs, wave_size=wave_size, harvest=mode,
                         warm_path=WarmPath(), **rkw)
    pb, pstats = p_drain(pg, ppods, ps, wave_size=wave_size, harvest=mode, device="cpu", **pkw)
    return (rb, rstats), (pb, pstats)


def _same_drain(r, p):
    (rb, rstats), (pb, pstats) = r, p
    assert pb == rb and list(pb) == list(rb)
    for f in LEDGER + ("harvest", "depth"):
        assert getattr(pstats, f) == getattr(rstats, f), f
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    assert [n for n, _ in pstats.wave_latencies] == [n for n, _ in rstats.wave_latencies]
    for key in ("dispatches", "deviceRoundtrips", "scanChunks", "scannedWaves", "scanRechains"):
        assert pstats.host_stages().get(key) == rstats.host_stages().get(key), key


@pytest.mark.parametrize("mode", HARVEST_MODES)
@pytest.mark.parametrize("case", sorted(DENSE))
def test_drain_equals_jax_drain(case, mode):
    build, wave_size = DENSE[case]
    r, p = _drain_pair(build, mode, wave_size)
    _same_drain(r, p)
    stats = p[1]
    if mode in ("scan", "resident"):
        assert stats.scan_chunks > 0 and stats.scanned_waves > 0
        assert stats.dispatches == stats.scan_chunks + stats.waves - stats.scanned_waves
    else:
        assert stats.dispatches == stats.waves and stats.scan_chunks == 0
    if mode in ("chained", "resident"):
        assert stats.device_roundtrips == 1 + stats.escalations
        assert stats.latency_percentiles() is None
    else:
        assert stats.device_roundtrips == stats.dispatches
        assert len(stats.wave_latencies) == stats.waves and stats.latency_percentiles()


@pytest.mark.parametrize("mode", HARVEST_MODES)
@pytest.mark.parametrize("case", sorted(PRUNED))
def test_pruned_drain_equals_jax_pruned_drain_in_every_mode(case, mode):
    build, cfg = PRUNED[case]
    r, p = _drain_pair(build, mode, 8, cfg)
    _same_drain(r, p)
    stats = p[1]
    assert stats.pruned_waves > 0 and stats.escalations >= 1
    dense, _ = p_drain(*build(PORT), wave_size=8, device="cpu")
    assert set(p[0]) == set(dense)
    if mode in ("scan", "resident"):
        assert stats.scanned_waves > 0
    if case == "adopt":
        assert stats.escalations_adopted >= 1
        if mode == "resident":
            assert stats.scan_rechains >= 1, "the adopted tail re-chains as fused chunks"
    if mode == "resident":
        assert stats.device_roundtrips >= 1 + stats.escalations


def test_resident_ledger_is_one_round_trip_plus_escalations():
    gangs, pods, snap = bench_small(PORT)
    b_res, s_res = p_drain(gangs, pods, snap, wave_size=4, harvest="resident", device="cpu")
    b_ch, _ = p_drain(gangs, pods, snap, wave_size=4, device="cpu")
    assert b_res == b_ch
    assert s_res.device_roundtrips == 1 + s_res.escalations == 1
    assert s_res.dispatches == s_res.scan_chunks + s_res.waves - s_res.scanned_waves < s_res.waves
    assert s_res.depth == 0 and s_res.harvest == "resident"


def test_scan_falls_back_to_pipeline():
    """A disabled ScanConfig, or a portfolio, runs "scan" and "resident" as
    "pipeline" (the JAX package's rule), with the same bindings."""
    gangs, pods, snap = bench_small(PORT)
    pipe, s_pipe = p_drain(gangs, pods, snap, wave_size=16, harvest="pipeline", device="cpu")
    for mode in ("scan", "resident"):
        b, s = p_drain(gangs, pods, snap, wave_size=16, harvest=mode, device="cpu",
                       scan=ScanConfig(enabled=False))
        assert b == pipe and s.harvest == "pipeline" and s.depth == 2
        assert s.scan_chunks == 0 and s.dispatches == s.waves == s_pipe.waves
    rg, rpods, rs = bench_small(REF)
    _, rstats = r_drain(rg, rpods, rs, wave_size=16, harvest="scan", warm_path=WarmPath(),
                        scan=RScanConfig(enabled=False))
    assert (rstats.harvest, rstats.dispatches) == ("pipeline", s.dispatches)
    pf, s_pf = p_drain(gangs, pods, snap, wave_size=16, harvest="scan", portfolio=2,
                       device="cpu")
    pf_pipe, _ = p_drain(gangs, pods, snap, wave_size=16, harvest="pipeline", portfolio=2,
                         device="cpu")
    assert pf == pf_pipe and s_pf.harvest == "pipeline" and s_pf.scan_chunks == 0
    assert s_pf.portfolio == 2 and s_pf.pruned_waves == 0


def test_drain_refuses_bad_arguments():
    gangs, pods, snap = _bench(PORT, n=(1, 0, 0))
    with pytest.raises(ValueError, match="harvest must be one of"):
        p_drain(gangs, pods, snap, harvest="bogus", device="cpu")
    with pytest.raises(ValueError, match="depth"):
        p_drain(gangs, pods, snap, harvest="pipeline", depth=0, device="cpu")


def test_short_runs_and_chunks_dispatch_wave_by_wave():
    """Runs shorter than min_waves_per_class stay per wave; runs longer than
    max_scan_len split into chunks; the bindings never change."""
    gangs, pods, snap = bench_small(PORT)
    waves = p_plan(gangs, 4)
    base, _ = p_drain(gangs, pods, snap, wave_size=4, harvest="wave", device="cpu")
    _, s = p_drain(gangs, pods, snap, wave_size=4, harvest="scan", device="cpu",
                   scan=ScanConfig(max_scan_len=2, min_waves_per_class=2))
    runs = [sum(1 for w in waves if w[1:] == key) for key in dict.fromkeys(w[1:] for w in waves)]
    assert s.scan_chunks == sum(n // 2 for n in runs) and s.waves == len(waves)
    assert s.scanned_waves == 2 * s.scan_chunks
    b, s = p_drain(gangs, pods, snap, wave_size=4, harvest="scan", device="cpu",
                   scan=ScanConfig(min_waves_per_class=100))
    assert b == base and s.scan_chunks == 0 and s.dispatches == s.waves


def test_latency_percentiles_edge_cases():
    """tests/test_drain.py:351-375 against the JAX DrainStats."""
    for series, qs in (
        ([], (50.0, 99.0)),
        ([(0, 0.1), (0, 0.2)], (50.0, 99.0)),
        ([(3, 0.25)], (50.0, 99.0)),
        ([(0, 0.1), (2, 0.2), (0, 0.3), (1, 0.4)], (50.0, 99.0)),
        ([(5, 0.1), (1, 0.3), (7, 0.2)], (10.0, 50.0, 90.0, 99.9)),
    ):
        p, r = DrainStats(), RDrainStats()
        p.wave_latencies = list(series)
        r.wave_latencies = list(series)
        assert p.latency_percentiles(qs) == r.latency_percentiles(qs)
    s = DrainStats()
    s.wave_latencies = [(3, 0.25)]
    assert s.latency_percentiles() == {50.0: 0.25, 99.0: 0.25}
    assert DrainStats().latency_percentiles() is None


def test_scan_config_from_reference():
    ref = RScanConfig(enabled=False, max_scan_len=8, min_waves_per_class=3,
                      affinity_lookahead=2, device_resident=True)
    assert scan_config_from_reference(dataclasses.asdict(ref)) == ScanConfig(
        enabled=False, max_scan_len=8, min_waves_per_class=3, affinity_lookahead=2,
        device_resident=True,
    )
    assert scan_config_from_reference(dataclasses.asdict(RScanConfig())) == ScanConfig()
    assert [f.name for f in dataclasses.fields(ScanConfig)] == [
        f.name for f in dataclasses.fields(RScanConfig)]
    with pytest.raises(ValueError, match="unknown ScanConfig"):
        scan_config_from_reference({"bogus": 1})


def test_stack_batches_stacks_every_field():
    gangs, pods, snap = bench_small(PORT)
    b1, _ = PORT.encode_gangs(gangs[:3], pods, snap, max_groups=3, max_sets=2, max_pods=16,
                              pad_gangs_to=4)
    b2, _ = PORT.encode_gangs(gangs[3:6], pods, snap, max_groups=3, max_sets=2, max_pods=16,
                              pad_gangs_to=4)
    st = stack_batches([b1, b2])
    for f, x in st._asdict().items():
        a, b = getattr(b1, f), getattr(b2, f)
        if a is None:
            assert x is None
        else:
            assert np.array_equal(x[0], a) and np.array_equal(x[1], b) and x.dtype == a.dtype


# ---- B6's plain version (the tuning sweep's stacked scan) -------------------------


def test_stacked_scan_ref_equals_jax_stacked_scan_fn():
    """stacked_scan_solve_ref against JAX stacked_scan_solve_fn on a chunk of
    same-shape waves, each from its own free, with a trailing null wave
    (zero free, all-invalid batch), at K = 3, tolerance 0."""
    rs, ref_steps, _ = scan_chunk()
    w = len(ref_steps)
    rng = np.random.default_rng(7)
    free = np.asarray(rs.free, np.float32)
    free_stack = np.stack([free * (rng.random(free.shape[0]) < 0.8)[:, None].astype(np.float32)
                           for _ in range(w)])
    free_stack[-1] = 0
    stack = np.exp(rng.normal(0, 0.5, size=(3, 5))).astype(np.float32)
    stack[0] = 1
    stack *= np.asarray([1.0, 4.0, 2.0, 8.0, 1.5], np.float32)
    stack[1, 0] *= -1
    jbatch = _jax_batch(ref_steps)
    want = rc.stacked_scan_solve_fn()(
        jnp.asarray(free_stack), jnp.asarray(rs.capacity), jnp.asarray(rs.schedulable),
        jnp.asarray(rs.node_domain_id), jbatch,
        rc.SolverParams(*(jnp.asarray(stack[:, i]) for i in range(5))), coarse_dmax=None)
    pbatch = _port_stacked(ref_steps)
    got = stacked_scan_solve_ref(torch.as_tensor(free_stack), torch.as_tensor(rs.capacity),
                                 torch.as_tensor(rs.schedulable),
                                 torch.as_tensor(rs.node_domain_id), pbatch,
                                 torch.as_tensor(stack))
    for f, a, b in zip(("assigned", "ok", "placement_score"),
                       (want.assigned, want.ok, want.placement_score), got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    ok = got[1].numpy()
    assert ok[:-1].any() and not ok[-1].any(), "the null wave admits nothing"
    entry = stacked_scan_solve(free_stack, rs.capacity, rs.schedulable, rs.node_domain_id,
                               pbatch, stack, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(entry, got))
