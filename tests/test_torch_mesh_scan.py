"""The scan and resident disciplines under a layout (B4 x B7's plain
versions, `sharded_scan_solve_ref` and `sharded_scan_pruned_solve_ref`)
against the JAX package's on the suite's 8 virtual CPU devices
(tests/conftest.py); the port runs on 8 virtual devices of the CPU
(`force_virtual_devices`).

  - drain_backlog in "scan" and "resident" under a MeshConfig, dense and
    pruned (escalations confirmed and adopted): bindings, scores and the
    DrainStats ledger (dispatches, round trips, scan chunks, scanned waves,
    re-chains, shard devices and fallbacks) equal to JAX's, and bindings
    and free_after equal to the port's unsharded drain;
  - drain_stream in "scan" and "resident" modes under a mesh;
  - the stream's mesh rung stepping down and up with the scan rung armed;
  - a drain journaled scanned under a layout, replayed with the layout
    rebuilt (0 divergences), and a JAX journal so recorded;
  - the launch cache: a sharded scan entry keyed apart from the unsharded
    one and prewarmed from shape history.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from grove_tpu.parallel import mesh as r_mesh
from grove_tpu.solver import pruning as rp
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu_torch.parallel import mesh as p_mesh
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from test_torch_host import PORT, REF, _contended
from test_torch_scan import LEDGER, adopt_fleet, bench_small
from torch_jax_programs import _release_jax_programs  # noqa: F401


@pytest.fixture(autouse=True)
def virtual8():
    assert len(jax.devices()) == 8
    p_mesh.force_virtual_devices(8, "cpu")
    yield p_mesh.mesh_devices()
    p_mesh.force_virtual_devices(0)


@pytest.fixture
def sharded_scans(monkeypatch):
    """Counts the plain B4 x B7 chunks (dense and pruned) by their shards."""
    calls = []
    for name in ("sharded_scan_solve_ref", "sharded_scan_pruned_solve_ref"):
        orig = getattr(pc, name)

        def spy(*a, _orig=orig, **kw):
            calls.append(len(a[-1]))  # the spans
            return _orig(*a, **kw)

        monkeypatch.setattr(pc, name, spy)
    return calls


DENSE = {"contended": (_contended, 16, 64)}
PRUNED = {
    "confirm": (_contended, dict(enabled=True, max_candidates=32, min_fleet=16, min_pad=8)),
    "adopt": (adopt_fleet, dict(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)),
}


def drains(build, mode, wave_size, min_nodes, pruning=None):
    """The JAX drain and the port's under MeshConfig(enabled, min_nodes),
    and the port's unsharded drain."""
    rg, rpods, rs = build(REF)
    pg, ppods, ps = build(PORT)
    rkw, pkw = {}, {}
    if pruning is not None:
        rkw["pruning"] = rp.PruningConfig(**pruning)
        pkw["pruning"] = pp.PruningConfig(**pruning)
    r = r_drain(rg, rpods, rs, wave_size=wave_size, harvest=mode, warm_path=RWarm(),
                mesh=r_mesh.MeshConfig(enabled=True, min_nodes=min_nodes), **rkw)
    p = p_drain(pg, ppods, ps, wave_size=wave_size, harvest=mode, device="cpu",
                warm_path=PWarm(), mesh=p_mesh.MeshConfig(enabled=True, min_nodes=min_nodes),
                **pkw)
    base = p_drain(pg, ppods, ps, wave_size=wave_size, harvest=mode, device="cpu",
                   warm_path=PWarm(), **pkw)
    return r, p, base


def same_drain(r, p, base):
    (rb, rstats), (pb, pstats), (bb, bstats) = r, p, base
    assert pb == rb and list(pb) == list(rb)
    for f in LEDGER + ("harvest", "depth", "shard_devices", "shard_fallbacks", "scan_rechains"):
        assert getattr(pstats, f) == getattr(rstats, f), f
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    for key in ("dispatches", "deviceRoundtrips", "scanChunks", "scannedWaves", "scanRechains"):
        assert pstats.host_stages().get(key) == rstats.host_stages().get(key), key
    assert bb == pb and np.array_equal(bstats.free_after, pstats.free_after)
    assert pstats.shard_devices > 1 and pstats.scan_chunks > 0


@pytest.mark.parametrize("mode", ["scan", "resident"])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_scanned_drains_under_a_layout_equal_jax(case, mode, sharded_scans):
    build, wave_size, min_nodes = DENSE[case]
    r, p, base = drains(build, mode, wave_size, min_nodes)
    same_drain(r, p, base)
    stats = p[1]
    assert len(sharded_scans) == stats.scan_chunks + stats.scan_rechains
    assert set(sharded_scans) == {stats.shard_devices}


@pytest.mark.parametrize("case,mode", [("confirm", "scan"), ("adopt", "resident")])
def test_pruned_scanned_drains_under_a_layout_equal_jax(case, mode, sharded_scans):
    """Each step's candidate axis split over the shards; escalations
    confirmed (and on the adopt fleet adopted, the tail re-chained) as the
    JAX drain's."""
    build, cfg = PRUNED[case]
    r, p, base = drains(build, mode, 8, 16, cfg)
    same_drain(r, p, base)
    stats = p[1]
    assert stats.pruned_waves > 0 and stats.escalations >= 1 and sharded_scans
    assert stats.candidate_pad % stats.shard_devices == 0
    if case == "adopt":
        assert stats.escalations_adopted >= 1


# ---- the stream ------------------------------------------------------------------


def stream_world(pkg):
    from grove_tpu.sim import workloads as r_wl
    from grove_tpu.state import build_snapshot as r_snapshot
    from grove_tpu_torch.sim import workloads as p_wl
    from grove_tpu_torch.state import build_snapshot as p_snapshot

    wl, snap_of = (r_wl, r_snapshot) if pkg == "jax" else (p_wl, p_snapshot)
    nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=4)
    snap = snap_of(nodes, wl.bench_topology())
    arrivals, pods = wl.expand_arrivals(wl.arrival_process(7, duration_s=6.0, base_rate=6.0),
                                        wl.bench_topology())
    return arrivals, pods, snap


def stream_mods(pkg):
    from grove_tpu.solver import stream as r_stream
    from grove_tpu_torch.solver import stream as p_stream

    if pkg == "jax":
        return r_stream, r_mesh, r_stream.ScanConfig, RWarm, {}
    return p_stream, p_mesh, p_stream.ScanConfig, PWarm, {"device": "cpu"}


@pytest.mark.parametrize("resident", [False, True])
def test_scanned_streams_under_a_mesh_equal_jax(resident, sharded_scans):
    out = {}
    for pkg in ("jax", "port"):
        stream, mesh, scan_cfg, warm, kw = stream_mods(pkg)
        arrivals, pods, snap = stream_world(pkg)
        got, stats = stream.drain_stream(
            arrivals, pods, snap, config=stream.StreamConfig(depth=2, wave_size=16),
            warm_path=warm(), pipeline=True, scan=scan_cfg(device_resident=resident),
            mesh=mesh.MeshConfig(enabled=True, min_nodes=64), **kw)
        d = stats.drain
        out[pkg] = (got, stats.mode, d.shard_devices, d.shard_fallbacks, d.scan_chunks,
                    d.scanned_waves, d.dispatches, d.device_roundtrips,
                    stats.to_doc()["shardDevices"])
    assert out["port"] == out["jax"]
    assert out["port"][1] == ("resident" if resident else "scan") and out["port"][2] == 8
    assert out["port"][4] > 0 and len(sharded_scans) >= out["port"][4]


def test_stream_mesh_rung_with_the_scan_armed_equals_jax():
    """A scanned stream under a mesh whose dispatch faults charge the scan
    rung, then the mesh rung: the ladder steps the two down in turn and
    back up after probation (the layout adopted while the scan is armed);
    bindings, counters, transitions and the shard ledger equal JAX's."""
    import itertools

    from grove_tpu import faults as r_faults
    from grove_tpu.solver import resilience as r_res
    from grove_tpu_torch import faults as p_faults
    from grove_tpu_torch.solver import resilience as p_res

    out = {}
    try:
        for pkg, faults, res in (("jax", r_faults, r_res), ("port", p_faults, p_res)):
            stream, mesh, scan_cfg, warm, kw = stream_mods(pkg)
            arrivals, pods, snap = stream_world(pkg)
            c = itertools.count(1)
            lad = res.DegradationLadder(res.ResilienceConfig(
                enabled=True, max_wave_retries=1, breaker_threshold=2,
                breaker_window_seconds=300.0, probation_seconds=0.01),
                clock=lambda: next(c) * 0.001)
            inj = faults.FaultInjector({"solver.dispatch": faults.SiteSpec(
                kind="error", rate=1.0, count=12, after=1)}, seed=20260804)
            cfg = stream.StreamConfig(depth=2, wave_size=16)
            got, stats = stream.drain_stream(
                arrivals, pods, snap, config=cfg, warm_path=warm(), pipeline=True,
                scan=scan_cfg(), faults=inj, resilience=lad,
                mesh=mesh.MeshConfig(enabled=True, min_nodes=64), **kw)
            d = stats.drain
            out[pkg] = dict(bindings=got, res=d.resilience_doc(), ladder=lad.stats(),
                            counters=lad.counters(), shard=d.shard_devices,
                            fallbacks=d.shard_fallbacks, chunks=d.scan_chunks,
                            scanned=d.scanned_waves, doc=stats.to_doc()["shardDevices"])
    finally:
        r_faults.install(None)
        p_faults.install(None)
    # The faults change no placement: the port's serial baseline, handed
    # the same scan config, forms the same waves (class-affine forming).
    stream, _, scan_cfg, warm, kw = stream_mods("port")
    arrivals, pods, snap = stream_world("port")
    base, _ = stream.drain_stream(arrivals, pods, snap, config=stream.StreamConfig(
        depth=2, wave_size=16), warm_path=warm(), scan=scan_cfg(), **kw)
    assert out["port"]["bindings"] == base
    counters = out["port"]["counters"]
    assert counters["mesh"]["stepDowns"] >= 1 and counters["mesh"]["stepUps"] >= 1
    assert counters["scan"]["stepDowns"] >= 1 and counters["scan"]["stepUps"] >= 1
    assert out["port"] == out["jax"]


# ---- replay ----------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_drain_journaled_scanned_under_a_layout_replays(pkg, tmp_path):
    """A pruned drain scanned under a 4-shard layout, journaled by either
    package: every wave records the mesh, and the port replays the journal
    with 0 divergences, the layout rebuilt (sharded entries only)."""
    from grove_tpu.trace.recorder import TraceRecorder as RRecorder
    from grove_tpu.trace.recorder import read_journal
    from grove_tpu_torch.trace.recorder import TraceRecorder as PRecorder
    from grove_tpu_torch.trace.replay import replay_journal

    cfg = dict(enabled=True, max_candidates=32, min_fleet=16, min_pad=8)
    if pkg == "jax":
        gangs, pods, snap = _contended(REF)
        rec = RRecorder(str(tmp_path / "j"))
        kw = dict(warm_path=RWarm(), pruning=rp.PruningConfig(**cfg),
                  mesh=r_mesh.MeshConfig(enabled=True, min_nodes=64, max_devices=4))
        drain = r_drain
    else:
        gangs, pods, snap = _contended(PORT)
        rec = PRecorder(str(tmp_path / "j"))
        kw = dict(warm_path=PWarm(), pruning=pp.PruningConfig(**cfg), device="cpu",
                  mesh=p_mesh.solve_layout_for(int(snap.free.shape[0]),
                                               p_mesh.mesh_devices()[:4]))
        drain = p_drain
    rec.start()
    try:
        _, stats = drain(gangs, pods, snap, wave_size=16, harvest="scan", recorder=rec, **kw)
    finally:
        rec.stop()
    assert stats.shard_devices == 4 and stats.scan_chunks > 0 and stats.pruned_waves > 0
    records = read_journal(str(tmp_path / "j"))
    waves = [w for w in records if w.get("kind") == "wave"]
    assert len(waves) == stats.waves
    assert all(w["solver"]["mesh"] == {"portfolio": 1, "node": 4} for w in waves)
    wp = PWarm()
    assert replay_journal(records, warm_path=wp, device="cpu").divergence_count == 0
    keys = list(wp.executables._entries)
    assert keys and all(k[4] is not None and k[4][1] == 4 for k in keys)


def test_journal_with_a_portfolio_axis_replays():
    """A wave whose fingerprint carries a portfolio axis over 1 (and a
    portfolio solve under a mesh config) replays on the port: the recorded
    node axis is rebuilt, the portfolio solves under its own mesh."""
    from test_torch_controller import TwinScenario
    from scenario_harness import wl2

    from grove_tpu_torch.trace.replay import replay_journal

    s = TwinScenario(16)
    for side, mesh_mod in ((s.ref, r_mesh), (s.port, p_mesh)):
        side.controller.mesh_cfg = mesh_mod.MeshConfig(enabled=True, min_nodes=8)
        side.controller.portfolio = 4
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        s.record(__import__("pathlib").Path(d))
        s.deploy(wl2())
        assert s.until_ready(10)
        r_records, p_records = s.journals()
    waves = [r for r in p_records if r.get("kind") == "wave"]
    assert waves and all(w["solver"]["portfolio"] == 4 for w in waves)
    forged = [dict(r, solver=dict(r["solver"], mesh={"portfolio": 2, "node": 4}))
              if r.get("kind") == "wave" else r for r in p_records]
    for records in (p_records, r_records, forged):
        assert replay_journal(records, device="cpu").divergence_count == 0


# ---- the launch cache ------------------------------------------------------------


def test_sharded_scan_entries_key_apart_and_prewarm(tmp_path):
    from grove_tpu_torch.solver.encode import encode_gangs, stack_batches

    gangs, pods, snap = bench_small(PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    full, _ = encode_gangs(gangs, pods, snap, global_index_of=gidx)
    shape = dict(max_groups=full.group_req.shape[1], max_sets=full.set_member.shape[1],
                 max_pods=full.pod_group.shape[1], pad_gangs_to=4)
    waves = [encode_gangs(gangs[i:i + 4], pods, snap, global_index_of=gidx, **shape)[0]
             for i in (0, 4)]
    sb = stack_batches(waves)
    n = int(snap.free.shape[0])
    layout = p_mesh.solve_layout_for(n)
    args = (snap.free, snap.capacity, snap.schedulable, snap.node_domain_id)
    okg = np.zeros(len(gangs), bool)
    history = str(tmp_path / "shapes.json")
    wp = PWarm()
    wp.executables.history_path = history
    cache = wp.executables
    base = cache.solve_scan(*args, sb, None, okg, device="cpu", retain=True)
    assert cache.lowerings == 1
    got = cache.solve_scan(*args, sb, None, okg, device="cpu", retain=True, layout=layout)
    assert cache.lowerings == 2
    cache.solve_scan(*args, sb, None, okg, device="cpu", retain=True, layout=layout)
    assert cache.lowerings == 2 and cache.hits == 1
    for a, b in zip(base, got):
        assert (a is None) == (b is None) and (a is None or bool((a == b).all()))
    assert cache.ensure_compiled_scan(*args, waves[0], None, okg, 2, retain=True,
                                      device="cpu", layout=layout) is False
    keys = list(cache._entries)
    assert len(set(keys)) == 2 and sum(k[4] is not None for k in keys) == 1
    # The history records the sharded scan with its mesh; a fresh cache
    # prewarms it, and the live sharded scan then prepares nothing.
    descs = [e["desc"] for e in cache._history.values()]
    assert any(d.get("scan") == 2 and d["mesh"] == [1, 8] for d in descs)
    wp2 = PWarm()
    wp2.executables.history_path = history
    assert wp2.executables.prewarm_from_history(top_k=8, device="cpu") == 2
    before = wp2.executables.lowerings
    wp2.executables.solve_scan(*args, sb, None, okg, device="cpu", retain=True, layout=layout)
    assert wp2.executables.lowerings == before
