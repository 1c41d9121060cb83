"""The port's streaming drain and arrival traffic (grove_tpu_torch/solver/
stream.py, sim/workloads.py; plain PyTorch versions on the CPU) against the
JAX package's:

  - arrival_process traces equal JAX's field by field, for three seeds, with
    and without an slo_mix; expand_arrivals gangs and pods equal JAX's
    (names, order, base before scaled, slo_class);
  - drain_stream on bench.py's sweep-scenario trace (58 gangs, 64 nodes,
    wave_size 8): serial, pipeline, scan (look-ahead 4), formed serial and
    resident, each with JAX's bindings, window count and engine counters
    (waves, dispatches, device_roundtrips, scan_chunks, scanned_waves,
    escalations, launch-cache hits, misses and lowerings) and the warm
    path's last_stream document; scan and resident bind bitwise what the
    formed serial run binds; the pipelined run admits the set drain_backlog
    admits;
  - a paced run measures a latency for each admitted gang.

The journals and the order_key windows are in tests/test_torch_stream_journal.py,
the pruned stream in tests/test_torch_stream_pruned.py.
"""

from __future__ import annotations

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import stream as r_stream
from grove_tpu.solver.drain import ScanConfig as RScan
from grove_tpu.solver.warm import WarmPath as RWarmPath
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import stream as p_stream
from grove_tpu_torch.solver.drain import ScanConfig as PScan
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.warm import WarmPath as PWarmPath
from grove_tpu_torch.state import build_snapshot as p_snapshot
from torch_jax_programs import _release_jax_programs  # noqa: F401

SLO_MIX = (("latency", 0.3), ("standard", 0.5), ("batch-preemptible", 0.2))
COUNTERS = ("waves", "dispatches", "device_roundtrips", "scan_chunks", "scanned_waves",
            "escalations", "escalations_adopted", "exec_cache_hits", "exec_cache_misses",
            "lowerings")
DOC_KEYS = ("streamGangs", "streamAdmitted", "streamPodsBound", "streamWaves", "depth", "mode",
            "paced", "dispatches", "deviceRoundtrips", "scanChunks", "scannedWaves")


@pytest.fixture(autouse=True, scope="module")
def _no_shared_xla_cache():
    """This module's JAX compiles stay out of the suite's persistent XLA
    cache (tests/conftest.py): a worker reading an entry another worker is
    writing in place can crash."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    cc.reset_cache()


def fleet(wl, build, racks=4, hosts=8):
    topo = wl.bench_topology()
    nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=racks,
                                 hosts_per_rack=hosts)
    return build(nodes, topo)


def trace(wl, seed=7, duration_s=10.0, rate=3.0, **kw):
    return wl.expand_arrivals(wl.arrival_process(seed, duration_s=duration_s, base_rate=rate,
                                                 **kw))


@pytest.fixture(scope="module")
def world():
    """bench.py's sweep-scenario trace and fleet, built by each package, and
    one warm path per package shared by every run of the module (the runs
    go in the same order on both sides, so the cache counters compare)."""
    return {
        "jax": (*trace(r_wl), fleet(r_wl, r_snapshot), RWarmPath()),
        "port": (*trace(p_wl), fleet(p_wl, p_snapshot), PWarmPath()),
    }


# ---- arrival traffic ----------------------------------------------------------------


@pytest.mark.parametrize("slo_mix", [None, SLO_MIX], ids=["standard", "slo_mix"])
@pytest.mark.parametrize("seed", [7, 1234, 20260804])
def test_arrival_process_equals_jax(seed, slo_mix):
    want = r_wl.arrival_process(seed, duration_s=25.0, base_rate=12.0, slo_mix=slo_mix)
    got = p_wl.arrival_process(seed, duration_s=25.0, base_rate=12.0, slo_mix=slo_mix)
    assert len(got) == len(want) > 100
    for a, b in zip(want, got):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    if slo_mix is not None:
        assert {e.slo_class for e in got} == {c for c, _ in SLO_MIX}


@pytest.mark.parametrize("slo_mix", [None, SLO_MIX], ids=["standard", "slo_mix"])
def test_expand_arrivals_equals_jax(slo_mix):
    events = r_wl.arrival_process(20260804, duration_s=25.0, base_rate=12.0, slo_mix=slo_mix)
    r_arr, r_pods = r_wl.expand_arrivals(events)
    p_arr, p_pods = p_wl.expand_arrivals(
        p_wl.arrival_process(20260804, duration_s=25.0, base_rate=12.0, slo_mix=slo_mix))
    assert len(p_arr) == len(r_arr) == 433 and len(p_pods) == len(r_pods) == 2819
    for (ta, a), (tb, b) in zip(r_arr, p_arr):
        assert (ta, a.name, a.base_podgang_name, a.slo_class, a.total_pods()) == \
            (tb, b.name, b.base_podgang_name, b.slo_class, b.total_pods())
    assert list(p_pods) == list(r_pods)
    assert [p.podgang_name for p in p_pods.values()] == [p.podgang_name for p in r_pods.values()]
    seen = set()
    for _, g in p_arr:  # a base gang precedes every gang scaled from it
        assert g.base_podgang_name is None or g.base_podgang_name in seen
        seen.add(g.name)


# ---- the streaming drain ------------------------------------------------------------

# (label, pipeline, scan): the scan at ScanConfig's look-ahead 4; "formed" is
# the serial run handed the scan config (class-affine forming, no fusion).
DISCIPLINES = [
    ("serial", False, None),
    ("pipeline", True, None),
    ("scan", True, "scan"),
    ("formed", False, "scan"),
    ("resident", True, "resident"),
]


def run(world, side, pipeline, scan, **kw):
    arrivals, pods, snap, wp = world[side]
    cfg_mod, scan_cls = (r_stream, RScan) if side == "jax" else (p_stream, PScan)
    scan_cfg = None if scan is None else scan_cls(device_resident=scan == "resident")
    extra = {} if side == "jax" else {"device": "cpu"}
    return cfg_mod.drain_stream(arrivals, pods, snap, config=cfg_mod.StreamConfig(depth=2,
                                                                                   wave_size=8),
                                warm_path=wp, pipeline=pipeline, scan=scan_cfg, **extra, **kw)


@pytest.fixture(scope="module")
def runs(world):
    """Every discipline run by both packages, in DISCIPLINES order."""
    out = {}
    for label, pipeline, scan in DISCIPLINES:
        want = run(world, "jax", pipeline, scan)
        doc_want = dict(world["jax"][3].last_stream)
        got = run(world, "port", pipeline, scan)
        out[label] = (want, doc_want, got, dict(world["port"][3].last_stream))
    return out


@pytest.mark.parametrize("label", [d[0] for d in DISCIPLINES])
def test_drain_stream_equals_jax(runs, label):
    (b_want, s_want), doc_want, (b_got, s_got), doc_got = runs[label]
    assert b_got == b_want
    assert list(b_got) == list(b_want)  # commit order
    assert (s_got.offered, s_got.admitted, s_got.pods_bound, s_got.waves, s_got.windows,
            s_got.mode, s_got.depth) == (s_want.offered, s_want.admitted, s_want.pods_bound,
                                         s_want.waves, s_want.windows, s_want.mode, s_want.depth)
    for name in COUNTERS:
        assert getattr(s_got.drain, name) == getattr(s_want.drain, name), name
    assert {k: doc_got.get(k) for k in DOC_KEYS} == {k: doc_want.get(k) for k in DOC_KEYS}
    assert len(s_got.bind_latencies) == s_got.admitted == len(b_got) > 0
    assert all(x >= 0 for x in s_got.bind_latencies)


def test_scan_and_resident_bind_what_formed_serial_binds(runs):
    formed = runs["formed"][2][0]
    scan_b, scan_s = runs["scan"][2]
    res_b, res_s = runs["resident"][2]
    assert scan_b == formed and res_b == formed
    assert set(runs["pipeline"][2][0]) == set(runs["serial"][2][0])
    assert scan_s.drain.scan_chunks >= 1 and scan_s.drain.scanned_waves * 2 >= scan_s.waves
    assert res_s.drain.device_roundtrips == 1 + res_s.drain.escalations
    assert runs["serial"][2][1].drain.lowerings > 0  # the first run prepared its shapes
    assert runs["pipeline"][2][1].drain.lowerings == 0


def test_pipelined_stream_admits_what_drain_backlog_admits(world, runs):
    arrivals, pods, snap, wp = world["port"]
    ref, _ = p_drain([g for _, g in arrivals], pods, snap, wave_size=8, warm_path=wp,
                     device="cpu")
    assert set(runs["pipeline"][2][0]) == set(ref)


def test_paced_stream_measures_time_to_bind():
    arrivals, pods = trace(p_wl, duration_s=2.0)
    wp = PWarmPath()
    bindings, stats = p_stream.drain_stream(
        arrivals, pods, fleet(p_wl, p_snapshot), config=p_stream.StreamConfig(
            depth=2, wave_size=8, max_wait_s=0.02), pace=True, warm_path=wp, device="cpu")
    assert stats.paced and stats.mode == "pipeline"
    assert stats.admitted == len(bindings) > 0
    assert len(stats.bind_latencies) == stats.admitted
    assert all(0.0 <= x <= stats.wall_s + 1e-6 for x in stats.bind_latencies)
    pct = stats.bind_percentiles((50.0, 99.0))
    assert pct is not None and pct[50.0] <= pct[99.0]
    assert stats.wall_s >= max(t for t, _ in arrivals) - 1e-6
    doc = wp.last_stream
    assert doc["paced"] and doc["bindP99S"] == round(pct[99.0], 4)
    assert len(wp.stream_bind_samples) == stats.admitted


def test_stream_empty_and_validation():
    snap = fleet(p_wl, p_snapshot, racks=1, hosts=2)
    bindings, stats = p_stream.drain_stream([], {}, snap, device="cpu")
    assert bindings == {} and stats.offered == 0 and stats.bind_percentiles() is None
    with pytest.raises(ValueError, match="depth"):
        p_stream.drain_stream([], {}, snap, config=p_stream.StreamConfig(depth=0), device="cpu")
    with pytest.raises(ValueError, match="waveSize"):
        p_stream.drain_stream([], {}, snap, config=p_stream.StreamConfig(wave_size=0),
                              device="cpu")
