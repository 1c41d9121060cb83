"""The port's engine under faults (plain PyTorch versions, device="cpu")
against the JAX package's, on the JAX tests' fleet and trace
(tests/test_resilience.py: 24 nodes, arrival_process(20260804, 6 s, rate
4)):

  - a harvest timeout on a wave with two successors in flight (pipelined
    and scanned at depth 2): its re-dispatch from the retained entering
    carry leaves the live carry alone — bindings and free_after equal the
    fault-free run, the counters JAX's; at the engine level the live carry
    and the retained one are the same tensors, unchanged, afterwards;
  - a dispatch fault inside a scan chunk: WaveFault.pending carries the
    planned waves not yet enqueued (as JAX's); a scan rung opening in the
    middle of a formed look-ahead group (the port alone: the JAX loop
    raises there, ROADMAP Queue C).
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest

from grove_tpu import faults as r_faults
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import resilience as r_res
from grove_tpu.solver.drain import ScanConfig as RScan
from grove_tpu.solver.drain import WaveFault as RWaveFault
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu_torch import faults as p_faults
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import resilience as p_res
from grove_tpu_torch.solver.drain import ScanConfig as PScan
from grove_tpu_torch.solver.drain import WaveFault as PWaveFault
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.stream import StreamConfig as PStreamConfig
from grove_tpu_torch.solver.stream import drain_stream as p_stream
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from grove_tpu_torch.state import build_snapshot as p_snapshot

SEED = 20260804
PKG = {
    "jax": dict(faults=r_faults, res=r_res, scan=RScan, fault_t=RWaveFault, drain=r_drain,
                warm=RWarm, kw={}),
    "port": dict(faults=p_faults, res=p_res, scan=PScan, fault_t=PWaveFault, drain=p_drain,
                 warm=PWarm, kw={"device": "cpu"}),
}


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


@pytest.fixture(scope="module")
def wp():
    """One warm path per package for the whole module: every test runs the
    same calls on both, in the same order, so the cache counters compare
    (and the JAX compiles are paid once per shape)."""
    return {"jax": RWarm(), "port": PWarm()}


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    r_faults.install(None)
    p_faults.install(None)


def world(pkg, duration_s=6.0, rate=4.0):
    wl, build = (r_wl, r_snapshot) if pkg == "jax" else (p_wl, p_snapshot)
    topo = wl.bench_topology()
    nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=2, hosts_per_rack=6)
    arrivals, pods = wl.expand_arrivals(wl.arrival_process(SEED, duration_s=duration_s,
                                                           base_rate=rate))
    return arrivals, pods, build(nodes, topo)


def injector(m, specs: dict):
    return m["faults"].FaultInjector({s: m["faults"].SiteSpec(**kw) for s, kw in specs.items()},
                                     seed=SEED)


@pytest.mark.parametrize("harvest", ["pipeline", "scan"])
def test_harvest_timeout_with_two_successors_in_flight(harvest, wp):
    """At depth 2 the first fetch (wave 0) happens with waves 1 and 2 in
    flight on the carry wave 0 produced. Its injected hang re-dispatches it
    from its retained entering carry without advancing the carry: the
    bindings and free_after equal the fault-free run, and JAX's counters."""
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg)
        gangs = [g for _, g in arrivals]
        kw = dict(wave_size=8, harvest=harvest, depth=2, warm_path=wp[pkg], **m["kw"])
        if harvest == "scan":
            kw["scan"] = m["scan"](max_scan_len=4)
        base, base_stats = m["drain"](gangs, pods, snap, **kw)
        assert base_stats.waves >= 4
        inj = injector(m, {"solver.harvest": dict(kind="timeout", rate=1.0, count=1)})
        got, stats = m["drain"](gangs, pods, snap, faults=inj,
                                resilience=m["res"].ResilienceConfig(enabled=True,
                                                                     max_wave_retries=1),
                                **kw)
        assert got == base
        assert (stats.watchdog_timeouts, stats.waves_cancelled, stats.wave_redispatches) == \
            (1, 1, 1)
        out[pkg] = (got, stats.resilience_doc(), stats.dispatches, stats.waves)
        if pkg == "port":
            assert np.array_equal(stats.free_after, base_stats.free_after)
    assert out["port"] == out["jax"]


def test_redispatch_leaves_the_live_carry_alone():
    """Engine-level: after a wave's re-dispatch, the engine's carry is the
    very tensor the original chain left, unchanged, and the wave's retained
    entering carry is unchanged too."""
    import torch

    from grove_tpu_torch.solver.core import SolverParams
    from grove_tpu_torch.solver.drain import DrainStats, _WavePipeline, plan_waves

    arrivals, pods, snap = world("port")
    gangs = [g for _, g in arrivals]
    stats = DrainStats()
    eng = _WavePipeline(gangs=gangs, pods_by_name=pods, snapshot=snap, params=SolverParams(),
                        stats=stats, dev=torch.device("cpu"), warm_path=PWarm(),
                        retire_lag=None, max_wave_retries=1)
    assert eng.retain_carries and not eng.donate
    waves = plan_waves(gangs, 8)
    for ws in waves[:3]:
        eng.submit(ws, retire=False)
    live = eng.free
    live_copy, okg_copy = live.clone(), eng.ok_g.clone()
    rec = eng.inflight[0]
    free_in_copy = rec["free_in"].clone()
    ok_before = rec["host"][0].clone()
    eng.cancel_wave(rec)
    eng._redispatch(rec)
    assert eng.free is live and torch.equal(live, live_copy) and torch.equal(eng.ok_g, okg_copy)
    assert torch.equal(rec["free_in"], free_in_copy)
    assert torch.equal(rec["host"][0], ok_before)
    assert (stats.wave_redispatches, stats.waves_cancelled, stats.dispatches) == (1, 1, 4)


def test_scan_chunk_dispatch_fault_hands_back_pending(wp):
    """Without a ladder: a fused chunk whose dispatch fails past its budget
    raises WaveFault with `pending` = the planned waves not yet enqueued
    (the failed chunk onward), as the JAX engine does."""
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg)
        gangs = [g for _, g in arrivals]
        inj = injector(m, {"solver.dispatch": dict(kind="error", rate=1.0, count=1, after=1)})
        with pytest.raises(m["fault_t"]) as ei:
            m["drain"](gangs, pods, snap, wave_size=8, harvest="scan",
                       scan=m["scan"](max_scan_len=2), warm_path=wp[pkg], faults=inj,
                       **m["kw"])
        e = ei.value
        assert not e.in_flight and e.pending
        out[pkg] = [[g.name for g in ws[0]] for ws in e.pending]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("after", [0, 3, 6])
def test_stream_scan_rung_opening_mid_group_keeps_dispatching(after):
    """A fused run whose dispatch fails opens the scan rung while the rest of
    a formed look-ahead group is still being buffered: the group goes on
    wave by wave, in the same order, to the fault-free bindings. (The JAX
    loop reads `engine.scan.max_scan_len` there after the rung opened and
    raises AttributeError; ROADMAP Queue C.)"""
    arrivals, pods, snap = world("port")
    kw = dict(config=PStreamConfig(depth=2, wave_size=16), warm_path=PWarm(), device="cpu",
              scan=PScan(affinity_lookahead=4, max_scan_len=2))
    base, _ = p_stream(arrivals, pods, snap, **kw)
    inj = p_faults.FaultInjector(
        {"solver.dispatch": p_faults.SiteSpec(kind="error", count=1, after=after)}, seed=1)
    lad = p_res.DegradationLadder(p_res.ResilienceConfig(
        enabled=True, max_wave_retries=0, breaker_threshold=1, probation_seconds=3600.0))
    got, stats = p_stream(arrivals, pods, snap, faults=inj, resilience=lad, **kw)
    assert got == base
    assert inj.total_fired() == 1 and lad.counters()["scan"]["stepDowns"] == 1
