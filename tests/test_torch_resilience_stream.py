"""The port's drains under faults and the degradation ladder (plain PyTorch
versions, device="cpu") against the JAX package's, on the JAX tests' own
fleet and trace (tests/test_resilience.py: 24 nodes, arrival_process(
20260804, 6 s, rate 4), wave_size 16, depth 2):

  - the stream chaos run, pipelined (the JAX test's schedule) and resident
    scanned (the chaos bench's schedule), in both packages under the same
    step clock: the bindings equal the fault-free run's and JAX's, and the
    resilience counters, the ladder's transitions, the journaled
    `fault.injected` records and each journaled wave's effective config
    equal JAX's; the port's chaos journal and JAX's both replay in the port
    with 0 divergences;
  - harvest hangs absorbed by the watchdog alone (on the chaos trace), a
    fault without a ladder raising WaveFault, the bottom of the ladder
    re-raising;
  - a dispatch fault inside a scan chunk under the ladder: its waves are
    resubmitted one by one to the fault-free bindings, with JAX's counters.

Re-dispatch against the live carry and WaveFault.pending are in
tests/test_torch_resilience_drain.py.
"""

from __future__ import annotations

import itertools

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu import faults as r_faults
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import resilience as r_res
from grove_tpu.solver.drain import ScanConfig as RScan
from grove_tpu.solver.drain import WaveFault as RWaveFault
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.pruning import PruningConfig as RPruning
from grove_tpu.solver.stream import StreamConfig as RStreamConfig
from grove_tpu.solver.stream import drain_stream as r_stream
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu.trace.recorder import TraceRecorder as RRecorder
from grove_tpu_torch import faults as p_faults
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import resilience as p_res
from grove_tpu_torch.solver.drain import ScanConfig as PScan
from grove_tpu_torch.solver.drain import WaveFault as PWaveFault
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.pruning import PruningConfig as PPruning
from grove_tpu_torch.solver.stream import StreamConfig as PStreamConfig
from grove_tpu_torch.solver.stream import drain_stream as p_stream
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from grove_tpu_torch.state import build_snapshot as p_snapshot
from grove_tpu_torch.trace.recorder import TraceRecorder as PRecorder
from grove_tpu_torch.trace.recorder import read_journal
from grove_tpu_torch.trace.replay import replay_journal

SEED = 20260804
PKG = {
    "jax": dict(faults=r_faults, res=r_res, scan=RScan, fault_t=RWaveFault, drain=r_drain,
                pruning=RPruning, cfg=RStreamConfig, stream=r_stream, warm=RWarm,
                recorder=RRecorder, kw={}),
    "port": dict(faults=p_faults, res=p_res, scan=PScan, fault_t=PWaveFault, drain=p_drain,
                 pruning=PPruning, cfg=PStreamConfig, stream=p_stream, warm=PWarm,
                 recorder=PRecorder, kw={"device": "cpu"}),
}
LEDGER = ("waves", "dispatches", "device_roundtrips", "scan_chunks", "scanned_waves",
          "escalations", "escalations_adopted", "pruned_waves", "journaled_waves",
          "exec_cache_hits", "exec_cache_misses", "lowerings")


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


def step_clock(dt=0.001):
    """A clock that advances `dt` per reading: both packages' ladders see
    the same times at the same calls."""
    c = itertools.count(1)
    return lambda: next(c) * dt


def injector(m, specs: dict):
    return m["faults"].FaultInjector({s: m["faults"].SiteSpec(**kw) for s, kw in specs.items()},
                                     seed=SEED)


def ladder(m, **cfg):
    return m["res"].DegradationLadder(m["res"].ResilienceConfig(enabled=True, **cfg),
                                      clock=step_clock())


def fault_records(records) -> list:
    return [(r["action"], r["object"], r.get("faultKind"), r.get("wave")) for r in records
            if r.get("kind") == "action" and r.get("action") == "fault.injected"]


def wave_configs(records) -> list:
    """Each journaled wave's effective config: its id, solver block
    (weights, portfolio, pruning), whether it carries a candidate list, and
    its plan."""
    return [(r["wave"], r["solver"], "candidates" in r, r["plan"]) for r in records
            if r.get("kind") == "wave"]


CHAOS = {
    "pipelined": dict(
        scan=None,
        faults={"solver.dispatch": dict(kind="error", rate=1.0, count=3, after=1),
                "solver.harvest": dict(kind="timeout", rate=1.0, count=2, after=4)},
        ladder=dict(max_wave_retries=1, breaker_threshold=2, breaker_window_seconds=300.0,
                    probation_seconds=0.01)),
    "resident": dict(
        scan=True,
        faults={"solver.dispatch": dict(kind="error", rate=1.0, count=16, after=2),
                "solver.harvest": dict(kind="timeout", rate=1.0, count=3, after=6)},
        ladder=dict(watchdog_seconds=30.0, max_wave_retries=1, breaker_threshold=2,
                    breaker_window_seconds=300.0, probation_seconds=0.02)),
}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_stream_chaos_parity_and_recovery(tmp_path, case, wp):
    spec = CHAOS[case]
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg)
        cfg = m["cfg"](depth=2, wave_size=16)
        kw = dict(config=cfg, warm_path=wp[pkg], pruning=m["pruning"](enabled=True, min_fleet=8),
                  **m["kw"])
        if spec["scan"]:
            kw["scan"] = m["scan"](device_resident=True)
        base, base_stats = m["stream"](arrivals, pods, snap, **kw)
        assert base_stats.admitted > 0
        inj = injector(m, spec["faults"])
        lad = ladder(m, **spec["ladder"])
        path = str(tmp_path / pkg)
        rec = m["recorder"](path)
        rec.start()
        inj.recorder = rec
        try:
            chaos, stats = m["stream"](arrivals, pods, snap, faults=inj, resilience=lad,
                                       recorder=rec, **kw)
            assert rec.flush()
        finally:
            rec.stop()
        assert chaos == base  # faults changed latency, never placements
        records = read_journal(path)
        assert len(fault_records(records)) == inj.total_fired() > 0
        counters = lad.counters()
        assert sum(c["stepDowns"] for c in counters.values()) > 0
        assert sum(c["stepUps"] for c in counters.values()) > 0
        assert lad.fully_closed()
        assert stats.drain.wave_retries > 0 and stats.drain.watchdog_timeouts > 0
        report = replay_journal(records, warm_path=PWarm(), device="cpu")
        assert report.divergence_count == 0 and len(report.waves) == stats.waves
        out[pkg] = dict(
            bindings=chaos, res=stats.drain.resilience_doc(), ladder=lad.stats(),
            events=fault_records(records), configs=wave_configs(records),
            fired=inj.stats(), doc=stats.to_doc().get("waveRetries"),
            ledger={k: getattr(stats.drain, k) for k in LEDGER},
        )
    for key in out["port"]:
        assert out["port"][key] == out["jax"][key], key


def test_stream_harvest_hangs_absorbed_by_watchdog_alone(wp):
    """Hangs within the engine's re-dispatch budget never reach the ladder
    (the JAX test's case, on the chaos runs' trace and pruning, so the
    module's warm paths already hold its launches)."""
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg)
        kw = dict(config=m["cfg"](depth=2, wave_size=16), warm_path=wp[pkg],
                  pruning=m["pruning"](enabled=True, min_fleet=8), **m["kw"])
        base, _ = m["stream"](arrivals, pods, snap, **kw)
        inj = injector(m, {"solver.harvest": dict(kind="timeout", rate=1.0, count=2, after=2)})
        lad = ladder(m, max_wave_retries=2)
        chaos, stats = m["stream"](arrivals, pods, snap, faults=inj, resilience=lad, **kw)
        assert chaos == base
        assert stats.drain.watchdog_timeouts == 2 and stats.drain.wave_redispatches >= 1
        assert lad.fully_closed() and lad.wave_failures == 0
        out[pkg] = (chaos, stats.drain.resilience_doc(), lad.stats())
    assert out["port"] == out["jax"]


def test_stream_fault_without_ladder_raises_wavefault(wp):
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg, duration_s=3.0)
        inj = injector(m, {"solver.dispatch": dict(kind="error", rate=1.0, count=1)})
        with pytest.raises(m["fault_t"]) as ei:
            m["stream"](arrivals, pods, snap, config=m["cfg"](depth=2, wave_size=16),
                        warm_path=wp[pkg], faults=inj, **m["kw"])
        assert not ei.value.in_flight and not ei.value.fatal


def test_stream_fault_from_the_installed_injector():
    """faults=None reads the port's process-installed injector."""
    arrivals, pods, snap = world("port", duration_s=3.0)
    p_faults.install(p_faults.FaultInjector(
        {"solver.dispatch": p_faults.SiteSpec(kind="error", rate=1.0, count=1)}, seed=SEED))
    with pytest.raises(PWaveFault):
        p_stream(arrivals, pods, snap, config=PStreamConfig(depth=2, wave_size=16),
                 warm_path=PWarm(), device="cpu")


def test_stream_ladder_bottom_reraises(wp):
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg, duration_s=3.0)
        inj = injector(m, {"solver.dispatch": dict(kind="error", rate=1.0, count=0)})
        lad = ladder(m, max_wave_retries=0, breaker_threshold=1, probation_seconds=3600.0)
        with pytest.raises(m["fault_t"]):
            m["stream"](arrivals, pods, snap, config=m["cfg"](depth=2, wave_size=16),
                        warm_path=wp[pkg], pruning=m["pruning"](enabled=True, min_fleet=8),
                        faults=inj, resilience=lad, **m["kw"])
        assert not lad.fully_closed()  # it walked the ladder before giving up
        out[pkg] = (lad.stats(), inj.stats())
    assert out["port"] == out["jax"]


def test_stream_scan_chunk_fault_resubmits_pending(wp):
    """With a ladder: the failed chunk's waves are resubmitted one by one
    under the stepped-down config; the bindings equal the fault-free run and
    JAX's, and so do the counters."""
    out = {}
    for pkg, m in PKG.items():
        arrivals, pods, snap = world(pkg)
        kw = dict(config=m["cfg"](depth=2, wave_size=16), warm_path=wp[pkg],
                  scan=m["scan"](affinity_lookahead=2), **m["kw"])
        base, base_stats = m["stream"](arrivals, pods, snap, **kw)
        assert base_stats.drain.scan_chunks >= 2
        inj = injector(m, {"solver.dispatch": dict(kind="error", rate=1.0, count=2, after=1)})
        lad = ladder(m, max_wave_retries=1, breaker_threshold=1, probation_seconds=0.005)
        got, stats = m["stream"](arrivals, pods, snap, faults=inj, resilience=lad, **kw)
        assert got == base
        assert lad.counters()["scan"]["stepDowns"] == 1
        out[pkg] = (got, stats.drain.resilience_doc(), lad.stats(),
                    {k: getattr(stats.drain, k) for k in LEDGER})
    assert out["port"] == out["jax"]


def test_chaos_gate_holds_placements_unless_a_wave_was_pruned():
    """The chaos bench's zero_lost_gangs gate: without a pruned wave every
    rung binds bitwise alike, so a pod moved to another node, or another
    free capacity after, fails it; with a pruned wave only the admitted set
    is held (a dense step-down may bind other nodes)."""
    from types import SimpleNamespace

    import numpy as np

    from grove_tpu_torch.bench import same_as_baseline

    def stats(pruned, free):
        return SimpleNamespace(pruned_waves=pruned, free_after=np.asarray(free, np.float32))

    base = {"g0": {"p0": "n0"}, "g1": {"p1": "n1"}}
    moved = {"g0": {"p0": "n2"}, "g1": {"p1": "n1"}}
    assert same_as_baseline(dict(base), stats(0, [1, 2]), base, stats(0, [1, 2]))
    assert not same_as_baseline(moved, stats(0, [1, 2]), base, stats(0, [1, 2]))
    assert not same_as_baseline(dict(base), stats(0, [1, 3]), base, stats(0, [1, 2]))
    assert same_as_baseline(moved, stats(2, [1, 3]), base, stats(0, [1, 2]))
    assert not same_as_baseline({"g0": base["g0"]}, stats(2, [1, 2]), base, stats(0, [1, 2]))
