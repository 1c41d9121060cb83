"""The port's degradation ladder and watchdog (grove_tpu_torch/solver/
resilience.py, solver/drain.py) against the JAX package's:

  - every breaker and ladder case of tests/test_resilience.py, run on both
    packages under one fake clock and compared transition for transition
    (each call's return value, the breaker states, counters, events);
  - the engine's watchdog (`_wave_hung`) with a fake CUDA event and a fake
    clock, no sleeps: a hang past the deadline, a result ready at the
    deadline, one ready after a few polls, no event (the CPU: no probe),
    an injected harvest timeout checked first, a double cancel;
  - drain_backlog with open rungs applied at construction: its harvest,
    pruning and portfolio equal the JAX drain's, and its admitted set the
    full-config drain's.
"""

from __future__ import annotations

import time

import jax  # JAX stays on the CPU: conftest forces the platform
import pytest

from grove_tpu import faults as r_faults
from grove_tpu.solver import resilience as r_res
from grove_tpu_torch import faults as p_faults
from grove_tpu_torch.solver import resilience as p_res
from grove_tpu_torch.solver.drain import DrainStats, WaveFault, _WavePipeline

MODS = (r_res, p_res)


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


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    r_faults.install(None)
    p_faults.install(None)


def breaker_state(br) -> tuple:
    return (br.state, list(br.failures), br.opened_at, br.trial_pending, br.step_downs,
            br.step_ups)


def run_both(case):
    """Run `case(mod, trace)` on the JAX module and the port's; the traces
    (every call's result and state, in order) must be equal. Returns the
    port's trace."""
    traces = []
    for mod in MODS:
        trace: list = []
        case(mod, trace)
        traces.append(trace)
    assert traces[1] == traces[0]
    return traces[1]


# ---- circuit breaker --------------------------------------------------------------


def test_breaker_opens_after_threshold_within_window():
    def case(m, t):
        br = m.CircuitBreaker(threshold=3, window_s=10.0, probation_s=5.0)
        t += [br.record_failure(0.0), br.record_failure(1.0), br.record_failure(2.0),
              breaker_state(br), br.allow(3.0)]

    t = run_both(case)
    assert t[:3] == [False, False, True] and t[3][0] == "open" and t[4] is False


def test_breaker_window_expires_old_failures():
    def case(m, t):
        br = m.CircuitBreaker(threshold=3, window_s=10.0)
        for ts in (0.0, 1.0, 20.0, 21.0):
            t.append(br.record_failure(ts))
        t.append(breaker_state(br))

    assert run_both(case)[-1][0] == "closed"


def test_breaker_half_open_trial_success_closes():
    def case(m, t):
        br = m.CircuitBreaker(threshold=1, probation_s=5.0)
        t += [br.record_failure(0.0), br.state, br.allow(4.9), br.allow(5.0), br.state,
              br.record_success(5.1), breaker_state(br)]

    t = run_both(case)
    assert t[3] is True and t[4] == "half-open" and t[5] is True and t[6][0] == "closed"


def test_breaker_half_open_trial_failure_reopens():
    def case(m, t):
        br = m.CircuitBreaker(threshold=1, probation_s=5.0)
        br.record_failure(0.0)
        t += [br.allow(5.0), br.record_failure(5.1), breaker_state(br), br.allow(9.0),
              br.allow(10.2)]

    t = run_both(case)
    assert t[1] is False and t[2][4] == 1 and t[3:] == [False, True]


def test_breaker_success_in_closed_is_noop():
    def case(m, t):
        br = m.CircuitBreaker()
        t += [br.record_success(0.0), breaker_state(br)]

    assert run_both(case) == [False, ("closed", [], 0.0, False, 0, 0)]


def test_breaker_sustained_faults_do_not_flap():
    def case(m, t):
        br = m.CircuitBreaker(threshold=1, probation_s=5.0)
        br.record_failure(0.0)
        now = 0.0
        for _ in range(10):
            t.append(br.allow(now + 4.9))
            now += 5.0
            t += [br.allow(now), br.allow(now), br.allow(now + 1.0)]
            now += 2.0
            t += [br.record_failure(now), breaker_state(br)]

    t = run_both(case)
    assert t[-1][4:] == (1, 0)  # one step-down, no eager close


def test_breaker_success_without_dispensed_probe_does_not_close():
    def case(m, t):
        br = m.CircuitBreaker(threshold=1, probation_s=5.0)
        br.record_failure(0.0)
        t += [br.record_success(6.0), br.state, br.allow(6.0), br.record_success(6.5),
              breaker_state(br)]

    assert run_both(case)[:4] == [False, "open", True, True]


# ---- degradation ladder -----------------------------------------------------------


def ladder(mod, now, threshold=1, probation=5.0, **kw):
    cfg = mod.ResilienceConfig(enabled=True, breaker_threshold=threshold,
                               probation_seconds=probation, breaker_window_seconds=60.0, **kw)
    events: list = []
    lad = mod.DegradationLadder(cfg, clock=lambda: now[0],
                                on_event=lambda ev, s: events.append((ev, s)))
    return lad, events


def test_ladder_success_does_not_close_untried_half_open_breaker():
    def case(m, t):
        now = [0.0]
        lad, events = ladder(m, now)
        t += [lad.record_failure("mesh"), lad.record_failure("pruning")]
        now[0] = 6.0
        t += [lad.allows("pruning"), lad.record_success(), lad.breakers["mesh"].state]
        now[0] = 7.0
        t += [lad.allows("mesh"), lad.record_success(), lad.fully_closed(), events, lad.stats()]

    t = run_both(case)
    assert t[3] == ["pruning"] and t[4] == "open" and t[6] == ["mesh"] and t[7] is True


def test_unattributed_failures_walk_down_the_ladder_in_order():
    def case(m, t):
        now = [0.0]
        lad, events = ladder(m, now)
        t += [lad.record_failure() for _ in range(7)]
        t += [events, lad.fully_closed(), lad.counters()]

    t = run_both(case)
    assert t[:7] == [*p_res.SUBSYSTEMS, None]
    assert t[7] == [("step_down", s) for s in p_res.SUBSYSTEMS]


def test_active_filter_skips_inactive_rungs():
    def case(m, t):
        lad, _ = ladder(m, [0.0])
        t += [lad.record_failure(active=("pipeline",)),
              lad.record_failure(active=("scan", "pruning")),
              lad.record_failure(active=("pipeline",)), lad.wave_failures]

    assert run_both(case) == ["pipeline", "scan", None, 3]


def test_ladder_probation_trial_and_step_up():
    def case(m, t):
        now = [0.0]
        lad, events = ladder(m, now, probation=5.0)
        lad.record_failure("pruning")
        t.append(lad.allows("pruning"))
        now[0] = 6.0
        t += [lad.allows("pruning"), list(events), lad.record_success(), list(events),
              lad.fully_closed(), lad.counters()["pruning"], lad.stats()]

    t = run_both(case)
    assert t[:2] == [False, True] and ("trial", "pruning") in t[2]
    assert t[3] == ["pruning"] and t[5] is True and t[6] == {"stepDowns": 1, "stepUps": 1}


def test_ladder_under_a_step_clock():
    """A long mixed sequence under a counter clock (the clock the stream
    parity tests give both ladders): every transition equal."""
    def case(m, t):
        tick = [0]

        def clock():
            tick[0] += 1
            return tick[0] * 0.004

        cfg = m.ResilienceConfig(enabled=True, breaker_threshold=2, probation_seconds=0.02,
                                 breaker_window_seconds=0.1)
        events: list = []
        lad = m.DegradationLadder(cfg, clock=clock, on_event=lambda ev, s: events.append((ev, s)))
        for i in range(60):
            if i % 7 in (0, 1, 3):
                t.append(lad.record_failure(active=("resident", "scan", "pruning", "pipeline")))
            for s in ("scan", "pruning", "pipeline"):
                t.append(lad.allows(s))
            t.append(lad.record_success())
        t += [events, lad.stats()]

    t = run_both(case)
    assert any(ev == "step_up" for ev, _ in t[-2]) and any(ev == "trial" for ev, _ in t[-2])


def test_ladder_on_event_failure_never_breaks_recovery():
    def boom(ev, s):
        raise RuntimeError("observability down")

    lad = p_res.DegradationLadder(p_res.ResilienceConfig(enabled=True, breaker_threshold=1),
                                  on_event=boom)
    assert lad.record_failure() == "resident"


def test_ladder_stats_shape():
    lad, _ = ladder(p_res, [0.0])
    doc = lad.stats()
    assert set(doc["subsystems"]) == set(p_res.SUBSYSTEMS)
    assert {"state", "stepDowns", "stepUps", "recentFailures"} <= set(doc["subsystems"]["mesh"])
    r_lad, _ = ladder(r_res, [0.0])
    assert r_lad.stats() == doc


def test_resilience_config_fields_equal_jax():
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(p_res.ResilienceConfig) == fields(r_res.ResilienceConfig)
    assert p_res.SUBSYSTEMS == r_res.SUBSYSTEMS


def test_ladder_for_normalization():
    lad = p_res.DegradationLadder(p_res.ResilienceConfig(enabled=True))
    assert p_res.ladder_for(lad) is lad
    assert p_res.ladder_for(None) is None
    assert p_res.ladder_for(p_res.ResilienceConfig(enabled=False)) is None
    assert isinstance(p_res.ladder_for(p_res.ResilienceConfig(enabled=True)),
                      p_res.DegradationLadder)
    with pytest.raises(TypeError):
        p_res.ladder_for("nope")
    with pytest.raises(TypeError):
        p_res.ladder_for(r_res.ResilienceConfig(enabled=True))  # the JAX package's type


# ---- the watchdog (fake event, fake clock; no sleeps) ---------------------------


def bare_engine(**attrs):
    eng = object.__new__(_WavePipeline)
    eng.faults = None
    eng.watchdog_s = None
    eng.clock = time.perf_counter
    eng.watchdog_poll_s = 0.0
    eng.stats = DrainStats()
    for k, v in attrs.items():
        setattr(eng, k, v)
    return eng


class FakeEvent:
    """A CUDA event's `query()`: False for `ready_after_polls` calls."""

    def __init__(self, ready_after_polls: int):
        self.polls_left = ready_after_polls
        self.queries = 0

    def query(self):
        self.queries += 1
        if self.polls_left <= 0:
            return True
        self.polls_left -= 1
        return False


def test_watchdog_hung_event_times_out_without_sleeping():
    now = [100.0]
    eng = bare_engine(watchdog_s=5.0, clock=lambda: now[0])
    ev = FakeEvent(ready_after_polls=10**9)
    assert eng._wave_hung({"event": ev, "dispatched_at": 0.0}) is True
    assert ev.queries == 1


def test_watchdog_timeout_racing_normal_retirement_prefers_the_result():
    eng = bare_engine(watchdog_s=5.0, clock=lambda: 100.0)
    assert eng._wave_hung({"event": FakeEvent(0), "dispatched_at": 0.0}) is False


def test_watchdog_result_ready_after_a_few_polls_inside_deadline():
    ticks = iter(range(100))
    eng = bare_engine(watchdog_s=5.0, clock=lambda: float(next(ticks)))
    ev = FakeEvent(ready_after_polls=3)
    assert eng._wave_hung({"event": ev, "dispatched_at": 0.0}) is False
    assert ev.queries == 4


def test_watchdog_times_out_at_its_deadline():
    ticks = iter(range(100))
    eng = bare_engine(watchdog_s=5.0, clock=lambda: float(next(ticks)))
    ev = FakeEvent(ready_after_polls=10**9)
    assert eng._wave_hung({"event": ev, "dispatched_at": 0.0}) is True
    assert ev.queries == 6  # clock 0..5: the sixth reading reaches the deadline


def test_watchdog_reads_a_scan_chunks_event():
    eng = bare_engine(watchdog_s=5.0, clock=lambda: 100.0)
    group = {"event": FakeEvent(10**9)}
    assert eng._wave_hung({"scan_group": group, "dispatched_at": 0.0}) is True
    group_done = {"ok_np": object()}  # fetched: its event is gone
    assert eng._wave_hung({"scan_group": group_done, "dispatched_at": 0.0}) is False


def test_watchdog_no_event_has_no_probe():
    """On the CPU a wave has no event: the watchdog declines rather than
    guessing, as the JAX package's does for a result without is_ready."""
    eng = bare_engine(watchdog_s=0.001, clock=lambda: 1e9)
    assert eng._wave_hung({"event": None, "dispatched_at": 0.0}) is False
    from grove_tpu.solver.drain import _WavePipeline as RPipeline

    r_eng = object.__new__(RPipeline)
    r_eng.faults, r_eng.watchdog_s, r_eng.clock = None, 0.001, lambda: 1e9
    r_eng.watchdog_poll_s = 0.0
    assert r_eng._wave_hung({"ok": object(), "dispatched_at": 0.0}) is False


def test_watchdog_injected_harvest_timeout_is_checked_first():
    inj = p_faults.FaultInjector(
        {"solver.harvest": p_faults.SiteSpec(kind="timeout", count=1)}, seed=0)
    eng = bare_engine(faults=inj, watchdog_s=None)
    ev = FakeEvent(0)
    assert eng._wave_hung({"event": ev, "seq": 3}) is True  # no probe was needed
    assert ev.queries == 0
    assert eng._wave_hung({"event": ev, "seq": 4}) is False  # count spent, no watchdog


def staged(dispatched_at: float) -> dict:
    """A dispatched wave's holder: its staged verdict planes, not yet fetched."""
    import torch

    return {"host": [torch.ones(1, dtype=torch.bool), torch.zeros(1),
                     torch.zeros((1, 1), dtype=torch.int32)],
            "event": None, "ok_np": None, "dispatched_at": dispatched_at}


@pytest.mark.parametrize("ready_after_polls,fetched,queries", [(3, True, 4), (10**9, False, 7)])
def test_batched_harvest_polls_the_newest_event_against_the_oldest_deadline(
        ready_after_polls, fetched, queries):
    """The resident and chained harvest with the watchdog armed: one wait
    on the newest event, polled against the oldest unfetched wave's
    deadline (clock 1 + 5 s). Past it nothing is fetched, so every wave
    retires through `_fetch`, whose watchdog probes its own event."""
    ticks = iter(range(100))
    ev = FakeEvent(ready_after_polls)
    group = staged(0.0)  # a scan chunk's shared holder
    inflight = [staged(2.0), {"scan_group": group, "scan_pos": 0, "dispatched_at": 1.0},
                {"scan_group": group, "scan_pos": 1, "dispatched_at": 1.0}, staged(3.0)]
    eng = bare_engine(watchdog_s=5.0, clock=lambda: float(next(ticks)), inflight=inflight,
                      _last_event=ev, _t0_event=None)
    eng.harvest_inflight()
    assert ev.queries == queries
    holders = (inflight[0], group, inflight[3])
    assert [h["ok_np"] is not None for h in holders] == [fetched] * 3
    assert eng.stats.device_roundtrips == int(fetched)


def test_batched_harvest_without_the_watchdog_waits_once():
    class BlockingEvent:
        waits = 0

        def synchronize(self):
            self.waits += 1

    ev = BlockingEvent()
    inflight = [staged(0.0), staged(1.0)]
    eng = bare_engine(inflight=inflight, _last_event=ev, _t0_event=None)
    eng.harvest_inflight()
    eng.harvest_inflight()  # nothing left unfetched: no second wait
    assert ev.waits == 1 and eng.stats.device_roundtrips == 1
    assert all(r["ok_np"] is not None for r in inflight)


def test_double_cancel_is_noop():
    eng = bare_engine()
    rec = {"ok_np": object(), "cancelled": False}
    assert eng.cancel_wave(rec) is True
    assert rec["ok_np"] is None
    assert eng.cancel_wave(rec) is False
    assert eng.stats.waves_cancelled == 1


def test_redispatch_without_a_retained_carry_raises():
    eng = bare_engine()
    with pytest.raises(WaveFault) as ei:
        eng._redispatch({"free_in": None})
    assert ei.value.in_flight and not ei.value.fatal


# ---- drain_backlog: open rungs at construction ------------------------------------


def world(wl, build, racks=2, hosts=6, duration_s=4.0, rate=4.0):
    topo = wl.bench_topology()
    nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=racks,
                                 hosts_per_rack=hosts)
    arrivals, pods = wl.expand_arrivals(wl.arrival_process(20260804, duration_s=duration_s,
                                                           base_rate=rate))
    return [g for _, g in arrivals], pods, build(nodes, topo)


PRUNING = dict(enabled=True, min_fleet=8, min_pad=4, pad_ladder=(4, 8, 16), max_candidates=8)


@pytest.fixture(scope="module")
def worlds():
    from grove_tpu.sim import workloads as r_wl
    from grove_tpu.state import build_snapshot as r_snap
    from grove_tpu_torch.sim import workloads as p_wl
    from grove_tpu_torch.state import build_snapshot as p_snap

    return {"jax": world(r_wl, r_snap), "port": world(p_wl, p_snap)}


@pytest.fixture(scope="module")
def drains():
    """Each package's drain_backlog, PruningConfig, resilience module and
    one WarmPath for the module (the JAX compiles are paid once per shape),
    with a memo of the full-config drains the cases share."""
    from grove_tpu.solver.drain import drain_backlog as r_drain
    from grove_tpu.solver.pruning import PruningConfig as RPruning
    from grove_tpu.solver.warm import WarmPath as RWarm
    from grove_tpu_torch.solver.drain import drain_backlog as p_drain
    from grove_tpu_torch.solver.pruning import PruningConfig as PPruning
    from grove_tpu_torch.solver.warm import WarmPath as PWarm

    return {"jax": (r_drain, r_res, RPruning, RWarm(), {}),
            "port": (p_drain, p_res, PPruning, PWarm(), {"device": "cpu"}),
            "full": {}}


@pytest.mark.parametrize("open_rungs,harvest,portfolio", [
    (("pruning", "pipeline"), "pipeline", 1),
    (("resident",), "resident", 1),
    (("resident", "scan"), "resident", 1),
    (("scan", "pipeline"), "scan", 1),
    (("portfolio",), "pipeline", 2),
    ((), "resident", 1),
])
def test_drain_backlog_applies_open_rungs_at_construction(worlds, drains, open_rungs, harvest,
                                                          portfolio):
    """The batch drain consults the ladder once up front: its effective
    harvest, pruning and portfolio equal the JAX drain's, and it admits the
    full-config drain's set."""
    out = {}
    for pkg in ("jax", "port"):
        drain, res, pcfg, wp, kw = drains[pkg]
        gangs, pods, snap = worlds[pkg]
        pruning = pcfg(**PRUNING) if portfolio == 1 else None
        key = (pkg, harvest, portfolio)
        if key not in drains["full"]:
            drains["full"][key] = drain(gangs, pods, snap, wave_size=16, warm_path=wp,
                                        pruning=pruning, harvest=harvest, portfolio=portfolio,
                                        **kw)
        full, full_stats = drains["full"][key]
        lad = res.DegradationLadder(res.ResilienceConfig(enabled=True, breaker_threshold=1,
                                                         probation_seconds=3600.0))
        for rung in open_rungs:
            lad.record_failure(rung)
        degraded, stats = drain(gangs, pods, snap, wave_size=16, warm_path=wp,
                                pruning=pruning, harvest=harvest, portfolio=portfolio,
                                resilience=lad, **kw)
        assert set(degraded) == set(full)
        assert not any(stats.resilience_doc().values())
        out[pkg] = (stats.harvest, stats.depth, stats.pruned_waves, stats.scan_chunks,
                    full_stats.pruned_waves > 0 or portfolio > 1, stats.admitted, stats.waves,
                    stats.dispatches, stats.device_roundtrips, lad.stats())
    assert out["port"] == out["jax"]
    if "pruning" in open_rungs:
        assert out["port"][2] == 0  # dense
    if "pipeline" in open_rungs:
        assert out["port"][0] == "wave"


def test_drain_backlog_mesh_on_one_card_counts_a_fallback(worlds):
    from grove_tpu_torch.parallel.mesh import MeshConfig, shard_fallbacks
    from grove_tpu_torch.solver.drain import drain_backlog as p_drain
    from grove_tpu_torch.solver.warm import WarmPath as PWarm

    gangs, pods, snap = worlds["port"]
    base, _ = p_drain(gangs, pods, snap, wave_size=16, warm_path=PWarm(), device="cpu")
    n0 = shard_fallbacks()
    got, stats = p_drain(gangs, pods, snap, wave_size=16, warm_path=PWarm(), device="cpu",
                         mesh=MeshConfig(enabled=True, min_nodes=8))
    assert got == base
    assert (stats.shard_fallbacks, shard_fallbacks() - n0) == (1, 1)
    _, stats = p_drain(gangs, pods, snap, wave_size=16, warm_path=PWarm(), device="cpu",
                       mesh=MeshConfig(enabled=False))
    assert stats.shard_fallbacks == 0
    with pytest.raises(TypeError):
        p_drain(gangs, pods, snap, wave_size=16, device="cpu", mesh="8 devices")


def test_drain_backlog_raw_error_propagates_without_resilience(worlds, monkeypatch):
    """Resilience off (no ladder, no injector): a launch's error propagates
    unchanged, neither retried nor wrapped; with a ladder armed it is retried
    and then surfaces as WaveFault — never a quiet step to a plain version."""
    from grove_tpu_torch.solver.drain import drain_backlog as p_drain
    from grove_tpu_torch.solver.warm import ExecutableCache, WarmPath as PWarm

    gangs, pods, snap = worlds["port"]
    calls = []

    def broken(self, *a, **k):
        calls.append(1)
        raise ValueError("kernel error")

    monkeypatch.setattr(ExecutableCache, "solve", broken)
    with pytest.raises(ValueError, match="kernel error"):
        p_drain(gangs, pods, snap, wave_size=16, warm_path=PWarm(), device="cpu",
                harvest="pipeline")
    assert len(calls) == 1
    lad = p_res.DegradationLadder(p_res.ResilienceConfig(enabled=True, max_wave_retries=2))
    calls.clear()
    with pytest.raises(WaveFault) as ei:
        p_drain(gangs, pods, snap, wave_size=16, warm_path=PWarm(), device="cpu",
                harvest="pipeline", resilience=lad)
    assert len(calls) == 3 and not ei.value.in_flight
    assert isinstance(ei.value.__cause__, ValueError)
