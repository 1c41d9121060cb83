"""The port's streaming drain with the flight recorder (plain PyTorch
versions on the CPU) against the JAX package's:

  - journals: the port's stream journal of bench.py's sweep-scenario trace
    equals the JAX package's record for record (ok, plan, scores, freeRows,
    candidates, scheduled, allocated, ids `stream-NNNNNN` in commit order),
    and port and JAX stream journals, dense and pruned, replay through the
    port with 0 divergences;
  - the committed tests/data/jax_stream_journal.json is current: recorded
    again with the JAX package, its waves are the same;
  - an order_key (the tenancy tier) forms the windows the JAX package forms.

The pruned stream is in tests/test_torch_stream_pruned.py.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver import stream as r_stream
from grove_tpu.solver.warm import WarmPath as RWarmPath
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu.trace import recorder as r_rec
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import stream as p_stream
from grove_tpu_torch.solver.warm import WarmPath as PWarmPath
from grove_tpu_torch.state import build_snapshot as p_snapshot
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.trace.replay import replay_journal
from test_torch_search import STREAM_JOURNAL, STREAM_WAVES, cut_journal, waves_of
from test_torch_stream import SLO_MIX, fleet, trace

WAVE_FIELDS = ("wave", "ok", "plan", "scores", "valid", "freeRows", "candidates", "scheduled",
               "allocated", "fleet", "solver", "padGangsTo", "maxGroups", "maxSets", "maxPods",
               "padNodesTo", "resources")


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


def recorded(side, path, arrivals, pods, snap, warm_path, **kw):
    """One stream with a flight recorder: (bindings, stats, records)."""
    mod, rec_mod = (r_stream, r_rec) if side == "jax" else (p_stream, p_rec)
    extra = {} if side == "jax" else {"device": "cpu"}
    rec = rec_mod.TraceRecorder(str(path))
    rec.start()
    try:
        bindings, stats = mod.drain_stream(arrivals, pods, snap,
                                           config=mod.StreamConfig(depth=2, wave_size=8),
                                           warm_path=warm_path, recorder=rec, **extra, **kw)
    finally:
        rec.stop()
    assert rec.dropped == 0
    return bindings, stats, rec_mod.read_journal(str(path))


@pytest.fixture(scope="module")
def warm_paths():
    """One warm path per package for the module: JAX compiles each shape once."""
    return {"jax": RWarmPath(), "port": PWarmPath()}


@pytest.fixture(scope="module")
def sweep_journals(tmp_path_factory, warm_paths):
    """bench.py's sweep-scenario trace streamed and journaled by each package."""
    d = tmp_path_factory.mktemp("stream_journals")
    return {
        "jax": recorded("jax", d / "jax", *trace(r_wl), fleet(r_wl, r_snapshot),
                        warm_paths["jax"]),
        "port": recorded("port", d / "port", *trace(p_wl), fleet(p_wl, p_snapshot),
                         warm_paths["port"]),
    }


def test_port_stream_journal_equals_jax(sweep_journals):
    jb, jst, jrec = sweep_journals["jax"]
    pb, pst, precs = sweep_journals["port"]
    assert pb == jb
    assert pst.drain.journaled_waves == pst.waves == jst.waves == len(waves_of(precs))
    names = [w["wave"] for w in waves_of(precs)]
    assert names == [f"stream-{i:06d}" for i in range(len(names))]
    for a, b in zip(waves_of(jrec), waves_of(precs)):
        for f in WAVE_FIELDS:
            assert a.get(f) == b.get(f), (a["wave"], f)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_port_replays_stream_journals(sweep_journals, side):
    report = replay_journal(sweep_journals[side][2], device="cpu")
    assert report.waves and report.divergence_count == 0, report.to_doc()


def test_committed_stream_journal_is_current(sweep_journals):
    committed = waves_of(p_rec.read_journal(str(STREAM_JOURNAL)))
    fresh = waves_of(cut_journal(sweep_journals["jax"][2], STREAM_WAVES))
    assert len(committed) == len(fresh) == STREAM_WAVES
    for a, b in zip(committed, fresh):
        for f in WAVE_FIELDS:
            assert a.get(f) == b.get(f), (a["wave"], f)


def test_order_key_forms_the_windows_jax_forms(warm_paths, sweep_journals, monkeypatch):
    """A tenancy order_key (latency before standard before batch) stable-sorts
    the queue before each window: the windows, wave for wave, equal JAX's."""
    rank = {"latency": 0, "standard": 1, "batch-preemptible": 2}

    def key(g):
        return rank.get(g.slo_class, 1)

    windows = {}
    for side, mod, wl, build in (("jax", r_stream, r_wl, r_snapshot),
                                 ("port", p_stream, p_wl, p_snapshot)):
        wp = warm_paths[side]  # most shapes are prepared already
        seen = windows.setdefault(side, [])
        plan = mod.plan_waves

        def spy(window, wave_size, plan=plan, seen=seen):
            seen.append([g.name for g in window])
            return plan(window, wave_size)

        monkeypatch.setattr(mod, "plan_waves", spy)
        arrivals, pods = trace(wl, duration_s=4.0, slo_mix=SLO_MIX)
        extra = {} if side == "jax" else {"device": "cpu"}
        bindings, stats = mod.drain_stream(arrivals, pods, fleet(wl, build),
                                           config=mod.StreamConfig(wave_size=8), warm_path=wp,
                                           order_key=key, **extra)
        windows[side + "_result"] = (bindings, stats.windows)
        assert stats.windows == len(seen)
    assert windows["port"] == windows["jax"]
    assert windows["port_result"] == windows["jax_result"]
    unsorted = [g.name for _, g in trace(p_wl, duration_s=4.0, slo_mix=SLO_MIX)[0]][:8]
    assert windows["port"][0] != unsorted  # the key reordered the first window
