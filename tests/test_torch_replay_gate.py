"""The record-overhead reading (grove_tpu_torch/bench.py
`read_record_overhead`, which `run_replay_bench` and chip_smoke.py phase
15 (b) read bench.py's gate through), the writer's flush path of the port's
flight recorder, and the `solver.streaming.pollS` field:

  - the schedule: an untimed calibration window sets the drain count and is
    in neither sum; every ON window's `recorder.flush()` falls inside its
    timing and its start and stop outside; the overhead is bench.py's own
    expression (read from bench.py) on the windows' seconds a drain; A/A
    windows run no recorder;
  - the per-window readings (the draining thread's CPU seconds and context
    switches) and the writer thread's CPU seconds and switches are present;
  - `pollS` parses through both packages' `load_operator_config` to equal
    StreamConfigs, and a paced stream run under a non-default poll sleeps
    no longer than it and equals the JAX package's run, seconds aside.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import pathlib
import tempfile
import time

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import yaml

from grove_tpu_torch import bench as p_bench
from grove_tpu_torch.trace import recorder as p_rec
from torch_jax_programs import _release_jax_programs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent


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


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeRecorder:
    """start/flush/stop/stats(split=True) on a fake clock: its flush takes
    FLUSH_S and records when it ran; start and stop record too."""

    FLUSH_S = 3.0

    def __init__(self, clock, log):
        self.clock, self.log = clock, log
        self.path = tempfile.mkdtemp(prefix="fake-rec-")

    def start(self):
        self.log.append(("start", self.clock.t))

    def flush(self, timeout=5.0):
        self.log.append(("flush", self.clock.t))
        self.clock.t += self.FLUSH_S
        return True

    def stop(self):
        self.log.append(("stop", self.clock.t))

    def stats(self, split=False):
        return {"split": {p: {"s": 0.001, "n": 1} for p in p_rec.SPLIT_PARTS},
                "writerCpuSeconds": 0.002, "writerSwitches": [3, 1]}


def fake_reading(window_s=25.0, rounds=3, aa=False, off_s=10.0, on_s=11.0):
    clock, log = FakeClock(), []

    def drain(recorder):
        log.append(("drain", clock.t, recorder is not None))
        clock.t += off_s if recorder is None else on_s
        return 4

    reading = p_bench.read_record_overhead(
        drain, lambda: FakeRecorder(clock, log), window_s=window_s, rounds=rounds, aa=aa,
        clock=clock)
    return reading, log


def bench_py_overhead(wall_on: float, wall_off: float) -> float:
    """bench.py's own expression for the overhead (run_replay_bench's
    `overhead = ...` assignment), evaluated on the given walls."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_replay_bench")
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "overhead" for t in n.targets))
    expr = ast.Expression(node.value)
    return eval(compile(expr, "bench.py", "eval"), {}, {"wall_on": wall_on, "wall_off": wall_off})


def test_calibration_window_is_in_neither_sum():
    reading, log = fake_reading(window_s=25.0, rounds=3)
    # 25 fake seconds of 10 s drains: 3 drains (the third passes 25 s).
    assert reading["calibration"] == [3, 30.0]
    w = reading["windows"]
    assert [x[0] for x in w] == ["off", "on", "on", "off", "on", "off", "off", "on",
                                 "off", "on", "on", "off"]
    assert all(x[1] == 3 for x in w)
    # Summed over the 12 timed windows only: 6 OFF windows of 30 s and 6 ON
    # windows of 3 drains of 11 s and one 3 s flush.
    assert reading["split"]["drains"] == 18
    assert reading["wall_off"] == pytest.approx(10.0)
    assert reading["wall_on"] == pytest.approx((3 * 11.0 + 3.0) / 3)
    calibration_drains = [e for e in log[:3] if e[0] == "drain"]
    assert len(calibration_drains) == 3 and not any(e[2] for e in calibration_drains)


def test_every_on_flush_falls_inside_its_window():
    reading, log = fake_reading(window_s=25.0, rounds=2)
    w = reading["windows"]
    on_walls = [x[2] for x in w if x[0] == "on"]
    off_walls = [x[2] for x in w if x[0] == "off"]
    # Each ON window's wall holds its flush; OFF windows have none.
    assert on_walls == [3 * 11.0 + FakeRecorder.FLUSH_S] * 4
    assert off_walls == [30.0] * 4
    # Start, the window's drains, the flush, then stop, in that order; start
    # and stop at the fake clock's reading outside the flush.
    events = [e[0] for e in log if e[0] in ("start", "flush", "stop")]
    assert events == ["start", "flush", "stop"] * 4
    assert sum(1 for e in log if e[0] == "drain" and e[2]) == 4 * 3
    # The split and the writer's CPU of the four recorders add up.
    assert reading["split"]["parts"]["render"] == {"s": pytest.approx(0.004), "n": 4}
    assert reading["split"]["writer_cpu_s"] == pytest.approx(0.008)
    assert reading["split"]["writer_switches"] == [12, 4]


@pytest.mark.parametrize("walls", [(10.0, 11.0), (10.0, 10.0), (12.5, 11.0)],
                         ids=["slower", "equal", "faster"])
def test_overhead_is_bench_py_formula_on_fixed_walls(walls):
    off_s, on_s = walls
    reading, _ = fake_reading(window_s=0.0, rounds=4, off_s=off_s, on_s=on_s)
    assert reading["calibration"] is None and all(x[1] == 1 for x in reading["windows"])
    want_on = on_s + FakeRecorder.FLUSH_S
    assert reading["wall_off"] == pytest.approx(off_s)
    assert reading["wall_on"] == pytest.approx(want_on)
    assert reading["overhead"] == bench_py_overhead(reading["wall_on"], reading["wall_off"])
    assert reading["overhead"] == pytest.approx((want_on - off_s) / off_s)


def test_aa_windows_run_no_recorder():
    reading, log = fake_reading(window_s=25.0, rounds=2, aa=True)
    assert not any(e[0] in ("start", "flush", "stop") for e in log)
    assert not any(e[2] for e in log if e[0] == "drain")
    assert reading["overhead"] == 0.0 and reading["split"]["writer_cpu_s"] == 0.0


def test_replay_bench_reports_the_per_window_readings():
    doc = p_bench.run_replay_bench(device="cpu", window_s=0.05, rounds=1)
    cal_drains, cal_wall = doc["record_calibration"]
    assert cal_drains >= 1 and cal_wall >= 0.05
    assert all(w[1] == cal_drains for w in doc["record_windows"])
    for side, drains, wall, gc_s, collections, cpu, vcs, ivcs in doc["record_windows"]:
        assert side in ("off", "on") and wall > 0.0 and gc_s >= 0.0 and collections >= 0
        assert 0.0 < cpu and isinstance(vcs, int) and isinstance(ivcs, int)
        assert vcs >= 0 and ivcs >= 0
    split = doc["record_split"]
    assert split["writer_cpu_s"] > 0.0 and len(split["writer_switches"]) == 2
    assert split["parts"]["segment"]["n"] >= 2 and split["parts"]["render"]["n"] >= 2
    assert "record_aa" not in doc and doc["value"] == 0
    aa = p_bench.run_replay_bench(device="cpu", window_s=0.05, rounds=1, aa=True)
    assert aa["record_aa"] is True
    assert all(v["n"] == 0 for v in aa["record_split"]["parts"].values())
    core = p_bench.replay_doc_core(aa)
    assert core.pop("record_aa") is True and core == p_bench.replay_doc_core(doc)


def test_writer_reports_its_cpu_beside_its_wall(tmp_path):
    from test_torch_trace import port_drain_journal

    records, _, _, rec = port_drain_journal(tmp_path / "j", n=(4, 3, 3), racks_per_block=2,
                                            wave_size=4)
    doc = rec.stats(split=True)
    assert doc["writerCpuSeconds"] > 0.0
    assert len(doc["writerSwitches"]) == 2 and all(x >= 0 for x in doc["writerSwitches"])
    assert "writerCpuSeconds" not in rec.stats()


# ---- pollS --------------------------------------------------------------------------


def test_poll_s_parses_equal_in_both_packages():
    from grove_tpu.runtime.config import load_operator_config as r_load
    from grove_tpu_torch.runtime.config import load_operator_config as p_load

    path = str(REPO / "examples" / "operator-config.yaml")
    assert yaml.safe_load(open(path))["solver"]["streaming"]["pollS"] == 0.005
    want = r_load(path).solver.streaming_config()
    got = p_load(path).solver.streaming_config()
    fields = [f.name for f in dataclasses.fields(want)]
    assert fields == [f.name for f in dataclasses.fields(got)]
    assert "poll_s" in fields
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name


def test_non_default_poll_s_parses_equal(tmp_path):
    from grove_tpu.runtime.config import load_operator_config as r_load
    from grove_tpu_torch.runtime.config import load_operator_config as p_load

    doc = yaml.safe_load((REPO / "examples" / "operator-config.yaml").read_text())
    doc = copy.deepcopy(doc)
    doc["solver"]["streaming"].update(pollS=0.02, maxWaitS=0.01, waveSize=8)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(doc))
    want = r_load(str(path)).solver.streaming_config()
    got = p_load(str(path)).solver.streaming_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.poll_s == 0.02


def without_seconds(doc: dict) -> dict:
    """A stream document without its wall-clock keys (streamWallS,
    gangsPerSec, the bind percentiles, the host stages' seconds)."""
    return {k: v for k, v in doc.items() if not k.endswith(("S", "Ms", "Sec"))}


class FakeTime:
    """`time.perf_counter` and `time.sleep` on one fake clock: a read moves
    it on by a microsecond, a sleep by what it was asked, so a paced loop
    idles the same way however fast the host solves."""

    def __init__(self):
        self.t, self.sleeps = 0.0, []

    def perf_counter(self):
        self.t += 1e-6
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def test_paced_stream_under_poll_s_equals_jax(monkeypatch):
    """A paced run whose last arrival waits past a non-default poll, the
    port's on a fake clock: the idle gap is slept in steps of `poll_s`, and
    the run's bindings and document equal the JAX package's, seconds
    aside."""
    from grove_tpu.sim import workloads as r_wl
    from grove_tpu.solver import stream as r_stream
    from grove_tpu.solver.warm import WarmPath as RWarmPath
    from grove_tpu.state import build_snapshot as r_snapshot
    from grove_tpu_torch.sim import workloads as p_wl
    from grove_tpu_torch.solver import stream as p_stream
    from grove_tpu_torch.solver.warm import WarmPath as PWarmPath
    from grove_tpu_torch.state import build_snapshot as p_snapshot

    def world(wl, build):
        arrivals, pods = wl.expand_arrivals(wl.arrival_process(7, duration_s=10.0, base_rate=3.0))
        # 16 base gangs due at once (two full windows of 8), then one more
        # a second later: the loop idles in between, and the windows are
        # the same whatever the host's speed.
        base = [g for _, g in arrivals if g.base_podgang_name is None]
        head = [(0.0, g) for g in base[:16]]
        tail = [(1.0, base[16])]
        names = {g.name for _, g in head + tail}
        pods = {n: p for n, p in pods.items() if p.podgang_name in names}
        snap = build(wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=4,
                                          hosts_per_rack=8), wl.bench_topology())
        return head + tail, pods, snap

    cfg = dict(depth=2, wave_size=8, max_wait_s=0.01, poll_s=0.02)
    r_arr, r_pods, r_snap = world(r_wl, r_snapshot)
    r_wp = RWarmPath()
    want, r_stats = r_stream.drain_stream(r_arr, r_pods, r_snap, config=r_stream.StreamConfig(
        **cfg), pace=True, pipeline=False, warm_path=r_wp)
    p_arr, p_pods, p_snap = world(p_wl, p_snapshot)
    p_wp = PWarmPath()
    fake = FakeTime()
    monkeypatch.setattr(time, "perf_counter", fake.perf_counter)
    monkeypatch.setattr(time, "sleep", fake.sleep)
    got, p_stats = p_stream.drain_stream(p_arr, p_pods, p_snap, config=p_stream.StreamConfig(
        **cfg), pace=True, pipeline=False, warm_path=p_wp, device="cpu")
    monkeypatch.undo()
    # The second's gap before the last arrival, slept in steps of 0.02.
    assert max(fake.sleeps) == 0.02 and fake.sleeps.count(0.02) >= 45
    assert sum(fake.sleeps) == pytest.approx(1.0, abs=0.02)
    assert got == want and list(got) == list(want)
    assert p_stats.admitted == r_stats.admitted == 17 and p_stats.waves == r_stats.waves
    assert p_stats.windows == r_stats.windows == 3
    doc_want, doc_got = without_seconds(r_wp.last_stream), without_seconds(p_wp.last_stream)
    assert doc_got == doc_want and doc_got["streamAdmitted"] == 17 and doc_got["paced"]
