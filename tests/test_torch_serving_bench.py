"""The port's serving benches (grove_tpu_torch/bench.py) on the plain
versions here, and on the card where there is one:

  - `--scenario replay` (`run_replay_bench`) has bench.py's keys and, on
    the CPU, the JAX package's values (wall-clock keys aside): the same
    gangs admitted, journal, replay verdict and +1-rack what-if;
  - `--scenario serving` (`run_serving_bench`) at a small size binds every
    gang, leaves no node over capacity, brings every pod Ready and every
    PodCliqueSet Available, and its journal replays with 0 divergences;
  - `run_serving_lockstep`, the card-against-CPU check of chip_smoke.py
    phase 15 (c), finds two CPU runs of the churn world equal after every
    step, and reports the first difference when the worlds differ; on the
    card (`gpu` marker) it holds the card's run against the CPU's.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest
import torch

from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401


def small_churn_world():
    """churn_world cut to 64 nodes and a quarter of its backlog, the same
    scripted faults on nodes that exist there."""
    from grove_tpu_torch.sim.workloads import synthetic_cluster

    topo, _, backlog, ctl, sim, _ = p_bench.churn_world()
    nodes = synthetic_cluster(zones=2, blocks_per_zone=2, racks_per_block=2,
                              hosts_per_rack=8, tpu=4.0)
    keep = backlog[:10] + backlog[40:48] + backlog[70:75]
    faults = ((4.0, "kill_node", "z0b0r0h0"), (6.0, "cordon", "z0b1r1h3"),
              (8.0, "revoke_node", "z1b0r1h5"))
    return topo, nodes, keep, ctl, sim, faults


def test_replay_scenario_has_bench_keys_and_jax_values(monkeypatch):
    import bench

    monkeypatch.setenv("GROVE_BENCH_SCALE", "1.0")
    ref = bench.run_replay_bench()
    port = p_bench.run_replay_bench(device="cpu")
    assert set(port) == set(ref)
    assert set(port["recorder_stats"]) == set(ref["recorder_stats"])
    assert p_bench.replay_doc_core(port) == p_bench.replay_doc_core(ref)
    assert port["value"] == 0 and port["gangs"] == 5 and port["gangs_admitted"] == 4
    assert port["whatif_admitted_delta"] >= 1


def test_serving_scenario_at_a_small_size():
    out = p_bench.run_serving_bench(scale=0.05, frac=0.02, device="cpu")
    assert out["ok"], {k: v for k, v in out.items() if k != "tick_log"}
    assert out["gangs_base_scheduled"] == out["gangs"] > 0
    assert out["pcs_available"] == out["podcliquesets"]
    assert out["overcommitted_nodes"] == [] and out["divergences"] == 0
    assert out["replay_scope"] == "every wave" and out["replayed_waves"] == out["journal_waves"]
    first = out["tick_log"][0]
    assert set(first["phases_s"]) == set(p_bench.RECONCILE_PHASES)
    assert set(first["host_stages"]) == {"encodeS", "solveS", "decodeS", "gangs"}
    assert out["sim_s_to_all_bound"] <= out["sim_s_to_all_ready"]


def test_serving_entry_points_need_the_card_unless_asked():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_bench.run_serving_bench(scale=0.05, frac=0.02)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_bench.run_replay_bench()


def test_lockstep_of_two_cpu_runs_is_equal_step_by_step():
    out = p_bench.run_serving_lockstep(devices=("cpu", "cpu"), steps=12,
                                       world=small_churn_world)
    assert out["steps"] == 12 and out["bound"] > 0 and out["overcommitted_nodes"] == []
    assert out["revocation_counts"]["notices"] == 1
    assert out["journal_waves"] >= 2


def test_lockstep_reports_the_first_difference():
    calls = {"n": 0}

    def world():
        topo, nodes, backlog, ctl, sim, faults = small_churn_world()
        calls["n"] += 1
        if calls["n"] == 2:  # the second run loses a node at t=2
            faults = ((2.0, "kill_node", "z1b1r1h7"),) + tuple(faults)
        return topo, nodes, backlog, ctl, sim, faults

    with pytest.raises(AssertionError, match="stores differ after step 2"):
        p_bench.run_serving_lockstep(devices=("cpu", "cpu"), steps=4, world=world)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_serving_bench.py` on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_card_run_equals_cpu_run_step_by_step(cuda):
    """chip_smoke.py phase 15 (c) at a small size: the controller on the card
    and on the CPU, stepped in lockstep, leave equal stores after every step
    and equal journals."""
    out = p_bench.run_serving_lockstep(devices=(cuda, "cpu"), steps=12,
                                       world=small_churn_world)
    assert out["bound"] > 0 and out["overcommitted_nodes"] == []


class StepClock:
    """A clock for `read_record_overhead` that moves only when a drain runs,
    by STEP_S: the windows' drain count and walls are then the same on a
    loaded host as on an idle one."""

    STEP_S = 0.2

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_replay_scenario_windows_keep_the_document(monkeypatch):
    """run_replay_bench(window_s=...): four timed windows, OFF, ON, ON, OFF,
    of one drain count set by the first, listed as `record_windows`; the
    overhead is bench.py's formula on their summed walls, and every other
    key is the one-drain windows' document's. The reading runs on a clock
    that each drain moves by StepClock.STEP_S, so the 0.5 s calibration
    window holds three drains whatever the host's speed."""
    one = p_bench.run_replay_bench(device="cpu")
    reading = p_bench.read_record_overhead

    def on_step_clock(drain, new_recorder, **kw):
        clock = StepClock()

        def stepped(recorder):
            clock.t += StepClock.STEP_S
            return drain(recorder)

        return reading(stepped, new_recorder, clock=clock, **kw)

    monkeypatch.setattr(p_bench, "read_record_overhead", on_step_clock)
    win = p_bench.run_replay_bench(device="cpu", window_s=0.5)
    assert "record_windows" not in one
    sides = [w[0] for w in win["record_windows"]]
    counts = {w[1] for w in win["record_windows"]}
    assert sides == ["off", "on", "on", "off"] and len(counts) == 1 and counts.pop() >= 2
    n = win["record_windows"][0][1]
    off = sum(w[2] for w in win["record_windows"] if w[0] == "off") / (2 * n)
    on = sum(w[2] for w in win["record_windows"] if w[0] == "on") / (2 * n)
    assert win["drain_wall_off_s"] == off and win["drain_wall_on_s"] == on
    assert win["record_overhead_frac"] == (on - off) / off
    assert p_bench.replay_doc_core(win) == p_bench.replay_doc_core(one)


def test_replay_scenario_times_the_recorder_through_its_flush(monkeypatch):
    """An ON window ends with recorder.flush(): what the writer does for the
    window's drains lands inside its wall. A flush made 1 s slower shows
    in the ON drain wall."""
    import time

    from grove_tpu_torch.trace import recorder as p_rec

    flushes = []
    real_flush = p_rec.TraceRecorder.flush

    def slow_flush(self, timeout=5.0):
        flushes.append(self.path)
        time.sleep(1.0)
        return real_flush(self, timeout)

    monkeypatch.setattr(p_rec.TraceRecorder, "flush", slow_flush)
    doc = p_bench.run_replay_bench(device="cpu")
    # The warm-up's recorded drain (untimed) and the two ON windows; the
    # recorded drain stops.
    assert len(flushes) == 3
    assert doc["drain_wall_on_s"] >= doc["drain_wall_off_s"] + 0.8
    assert doc["record_overhead_frac"] > 0.05 and doc["vs_baseline"] == 0.0
