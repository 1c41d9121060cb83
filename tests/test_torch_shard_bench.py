"""bench.py's shard scenario on the port (grove_tpu_torch/bench.py
`run_shard_bench` / `run_shard_worker`, on virtual devices of the CPU and
the plain versions) against bench.py's `run_shard_worker` on the suite's 8
virtual CPU devices, at a cut size (320 nodes, 45 sets): the bindings
digest, `admitted` and `per_device_split` equal the JAX worker's, every
ladder step binds alike, and the document carries bench.py's keys."""

from __future__ import annotations

import json

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu_torch import bench as p_bench
from grove_tpu_torch.parallel import mesh as p_mesh
from torch_jax_programs import _release_jax_programs  # noqa: F401

SCALE, FRAC = 0.0625, 0.05  # 1 rack per block: 320 nodes; 18 + 12 + 15 sets
POINT_KEYS = {
    "devices", "devices_requested", "nodes", "node_pad", "gangs", "wave_size", "shard_devices",
    "shard_fallbacks", "solve_total_s", "encode_s", "dispatch_s", "harvest_s", "admitted",
    "pods_bound", "lowerings_measured_run", "bindings_sha256", "per_device_split",
}
STREAM_KEYS = {"gangs_offered", "admitted_parity", "serial_wall_s", "pipeline_wall_s",
               "pipeline_speedup", "host_blocked_serial_s", "host_blocked_pipeline_s"}


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
def jax_point():
    """bench.py's shard worker in this process: 8 virtual CPU devices, the
    stream re-measure off; its JSON line read from what it prints."""
    import contextlib
    import io

    import bench

    mp = pytest.MonkeyPatch()
    for k, v in {"GROVE_BENCH_SHARD_WORKER": "8", "GROVE_BENCH_SHARD_SCALE": str(SCALE),
                 "GROVE_BENCH_SHARD_BACKLOG_FRAC": str(FRAC), "GROVE_BENCH_SHARD_WAVE": "64",
                 "GROVE_BENCH_SHARD_STREAM": "0"}.items():
        mp.setenv(k, v)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert bench.run_shard_worker() == 0
    finally:
        mp.undo()
    return json.loads([ln for ln in out.getvalue().splitlines() if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def port_doc():
    return p_bench.run_shard_bench(SCALE, FRAC, (1, 2, 4, 8), stream=False, device="cpu")


def test_port_ladder_binds_alike_and_carries_bench_keys(port_doc):
    assert port_doc["admitted_parity_across_devices"] is True
    assert port_doc["vs_baseline"] == 1.0 and port_doc["device_ladder"] == [1, 2, 4, 8]
    points = port_doc["points"]
    assert [p["shard_devices"] for p in points] == [0, 2, 4, 8]
    assert [p["devices"] for p in points] == [1, 1, 1, 1]
    for p in points:
        assert set(p) == POINT_KEYS
        assert p["nodes"] == p["node_pad"] == 320 and p["lowerings_measured_run"] == 0
        # One shard is one device: no layout and, as bench.py's, no fallback.
        assert p["shard_fallbacks"] == 0
        rows = [d["nodeRows"] for d in p["per_device_split"]]
        assert rows == ([] if p["devices_requested"] == 1 else
                        [320 // p["devices_requested"]] * p["devices_requested"])
    assert p_mesh.mesh_devices()[0].virtual is False  # the ladder left no virtual devices


def test_port_top_step_equals_bench_worker(port_doc, jax_point):
    top = port_doc["points"][-1]
    for key in ("bindings_sha256", "admitted", "per_device_split", "shard_devices", "gangs",
                "nodes", "node_pad", "pods_bound", "wave_size", "shard_fallbacks"):
        assert top[key] == jax_point[key], key
    assert set(jax_point) == POINT_KEYS


def test_port_stream_remeasure_carries_bench_keys(monkeypatch):
    monkeypatch.setattr(p_bench, "SHARD_STREAM_S", 2.0)
    point = p_bench.run_shard_worker(2, scale=SCALE, backlog_frac=FRAC, stream=True,
                                     device="cpu")
    assert set(point["stream"]) == STREAM_KEYS
    assert point["stream"]["admitted_parity"] is True
