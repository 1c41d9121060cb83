"""bench.py's tenancy scenario on the port (grove_tpu_torch/bench.py
`run_tenancy_bench`, through the port's Manager and Simulator on the CPU's
plain versions) against bench.py's `run_tenancy_bench` at a cut trace: the
documents are equal, wall-clock keys aside, gates included."""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401


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
def docs():
    """bench.py's run and the port's at a 10 s trace (bench.py's other
    sizes: 192 nodes, 200 tenants, 1.6 arrivals a second, the chaos and
    the recorder)."""
    import bench

    mp = pytest.MonkeyPatch()
    mp.setenv("GROVE_BENCH_TENANCY_DURATION_S", "10")
    try:
        want = bench.run_tenancy_bench()
    finally:
        mp.undo()
    got = p_bench.run_tenancy_bench(device="cpu", duration_s=10.0, cpu_replay=True)
    return want, got


def test_tenancy_document_equals_bench_py(docs):
    want, got = docs
    core = p_bench.manager_doc_core(got)
    assert core.pop("cpu_replay_divergences") == 0
    assert core.pop("cpu_replay_waves") == got["replay_waves"] > 0
    assert core == p_bench.manager_doc_core(want)


def test_tenancy_cut_trace_exercises_every_surface(docs):
    _, got = docs
    assert got["workloads_offered"] == got["workloads_bound"] > 20
    assert len(got["faults"]) == 3 and got["oversubscribed_ticks"] == 0
    assert set(got["tiers"]) == {"latency", "standard", "batch-preemptible"}
    assert got["trace_duration_s"] == 10.0 and got["tenant_count"] > 10
    gates = dict(got["gates"])
    # The 10 s trace is too short to contend the org quota into a reclaim;
    # every other gate holds (at bench.py's 75 s all of them do).
    assert gates.pop("reclaims_exercised") is False
    assert all(gates.values()), gates
