"""The port's quality scenario (`grove_tpu_torch.bench --scenario quality`)
against bench.py's on the CPU:

  - `run_quality_bench(portfolio, device="cpu")` equals bench.py's
    `run_quality_bench()` (its GROVE_BENCH_PORTFOLIO set to the same width)
    key for key at portfolio 1 and 4 — the placement reports, the wave
    count, the exact bound with its states explored, the ratios and
    `vs_baseline` — the measured wave latencies aside;
  - `solver.core.decode_assignments` equals the JAX function on the same
    solve of the mixed backlog.

The card's run against the CPU's is tests/test_torch_quality_card.py.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401


def without_walls(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k not in p_bench.QUALITY_WALL_KEYS}


@pytest.mark.parametrize("portfolio", [1, 4])
def test_quality_document_equals_bench_py(monkeypatch, portfolio):
    import bench

    monkeypatch.setenv("GROVE_FORCE_CPU", "1")
    monkeypatch.setenv("GROVE_BENCH_PORTFOLIO", str(portfolio))
    ref = bench.run_quality_bench()
    port = p_bench.run_quality_bench(portfolio, device="cpu")
    assert list(port) == list(ref)
    assert without_walls(port) == without_walls(ref)
    assert port["portfolio"] == portfolio and port["exact_states_explored"] > 0
    assert port["solver_gangs"] == 12 and port["exact_gangs"] == 4


def test_decode_assignments_equals_jax():
    from grove_tpu.orchestrator import expand_podcliqueset as r_expand
    from grove_tpu.sim import workloads as r_w
    from grove_tpu.solver import core as r_core
    from grove_tpu.solver.encode import encode_gangs as r_encode
    from grove_tpu.state import build_snapshot as r_snapshot
    from grove_tpu_torch.sim import workloads as p_w
    from grove_tpu_torch.solver import core as p_core
    from grove_tpu_torch.solver.encode import encode_gangs as p_encode
    from grove_tpu_torch.state import build_snapshot as p_snapshot

    r_topo = r_w.bench_topology()
    r_gangs, r_pods = [], {}
    for pcs in r_w.mixed_backlog():
        ds = r_expand(pcs, r_topo)
        r_gangs.extend(ds.podgangs)
        r_pods.update({p.name: p for p in ds.pods})
    r_snap = r_snapshot(r_w.quality_cluster(), r_topo)
    r_batch, r_decode = r_encode(r_gangs, r_pods, r_snap)
    ref = r_core.decode_assignments(
        r_core.solve(r_snap, r_batch, r_core.SolverParams()), r_decode, r_snap)

    p_gangs, p_pods = p_bench._expand(p_w.mixed_backlog())
    p_snap = p_snapshot(p_w.quality_cluster(), p_w.bench_topology())
    p_batch, p_decode = p_encode(p_gangs, p_pods, p_snap)
    got = p_core.decode_assignments(
        p_core.solve(p_snap, p_batch, p_core.SolverParams(), device="cpu"), p_decode, p_snap)
    assert got == ref and len(got) == 12
