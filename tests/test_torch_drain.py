"""The port's chained drain (plain PyTorch versions, device="cpu") against the
JAX package's drain_backlog(harvest="chained"): identical bindings."""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest

from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.drain import plan_waves as r_plan
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.drain import plan_waves as p_plan
from grove_tpu_torch.state import pod_request_vector
from test_torch_host import _bench, _contended, PORT, REF


def _drain_pair(build, wave_size):
    rg, rp, rs = build(REF)
    pg, pp, ps = build(PORT)
    rb, rstats = r_drain(rg, rp, rs, wave_size=wave_size, harvest="chained")
    pb, pstats = p_drain(pg, pp, ps, wave_size=wave_size, device="cpu")
    return (rb, rstats), (pb, pstats), (pg, pp, ps)


@pytest.mark.parametrize("wave_size", [256, 16])
def test_chained_drain_bindings_equal_bench_small(wave_size):
    """synthetic_cluster(racks_per_block=1) = 320 nodes, synthetic_backlog at
    scale 0.05."""
    build = lambda P: _bench(P, racks_per_block=1, n=(18, 12, 15))  # noqa: E731
    (rb, rstats), (pb, pstats), (pg, pp, ps) = _drain_pair(build, wave_size)
    assert ps.capacity.shape[0] == 320
    assert pb == rb
    assert list(pb) == list(rb)
    assert (pstats.admitted, pstats.pods_bound, pstats.waves) == (
        rstats.admitted, rstats.pods_bound, rstats.waves
    )
    assert pstats.admitted == len(pg)
    np.testing.assert_array_equal(np.asarray(pstats.scores), np.asarray(rstats.scores))
    # The carry the solver leaves equals the snapshot minus every bound pod.
    free = ps.free.astype(np.float32)
    for pods in pb.values():
        for pod, node in pods.items():
            i = ps.node_index(node)
            free[i] = free[i] - pod_request_vector(pp[pod], ps.resource_names)
    assert np.array_equal(pstats.free_after, free)


def test_chained_drain_bindings_equal_contended():
    """Contended: rejections happen, and a rejected base gates its scaled
    gangs across waves through ok_global."""
    (rb, rstats), (pb, pstats), _ = _drain_pair(_contended, 16)
    assert pb == rb
    assert pstats.admitted == rstats.admitted < pstats.gangs


def test_plan_waves_matches_reference():
    rg, _, _ = _bench(REF, n=(40, 30, 35))
    pg, _, _ = _bench(PORT, n=(40, 30, 35))
    for wave_size in (8, 32, 256):
        rw, pw = r_plan(rg, wave_size), p_plan(pg, wave_size)
        assert [([g.name for g in w], s, pad) for w, s, pad in rw] == [
            ([g.name for g in w], s, pad) for w, s, pad in pw
        ]


def test_drain_edge_cases():
    _, _, ps = _bench(PORT, n=(1, 1, 1))
    bindings, stats = p_drain([], {}, ps, device="cpu")
    assert bindings == {} and stats.waves == 0 and stats.gangs == 0
    assert stats.free_after is None
