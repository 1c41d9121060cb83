"""The port's streaming drain with candidate pruning (plain PyTorch versions
on the CPU) against the JAX package's: a contended 32-node fleet whose
clipped candidate budget (8 candidates) forces escalations, some adopted,
streamed pipelined and scanned with the flight recorder attached. Each run
has JAX's bindings and counters (waves, windows, scan_chunks, dispatches,
device_roundtrips, escalations, escalations_adopted, pruned_waves, the
candidate count and pad, launch-cache misses and lowerings), admits the
dense stream's set, journals JAX's records (candidate lists included), and
both packages' journals replay through the port with 0 divergences.
"""

from __future__ import annotations

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver.drain import ScanConfig as RScan
from grove_tpu.solver.pruning import PruningConfig as RPruning
from grove_tpu.solver.warm import WarmPath as RWarmPath
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import stream as p_stream
from grove_tpu_torch.solver.drain import ScanConfig as PScan
from grove_tpu_torch.solver.pruning import PruningConfig as PPruning
from grove_tpu_torch.solver.warm import WarmPath as PWarmPath
from grove_tpu_torch.state import build_snapshot as p_snapshot
from grove_tpu_torch.trace.replay import replay_journal
from test_torch_search import waves_of
from test_torch_stream import fleet, trace
from test_torch_stream_journal import WAVE_FIELDS, recorded
from torch_jax_programs import _release_jax_programs  # noqa: F401

PRUNED = dict(enabled=True, min_fleet=16, max_candidates=8, min_pad=8)
COUNTERS = ("waves", "dispatches", "device_roundtrips", "scan_chunks", "scanned_waves",
            "escalations", "escalations_adopted", "pruned_waves", "candidate_nodes",
            "candidate_pad", "exec_cache_misses", "lowerings")


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
def pruned_world():
    """A contended 32-node fleet and a 6 s trace (32 gangs): with 8
    candidates a wave rejects gangs its plan marked lossy."""
    return {
        "jax": (*trace(r_wl, duration_s=6.0), fleet(r_wl, r_snapshot, racks=2), RWarmPath()),
        "port": (*trace(p_wl, duration_s=6.0), fleet(p_wl, p_snapshot, racks=2), PWarmPath()),
    }


@pytest.mark.parametrize("scan", [False, True], ids=["pipeline", "scan"])
def test_pruned_stream_equals_jax(pruned_world, tmp_path, scan):
    out = {}
    for side, pruning, scan_cls in (("jax", RPruning, RScan), ("port", PPruning, PScan)):
        arrivals, pods, snap, wp = pruned_world[side]
        out[side] = recorded(side, tmp_path / side, arrivals, pods, snap, wp,
                             pruning=pruning(**PRUNED), scan=scan_cls() if scan else None)
    (jb, jst, jrec), (pb, pst, precs) = out["jax"], out["port"]
    assert pb == jb
    assert (pst.windows, pst.admitted, pst.mode) == (jst.windows, jst.admitted, jst.mode)
    for name in COUNTERS:
        assert getattr(pst.drain, name) == getattr(jst.drain, name), name
    assert pst.drain.pruned_waves > 0
    assert pst.drain.escalations > 0 and pst.drain.escalations_adopted > 0
    if scan:
        assert pst.drain.scan_chunks >= 1
    arrivals, pods, snap, wp = pruned_world["port"]
    dense, _ = p_stream.drain_stream(arrivals, pods, snap,
                                     config=p_stream.StreamConfig(depth=2, wave_size=8),
                                     warm_path=wp, device="cpu")
    assert set(pb) == set(dense)
    for a, b in zip(waves_of(jrec), waves_of(precs)):
        for f in WAVE_FIELDS:
            assert a.get(f) == b.get(f), (a["wave"], f)
    assert any(w.get("candidates") for w in waves_of(precs))
    for records in (jrec, precs):
        report = replay_journal(records, device="cpu")
        assert report.divergence_count == 0, report.to_doc()
