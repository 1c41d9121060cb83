"""The tuning sweep of the port (grove_tpu_torch/tuning, plain PyTorch
versions on the CPU) against the JAX package's, over drain journals:

  - sweep_journal at K = 4 and 8 equals the JAX sweep on every tally
    (waves, gangs, admitted, score_sum, divergences, escalations, the
    per-wave plans) and on the engine's counters (stackedSolves,
    scanStackedSolves, fallbackSolves), over drain journals: a scan drain's
    (B6 runs) and a pruned drain's recorded under an 8-device mesh (with
    candidates: the gathered B5 launch).

The serving path's journals (the JAX controller's) and the journal
committed for the card are in tests/test_torch_sweep_serving.py; B6's plain
version against JAX stacked_scan_solve_fn in tests/test_torch_scan.py.
"""

from __future__ import annotations


import pytest

from grove_tpu.parallel.mesh import MeshConfig
from grove_tpu.solver.warm import WarmPath
from grove_tpu.tuning import default_grid as r_grid
from grove_tpu.tuning import incumbent_config as r_incumbent
from grove_tpu.tuning import sweep_journal as r_sweep
from grove_tpu_torch.tuning import default_grid, incumbent_config, sweep_journal
from test_torch_trace import PRUNED, jax_drain_journal, waves_of
from torch_jax_programs import _release_jax_programs  # noqa: F401

TALLY = ("waves", "gangs", "admitted", "score_sum", "divergences", "escalations", "plans")
COUNTERS = ("waves_seen", "stacked_solves", "scan_stacked_solves", "fallback_solves")


# The sweep's drain journals: the 160-node fleet of tests/test_tuning.py
# `_problem` with eight disaggregated PodCliqueSets in waves of 4 (runs of
# same-shape waves for B6, few shapes for the JAX sweep to compile), and a
# pruned drain recorded under an 8-device mesh at waves of 16.
SMALL = dict(n=(8, 0, 0), wave_size=4)


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_journals")
    return {
        "scan": jax_drain_journal(d / "scan", harvest="scan", **SMALL)[0],
        # Pruned, and recorded under an 8-device mesh (tests/test_tuning.py:185-225).
        "pruned": jax_drain_journal(d / "pruned", pruning=PRUNED, n=(5, 4, 4), wave_size=16,
                                    mesh=MeshConfig(enabled=True, min_nodes=64))[0],
    }


# ---- the sweep ---------------------------------------------------------------------


def _assert_sweep_equal(records, k):
    grid = default_grid(incumbent_config(records), k)
    r_grid_k = r_grid(r_incumbent(records), k)
    assert [(c.name, c.weights, c.portfolio, c.escalate_portfolio) for c in grid] == [
        (c.name, c.weights, c.portfolio, c.escalate_portfolio) for c in r_grid_k]
    port = sweep_journal(records, grid, device="cpu")
    ref = r_sweep(records, r_grid_k, warm_path=WarmPath())
    for f in COUNTERS:
        assert getattr(port, f) == getattr(ref, f), f
    for c in grid:
        a, b = port.tallies[c.name], ref.tallies[c.name]
        for f in TALLY:
            assert getattr(a, f) == getattr(b, f), (c.name, f)
    inc = port.tallies["incumbent"]
    assert inc.divergences == 0
    assert inc.admitted == sum(1 for w in waves_of(records) for v in w["ok"].values() if v)
    return port


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", ["scan", "pruned"])
def test_sweep_equals_jax_sweep(journals, name, k):
    port = _assert_sweep_equal(journals[name], k)
    if name == "scan":
        assert port.scan_stacked_solves > 0, "a same-shape run goes through B6"
    if name == "pruned":
        waves = waves_of(journals[name])
        assert all(w["solver"]["mesh"] == {"portfolio": 1, "node": 8} for w in waves)
        assert any(w.get("candidates") is not None for w in waves)
        assert port.stacked_solves > 0


def test_sweep_raises_on_a_missing_fleet(journals):
    records = [r for r in journals["scan"] if r.get("kind") != "fleet"]
    with pytest.raises(ValueError, match="recorderDropped"):
        sweep_journal(records, default_grid(incumbent_config(records), 2), device="cpu")
    with pytest.raises(ValueError, match="no wave records"):
        incumbent_config([])


def test_sweep_keep_restricts_the_grid(journals):
    records = journals["scan"]
    grid = default_grid(incumbent_config(records), 4)
    from grove_tpu_torch.tuning import SweepEngine

    engine = SweepEngine(grid, device="cpu")
    half = len(records) // 2
    engine.consume(records[:half])
    engine.keep({"incumbent", "cand-02"})
    engine.consume(records[half:])
    waves = len(waves_of(records))
    assert engine.tallies["incumbent"].waves == engine.tallies["cand-02"].waves == waves
    assert engine.tallies["cand-01"].waves < waves
    doc = engine.to_doc()
    assert doc["waves"] == waves and len(doc["configs"]) == 4
    with pytest.raises(ValueError, match="eliminated every config"):
        engine.keep({"nobody"})
