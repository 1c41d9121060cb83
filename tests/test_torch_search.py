"""The port's tuning search (grove_tpu_torch/tuning/search.py, plain PyTorch
versions on the CPU) against the JAX package's: `_chunk_records`, the
successive-halving schedule (survivors per rung and every tally), and the
whole `recommend` document (winner, `valid`, `failedGates`, rungs, sweep and
validation, every seconds field left out) on a stream journal recorded by
the JAX package, cut to 12 waves (k = 4, rungs = 2, two audit seeds); a
forged journal fails closed, as in tests/test_tuning.py.

The journal is the committed tests/data/jax_stream_journal.json: bench.py's
sweep scenario trace (arrival_process(7, duration_s=10, base_rate=3),
64 nodes, wave_size 8, depth 2) drained by the JAX `drain_stream` with its
flight recorder, cut to its first 6 waves (about 180 KB: a JAX record
carries ~1.9 KB per pod); beside it, tests/data/jax_stream_recommend.json
holds the JAX `recommend` verdict on that journal (k = 16, rungs = 4, the
six audit seeds), which chip_smoke.py's tune phase holds the card's
against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_search.py --write-stream-journal

re-records both (tests/test_torch_stream_journal.py checks that the journal
is current).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import pytest

from grove_tpu.solver.warm import WarmPath as RWarmPath
from grove_tpu.trace import recorder as r_rec
from grove_tpu.tuning import search as r_search
from grove_tpu.tuning.sweep import default_grid as r_grid
from grove_tpu.tuning.sweep import incumbent_config as r_incumbent
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.tuning import search as p_search
from grove_tpu_torch.tuning.sweep import default_grid as p_grid
from grove_tpu_torch.tuning.sweep import incumbent_config as p_incumbent
from torch_jax_programs import _release_jax_programs  # noqa: F401

DATA = pathlib.Path(__file__).resolve().parent / "data"
STREAM_JOURNAL = DATA / "jax_stream_journal.json"
STREAM_RECOMMEND = DATA / "jax_stream_recommend.json"
# bench.py run_sweep_bench's trace and fleet.
SWEEP_TRACE = dict(seed=7, duration_s=10.0, rate=3.0, racks=4, hosts=8, wave_size=8, depth=2)
STREAM_WAVES = 6  # waves of the committed journal
CUT_WAVES = 6
AUDIT_SEEDS = (11, 23)


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


def waves_of(records):
    return [r for r in records if r.get("kind") == "wave"]


def cut_journal(records, n_waves):
    """The records up to the n-th wave (its fleet records included)."""
    out, seen = [], 0
    for r in records:
        if r.get("kind") == "wave":
            if seen == n_waves:
                break
            seen += 1
        out.append(r)
    return out


def strip_seconds(doc):
    """The document without its wall-clock fields."""
    if isinstance(doc, dict):
        return {k: strip_seconds(v) for k, v in doc.items() if "Seconds" not in k}
    if isinstance(doc, list):
        return [strip_seconds(v) for v in doc]
    return doc


@pytest.fixture(scope="module")
def journal():
    return cut_journal(p_rec.read_journal(str(STREAM_JOURNAL)), CUT_WAVES)


@pytest.fixture(scope="module")
def jax_warm():
    """One JAX warm path for the module: its launches compile once."""
    return RWarmPath()


@pytest.mark.parametrize("rungs", [1, 2, 3, 5, 40])
def test_chunk_records_equal_jax(journal, rungs):
    got = p_search._chunk_records(journal, rungs)
    want = r_search._chunk_records(journal, rungs)
    assert got == want
    assert sum(len(waves_of(c)) for c in got) == CUT_WAVES


def test_successive_halving_schedule_equals_jax(journal, jax_warm):
    grid_r = r_grid(r_incumbent(journal), 4)
    grid_p = p_grid(p_incumbent(journal), 4)
    assert [c.to_doc() for c in grid_r] == [c.to_doc() for c in grid_p]
    r_engine, r_sched = r_search.successive_halving(journal, grid_r, rungs=2, warm_path=jax_warm)
    p_engine, p_sched = p_search.successive_halving(journal, grid_p, rungs=2, device="cpu")
    assert p_sched == r_sched
    assert [len(r["configs"]) for r in p_sched] == [4, 2]
    assert [c.name for c in p_engine.configs] == [c.name for c in r_engine.configs]
    assert strip_seconds(p_engine.to_doc()) == strip_seconds(r_engine.to_doc())


def test_recommend_equals_jax(journal, jax_warm):
    want = r_search.recommend(journal, k=4, rungs=2, audit_seeds=AUDIT_SEEDS, warm_path=jax_warm)
    got = p_search.recommend(journal, k=4, rungs=2, audit_seeds=AUDIT_SEEDS, device="cpu")
    assert strip_seconds(got) == strip_seconds(want)
    assert got["valid"] and "failedGates" not in got
    assert got["validation"]["bitwiseReplay"] == {"waves": CUT_WAVES, "divergences": 0}
    assert got["validation"]["exactAudit"]["seeds"] == list(AUDIT_SEEDS)


def test_recommend_fails_closed_on_a_forged_journal(journal):
    """A recorded plan the solver cannot reproduce fails the journalReplay
    gate (tests/test_tuning.py's counterpart)."""
    records = json.loads(json.dumps(journal))
    for rec in waves_of(records):
        if rec["plan"]:
            bindings = next(iter(rec["plan"].values()))
            bindings[next(iter(bindings))] = "node-that-never-was"
            break
    doc = p_search.recommend(records, k=2, rungs=1, audit_seeds=AUDIT_SEEDS, device="cpu")
    assert not doc["valid"]
    assert "journalReplay" in doc["failedGates"]
    assert doc["validation"]["journalReplayDivergences"] >= 1


def test_committed_recommend_verdict_matches_its_journal():
    """The verdict file beside the journal names a winner of the journal's
    own grid, with both gates passed (chip_smoke.py holds the card to it)."""
    verdict = json.loads(STREAM_RECOMMEND.read_text())
    records = p_rec.read_journal(str(STREAM_JOURNAL))
    assert verdict["waves"] == len(waves_of(records)) == STREAM_WAVES
    grid = {c.name for c in p_grid(p_incumbent(records), verdict["k"])}
    assert verdict["winner"] in grid
    assert verdict["valid"] and verdict["failedGates"] == []
    assert verdict["bitwiseDivergences"] == verdict["journalReplayDivergences"] == 0
    assert STREAM_JOURNAL.stat().st_size <= 200 * 1024


# ---- the committed journal -------------------------------------------------------


def record_stream_journal(path) -> list:
    """The JAX package's stream journal of the sweep scenario's trace."""
    from grove_tpu.sim.workloads import (
        arrival_process,
        bench_topology,
        expand_arrivals,
        synthetic_cluster,
    )
    from grove_tpu.solver.stream import StreamConfig, drain_stream
    from grove_tpu.state import build_snapshot

    t = SWEEP_TRACE
    topo = bench_topology()
    nodes = synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=t["racks"],
                              hosts_per_rack=t["hosts"])
    arrivals, pods = expand_arrivals(arrival_process(t["seed"], duration_s=t["duration_s"],
                                                     base_rate=t["rate"]))
    rec = r_rec.TraceRecorder(str(path), max_records_per_file=64)
    rec.start()
    try:
        drain_stream(arrivals, pods, build_snapshot(nodes, topo),
                     config=StreamConfig(depth=t["depth"], wave_size=t["wave_size"]),
                     warm_path=RWarmPath(), recorder=rec)
    finally:
        rec.stop()
    return r_rec.read_journal(str(path))


def write_stream_journal() -> None:
    tmp = tempfile.mkdtemp(prefix="stream-journal-")
    try:
        records = cut_journal(record_stream_journal(tmp), STREAM_WAVES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    DATA.mkdir(parents=True, exist_ok=True)
    STREAM_JOURNAL.write_text(json.dumps({"version": r_rec.SCHEMA_VERSION, "records": records},
                                         separators=(",", ":")))
    k, rungs = 16, 4  # bench.py run_sweep_bench's grid and rungs
    doc = r_search.recommend(records, k=k, rungs=rungs, warm_path=RWarmPath())
    verdict = {
        "k": k,
        "rungs": rungs,
        "waves": len(waves_of(records)),
        "winner": doc["winner"]["name"],
        "valid": doc["valid"],
        "failedGates": doc.get("failedGates", []),
        "bitwiseDivergences": doc["validation"]["bitwiseReplay"]["divergences"],
        "journalReplayDivergences": doc["validation"]["journalReplayDivergences"],
        "admittedPass": doc["validation"]["exactAudit"]["admittedPass"],
        "survivorsPerRung": [len(r["configs"]) for r in doc["rungs"]],
        "winnerAdmitted": doc["winnerTally"]["admitted"],
        "incumbentAdmitted": doc["incumbentTally"]["admitted"],
    }
    STREAM_RECOMMEND.write_text(json.dumps(verdict, indent=1) + "\n")
    print(f"{STREAM_JOURNAL}: {verdict['waves']} waves, {STREAM_JOURNAL.stat().st_size} bytes; "
          f"{STREAM_RECOMMEND}: {verdict}")


if __name__ == "__main__" and "--write-stream-journal" in sys.argv:
    write_stream_journal()
