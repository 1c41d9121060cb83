"""The serving path's journals against the port: journals the JAX
controller records (GroveController + Simulator: bound-node pins, portfolio
escalation, candidate pruning with lossy re-solves) replay through the port
with 0 divergences, and the port's sweep_journal over them equals the JAX
sweep at K = 4 and 8 (every tally and counter; escalating rows re-solve
through the production solve()). The JAX-recorded journal committed for the
card (tests/data/jax_card_journal.json, which chip_smoke.py replays and
sweeps on the card) has not gone stale: recorded again here, its plans,
verdicts and scores are the same.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sweep_serving.py --write-card-journal

re-records the committed journal.

Under several pytest workers, a worker recording the JAX controller journal
here once died in native code and xdist counted the test it was running as
failed: a long-lived worker had cached so many compiled JAX programs that
it held the kernel's limit of memory mappings, and the next program could
not be mapped. Every port module that runs the JAX package now releases
them at its start and end (tests/torch_jax_programs.py); the last test here
pins that.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile

import jax  # JAX stays on the CPU: conftest forces the platform
import pytest

from grove_tpu.solver import pruning as rp
from grove_tpu.solver.warm import WarmPath
from grove_tpu.trace import recorder as r_rec
from grove_tpu_torch.trace import recorder as p_rec
from grove_tpu_torch.trace.replay import replay_journal
from test_torch_sweep import _assert_sweep_equal
from test_torch_trace import waves_of
from torch_jax_programs import _release_jax_programs  # noqa: F401
from torch_jax_programs import memory_mappings, release_jax_programs

CARD_JOURNAL = pathlib.Path(__file__).resolve().parent / "data" / "jax_card_journal.json"


# ---- the JAX controller's journals ---------------------------------------------


def jax_controller_journal(path, *, pruning=None, racks=2, hosts=2):
    """The JAX serving path (GroveController + Simulator) journaled on a
    small 8-cpu fleet: two rack-packed jobs whose floors (2 of 3 pods) bind
    first and whose extras then solve pinned to their rack (boundNodes),
    then two jobs of `hosts` 8-cpu pods that need a whole rack each: a
    valid gang is rejected and the controller's escalatePortfolio=4 fires."""
    from grove_tpu.orchestrator.controller import GroveController
    from grove_tpu.orchestrator.store import Cluster
    from grove_tpu.sim.simulator import Simulator
    from grove_tpu.sim.workloads import _clique, _pcs, bench_topology, synthetic_cluster

    cluster = Cluster()
    for n in synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=racks,
                               hosts_per_rack=hosts, cpu=8.0, tpu=0.0):
        cluster.nodes[n.name] = n
    rec = r_rec.TraceRecorder(str(path))
    rec.start()
    try:
        ctrl = GroveController(cluster=cluster, topology=bench_topology(), recorder=rec,
                               pruning=pruning)
        sim = Simulator(cluster=cluster, controller=ctrl)
        for i in range(2):
            pcs = _pcs(f"job{i}", cliques=[_clique("w", 3, "4", min_available=2)],
                       constraint_domain="rack")
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sim.run(10)
        for i in range(2):
            pcs = _pcs(f"big{i}", cliques=[_clique("w", hosts, "8")], constraint_domain="rack")
            cluster.podcliquesets[pcs.metadata.name] = pcs
        sim.run(20)
    finally:
        rec.stop()
    return r_rec.read_journal(str(path))


def jax_pruned_mini_drain_journal(path):
    """A pruned JAX drain on 2 racks (40 nodes) of eight small rack-packed
    jobs, two gangs a wave: every wave journals its candidate list."""
    from grove_tpu.orchestrator import expand_podcliqueset
    from grove_tpu.sim.workloads import _clique, _pcs, bench_topology, synthetic_cluster
    from grove_tpu.solver.drain import drain_backlog
    from grove_tpu.state import build_snapshot

    topo = bench_topology()
    gangs, pods = [], {}
    for i in range(8):
        ds = expand_podcliqueset(
            _pcs(f"p{i}", cliques=[_clique("w", 2 + i % 3, "16")], constraint_domain="rack"),
            topo)
        gangs += ds.podgangs
        pods.update({p.name: p for p in ds.pods})
    snap = build_snapshot(synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=2), topo)
    rec = r_rec.TraceRecorder(str(path))
    rec.start()
    try:
        drain_backlog(gangs, pods, snap, wave_size=2, warm_path=WarmPath(), harvest="pipeline",
                      pruning=rp.PruningConfig(enabled=True, max_candidates=12, min_fleet=16,
                                               min_pad=8),
                      recorder=rec)
    finally:
        rec.stop()
    return r_rec.read_journal(str(path))


def record_card_journal(tmp) -> list:
    """The records of the journal committed for the card: the controller
    journal with pins and escalation, then the 2-rack pruned drain."""
    tmp = pathlib.Path(tmp)
    return jax_controller_journal(tmp / "controller") + jax_pruned_mini_drain_journal(tmp / "drain")


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_journals")
    return {
        "controller": jax_controller_journal(d / "controller"),
        "controller_pruned": jax_controller_journal(
            d / "controller_pruned", racks=2, hosts=4,
            pruning=rp.PruningConfig(enabled=True, max_candidates=3, min_fleet=4, min_pad=2)),
    }


@pytest.mark.parametrize("name", ["controller", "controller_pruned"])
def test_port_replays_jax_controller_journal_exactly(journals, name):
    records = journals[name]
    waves = waves_of(records)
    assert waves[0]["solver"]["escalatePortfolio"] == 4
    assert any(w["boundNodes"] for w in waves), "the extras waves carry pins"
    assert any(w["rejections"] for w in waves), "a valid gang is rejected"
    if name == "controller_pruned":
        assert all(w["solver"]["pruning"] for w in waves)
    report = replay_journal(records, device="cpu")
    assert len(report.waves) == len(waves)
    assert report.divergence_count == 0, report.to_doc()


def test_a_worker_full_of_compiled_programs_releases_them_and_records(tmp_path):
    """The state a long-lived worker leaves is set first: a few hundred
    compiled programs in JAX's jit caches and a drain's executables in the
    JAX package's process-shared WarmPath, each holding memory mappings.
    Releasing them as the module fixture does returns the process to the
    mappings it held before, and the journal fixture's recording then runs
    with its pins, its rejection and its escalation."""
    import jax.numpy as jnp

    import grove_tpu.solver.warm as r_warm
    from grove_tpu.orchestrator import expand_podcliqueset
    from grove_tpu.sim.workloads import _clique, _pcs, bench_topology, synthetic_cluster
    from grove_tpu.solver.drain import drain_backlog
    from grove_tpu.state import build_snapshot

    release_jax_programs()
    base = memory_mappings()
    for i in range(150):
        jax.jit(lambda x, i=i: jnp.sin(x) * i + jnp.cos(x * i))(jnp.ones((i + 1,)))
    topo = bench_topology()
    ds = expand_podcliqueset(_pcs("p0", cliques=[_clique("w", 2, "16")]), topo)
    drain_backlog(ds.podgangs, {p.name: p for p in ds.pods},
                  build_snapshot(synthetic_cluster(zones=1, blocks_per_zone=1,
                                                   racks_per_block=2), topo), wave_size=2)
    assert r_warm._DEFAULT_WARM_PATH is not None
    leaked = memory_mappings()
    assert leaked > base + 500, (base, leaked)
    release_jax_programs()
    assert r_warm._DEFAULT_WARM_PATH is None
    assert memory_mappings() < base + (leaked - base) // 4, (base, leaked, memory_mappings())
    waves = waves_of(jax_controller_journal(tmp_path / "controller"))
    assert waves[0]["solver"]["escalatePortfolio"] == 4
    assert any(w["boundNodes"] for w in waves) and any(w["rejections"] for w in waves)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", ["controller", "controller_pruned"])
def test_sweep_equals_jax_sweep_on_controller_journal(journals, name, k):
    port = _assert_sweep_equal(journals[name], k)
    assert port.fallback_solves > 0, "escalating rows re-solve in production"


# ---- the journal committed for the card ----------------------------------------------


def test_committed_card_journal_is_current(tmp_path):
    """Recorded again with the JAX package, the committed journal holds the
    same plans, verdicts and scores (and the port replays it exactly)."""
    committed = p_rec.read_journal(str(CARD_JOURNAL))
    assert CARD_JOURNAL.stat().st_size <= 128 * 1024
    fresh = record_card_journal(tmp_path)
    cw, fw = waves_of(committed), waves_of(fresh)
    assert len(cw) == len(fw) >= 8
    for a, b in zip(cw, fw):
        for f in ("wave", "ok", "plan", "scores", "boundNodes", "candidates", "freeRows",
                  "solver", "fleet"):
            assert a.get(f) == b.get(f), (a["wave"], f)
    assert any(w["boundNodes"] for w in cw) and any(w["rejections"] for w in cw)
    assert any(w.get("candidates") for w in cw)
    assert replay_journal(committed, device="cpu").divergence_count == 0


def write_card_journal() -> None:
    tmp = tempfile.mkdtemp(prefix="card-journal-")
    try:
        records = record_card_journal(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    CARD_JOURNAL.parent.mkdir(parents=True, exist_ok=True)
    CARD_JOURNAL.write_text(json.dumps({"version": r_rec.SCHEMA_VERSION, "records": records},
                                       separators=(",", ":")))
    print(f"{CARD_JOURNAL}: {len(waves_of(records))} waves, {CARD_JOURNAL.stat().st_size} bytes")


if __name__ == "__main__" and "--write-card-journal" in sys.argv:
    write_card_journal()
