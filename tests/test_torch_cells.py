"""The port's cellular control plane (grove_tpu_torch/cells,
runtime/lease.py) against the JAX package's: each case of tests/test_cells.py
but the manager's statusz (the manager is not ported), run on both packages
with the same fleet, trace and fault schedule (the port's stream drains on
the CPU's plain versions), with the same verdicts, bindings, recovery
reports and stats (wall-clock fields aside); and bench.py's
`run_cells_bench` at a short trace against the port's `--scenario cells`,
documents equal but for their wall-clock keys.
"""

from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest

import grove_tpu.api.podgang as r_podgang
import grove_tpu.cells as r_cells
import grove_tpu.faults as r_faults
import grove_tpu.orchestrator.queues as r_queues
import grove_tpu.runtime.lease as r_lease
import grove_tpu.sim.workloads as r_wl
import grove_tpu.trace.recorder as r_rec
import grove_tpu_torch.api.podgang as p_podgang
import grove_tpu_torch.cells as p_cells
import grove_tpu_torch.faults as p_faults
import grove_tpu_torch.orchestrator.queues as p_queues
import grove_tpu_torch.runtime.lease as p_lease
import grove_tpu_torch.sim.workloads as p_wl
import grove_tpu_torch.trace.recorder as p_rec
from grove_tpu_torch import bench as p_bench
from torch_jax_programs import _release_jax_programs  # noqa: F401

SEED = 20260807
# Per-cell stats that carry host wall-clock time.
WALL = ("hostTotalS", "hostBlockedS", "wallS")


def _pkg(name, cells, faults, queues, lease, wl, rec, podgang, **cell_kw):
    return SimpleNamespace(name=name, cells=cells, faults=faults, queues=queues, lease=lease,
                           wl=wl, rec=rec, podgang=podgang, kw=cell_kw, wp=None)


JAX = _pkg("jax", r_cells, r_faults, r_queues, r_lease, r_wl, r_rec, r_podgang)
PORT = _pkg("port", p_cells, p_faults, p_queues, p_lease, p_wl, p_rec, p_podgang, device="cpu")


def warm(M):
    """One warm path per package for the engine-driving cases (as
    tests/test_cells.py shares one)."""
    if M.wp is None:
        from grove_tpu.solver.warm import WarmPath as RWarm
        from grove_tpu_torch.solver.warm import WarmPath as PWarm

        M.wp = RWarm() if M is JAX else PWarm()
    return M.wp


def tree(M, order=None):
    specs = {
        "teams": M.queues.QueueSpec(name="teams"),
        "teams/ml": M.queues.QueueSpec(name="teams/ml", parent="teams"),
        "teams/ml/train": M.queues.QueueSpec(name="teams/ml/train", parent="teams/ml"),
        "teams/infra": M.queues.QueueSpec(name="teams/infra", parent="teams"),
        "batch": M.queues.QueueSpec(name="batch"),
        "adhoc": M.queues.QueueSpec(name="adhoc"),
    }
    if order is not None:
        specs = {name: specs[name] for name in order}
    return M.queues.QueueTree(specs)


def fleet(M, zones=2, racks=1, hosts=2):
    return M.wl.bench_topology(), M.wl.synthetic_cluster(
        zones=zones, blocks_per_zone=1, racks_per_block=racks, hosts_per_rack=hosts)


def trace(M, duration_s=10.0, rate=1.0):
    return M.wl.expand_arrivals(M.wl.arrival_process(SEED, duration_s=duration_s,
                                                     base_rate=rate))


def gang(M, name, queue="", slo="", base=None):
    return M.podgang.PodGang(name=name, queue=queue, slo_class=slo, base_podgang_name=base)


def cell(M, name, nodes, topo, path, **kw):
    return M.cells.Cell(name, nodes, topo, journal_path=path, **{**M.kw, **kw})


def stats_doc(c) -> dict:
    return {k: v for k, v in c.stats.to_doc().items() if k not in WALL}


def twin(scenario):
    """Run `scenario(M)` on both packages; the results must be equal."""
    r, p = scenario(JAX), scenario(PORT)
    assert p == r
    return p


# ---- partition invariants (host only) -----------------------------------------------


def test_every_queue_maps_to_exactly_one_cell():
    def run(M):
        t = tree(M)
        plan = M.cells.partition_tree(t, 2)
        assert set(plan.queue_cell) == set(t.specs)
        for name in t.specs:
            assert plan.queue_cell[name] == plan.root_cell[t.root_of(name)]
        for leaf in t.leaves():
            assert len([c for c in plan.cells if leaf in plan.queues_of(c)]) == 1
        assert sorted(q for c in plan.cells for q in plan.queues_of(c)) == sorted(t.specs)
        return plan.to_doc()

    twin(run)


def test_partition_is_pure_and_insertion_order_independent():
    def run(M):
        a = M.cells.partition_tree(tree(M), 3)
        b = M.cells.partition_tree(tree(M, order=["adhoc", "batch", "teams", "teams/infra",
                                                  "teams/ml", "teams/ml/train"]), 3)
        assert a.to_doc() == b.to_doc()
        return a.to_doc()

    twin(run)


def test_partition_unpinned_without_tree():
    def run(M):
        plan = M.cells.partition_tree(None, 3)
        assert plan.cells == M.cells.cell_names(3)
        assert plan.queue_cell == {} and plan.cell_of_queue("anything") is None
        return plan.to_doc()

    twin(run)


def test_fleet_slices_tile_the_fleet_along_whole_domains():
    def run(M):
        _, nodes = fleet(M, zones=3)
        plan = M.cells.with_fleet(M.cells.partition_tree(tree(M), 2), nodes, M.wl.ZONE_KEY)
        slices = M.cells.fleet_slices(plan, nodes, M.wl.ZONE_KEY)
        flat = [n.name for ns in slices.values() for n in ns]
        assert sorted(flat) == sorted(n.name for n in nodes)
        for cname, ns in slices.items():
            assert all(plan.domain_cell[n.labels[M.wl.ZONE_KEY]] == cname for n in ns)
        assert M.cells.partition_domains(["z1", "z0", "z2"], plan.cells) == plan.domain_cell
        return {c: [n.name for n in ns] for c, ns in slices.items()}, plan.to_doc()

    twin(run)


# ---- the coordinator seam -------------------------------------------------------------


def test_cell_refuses_foreign_gang_outright(tmp_path):
    topo, nodes = fleet(PORT, zones=1)
    c = cell(PORT, "cell-0", nodes, topo, str(tmp_path / "cell-0"), owned_queues=("batch",))
    with pytest.raises(ValueError, match="coordinator"):
        c.serve([(0.0, gang(PORT, "g0", queue="teams/ml"))], {})


def test_coordinator_routes_pinned_and_spreads_families_whole():
    def run(M):
        plan = M.cells.partition_tree(tree(M), 2)
        coord = M.cells.CellCoordinator(plan, {})
        base_cell = coord.route(gang(M, "fam-0"))
        out = [coord.route(gang(M, "a", queue="teams/ml/train")),
               coord.route(gang(M, "b", queue="batch")), base_cell,
               coord.route(gang(M, "fam-1", base="fam-0"))]
        assert out[0] == plan.queue_cell["teams"] and out[3] == base_cell
        assigned = coord.assign([(0.0, gang(M, "fam-2", base="fam-0")),
                                 (1.0, gang(M, "c", queue="batch"))])
        assert any(g.name == "fam-2" for _, g in assigned[base_cell])
        return out, {c: [g.name for _, g in a] for c, a in assigned.items()}, \
            coord.stats.to_doc()

    twin(run)


def test_cell_partition_fault_defers_cross_cell_touch():
    def run(M):
        inj = M.faults.FaultInjector(
            {"cell.partition": M.faults.SiteSpec(kind="error", rate=1.0, count=1)}, seed=7)
        coord = M.cells.CellCoordinator(M.cells.partition_tree(None, 2), {}, faults=inj)
        out = [coord.reachable("cell-1"), coord.reachable("cell-1")]
        assert out == [False, True] and coord.stats.partition_deferred == 1
        return out, coord.stats.to_doc()

    twin(run)


def _two_cells(M, root, **kw):
    topo, nodes = fleet(M, zones=2, racks=1, hosts=2)
    plan = M.cells.with_fleet(M.cells.partition_tree(None, 2), nodes, M.wl.ZONE_KEY)
    slices = M.cells.fleet_slices(plan, nodes, M.wl.ZONE_KEY)
    cells = {c: cell(M, c, slices[c], topo, os.path.join(root, c), warm_path=warm(M), **kw)
             for c in plan.cells}
    for c in cells.values():
        c.start()
    return topo, plan, slices, cells


def test_borrow_and_reclaim_route_through_coordinator():
    def run(M):
        _, plan, _, cells = _two_cells(M, tempfile.mkdtemp())
        coord = M.cells.CellCoordinator(plan, cells)
        arrivals, pods = trace(M, duration_s=6.0, rate=0.8)
        bound = coord.borrow([arrivals[0]], pods, home="cell-0")
        assert bound, "the trace's first gang fits the other cell"
        host = next(h for _, (_, h) in coord._borrowed.items())
        assert host != "cell-0" and all(g in cells[host].bindings for g in bound)
        released = coord.reclaim("cell-0", pods)
        assert sorted(released) == sorted(bound) and not coord._borrowed
        assert float(cells[host].snapshot.allocated.sum()) == pytest.approx(0.0)
        for c in cells.values():
            c.close()
        return bound, host, released, coord.stats.to_doc(), \
            {n: stats_doc(c) for n, c in cells.items()}

    twin(run)


def test_reclaim_then_crash_then_recover_keeps_gang_released():
    def run(M):
        root = tempfile.mkdtemp()
        topo, plan, slices, cells = _two_cells(M, root)
        coord = M.cells.CellCoordinator(plan, cells)
        arrivals, pods = trace(M, duration_s=6.0, rate=0.8)
        bound = coord.borrow([arrivals[0]], pods, home="cell-0")
        host = cells[next(h for _, h in coord._borrowed.values())]
        released = coord.reclaim("cell-0", pods)
        assert sorted(released) == sorted(bound)
        live = host.snapshot.allocated.copy()
        host.crash()
        recovered, report = M.cells.recover(host.name, slices[host.name], topo,
                                            journal_path=os.path.join(root, host.name),
                                            verify=False, **M.kw)
        assert report.gangs_reclaimed == len(released)
        assert not set(released) & set(recovered.bindings)
        np.testing.assert_allclose(recovered.snapshot.allocated, live, rtol=1e-5, atol=1e-9)
        for c in cells.values():
            if c.alive:
                c.close()
        return report.to_doc(), sorted(recovered.bindings), \
            recovered.snapshot.allocated.tolist()

    twin(run)


def test_borrow_crash_mid_family_registers_partial_and_stops():
    """Host-only (stub cells): a partial landing is registered for reclaim
    and the family is not retried; an empty partial stays retryable."""
    def run(M):
        class Stub:
            def __init__(self, name, partial=None):
                self.name, self.alive, self._partial = name, True, partial
                self.snapshot = SimpleNamespace(free=np.ones(4))
                self.families_offered = []

            def admit_borrowed(self, fam, pods):
                self.families_offered.append([g.name for _, g in fam])
                if self._partial is not None:
                    self.alive = False
                    raise M.cells.CellCrash(self.name, partial=self._partial)
                return {g.name: {} for _, g in fam}

        fam = [(0.0, gang(M, "famA-0")), (0.0, gang(M, "famA-1", base="famA-0")),
               (0.0, gang(M, "famA-2", base="famA-0"))]
        plan = M.cells.partition_tree(None, 3)
        healthy = Stub("cell-2")
        coord = M.cells.CellCoordinator(plan, {
            "cell-0": Stub("cell-0"), "cell-1": Stub("cell-1", {"famA-0": {"p0": "n0"}}),
            "cell-2": healthy})
        bound = coord.borrow(fam, {}, home="cell-0")
        assert bound == {"famA-0": {"p0": "n0"}} and healthy.families_offered == []
        healthy2 = Stub("cell-2")
        coord2 = M.cells.CellCoordinator(plan, {
            "cell-0": Stub("cell-0"), "cell-1": Stub("cell-1", {}), "cell-2": healthy2})
        bound2 = coord2.borrow(fam, {}, home="cell-0")
        assert set(bound2) == {"famA-0", "famA-1", "famA-2"}
        return bound, dict(coord._borrowed), coord.stats.to_doc(), bound2, \
            dict(coord2._borrowed), healthy2.families_offered

    twin(run)


def test_rejected_gangs_stay_reofferable():
    def run(M):
        topo, nodes = fleet(M, zones=1, racks=1, hosts=2)
        arrivals, pods = trace(M, duration_s=12.0, rate=1.5)
        c = cell(M, "cell-0", nodes, topo, os.path.join(tempfile.mkdtemp(), "cell-0"),
                 warm_path=warm(M))
        c.start()
        first = c.serve(arrivals, pods)
        rejected = c.decided - set(c.bindings)
        assert rejected, "the trace overfills the 2-node slice"
        fams = {(g.base_podgang_name or g.name) for _, g in arrivals if g.name in rejected}
        redo = [(t, g) for t, g in arrivals if (g.base_podgang_name or g.name) in fams]
        expected = sum(1 for _, g in redo if g.name not in c.bindings)
        before, before_bound = c.stats.offered, set(c.bindings)
        again = c.serve(redo, pods)
        c.close()
        assert c.stats.offered == before + expected and not set(again) & before_bound
        return first, again, sorted(c.decided), stats_doc(c)

    twin(run)


# ---- LeaseSet: independent per-cell renewal clocks ----------------------------------------


def test_losing_one_cells_lease_never_releases_anothers():
    def run(M):
        d = tempfile.mkdtemp()
        ls = M.lease.LeaseSet(d, lease_duration_seconds=10.0, renew_deadline_seconds=4.0)
        out = [ls.try_acquire("cell-a", now=0.0), ls.try_acquire("cell-b", now=0.0),
               ls.try_acquire("cell-a", now=3.0), ls.try_acquire("cell-b", now=9.0),
               ls.held(now=9.0), ls.held(now=13.5),
               os.path.exists(os.path.join(d, "cell-a.lease")),
               os.path.exists(os.path.join(d, "cell-b.lease")),
               ls.try_acquire("cell-a", now=6.0), ls.try_acquire("cell-b", now=9.5)]
        assert out == [True, True, True, False, {"cell-a": True, "cell-b": False},
                       {"cell-a": False, "cell-b": False}, True, False, True, True]
        return out

    twin(run)


def test_leaseset_rejects_path_escaping_names():
    ls = p_lease.LeaseSet(tempfile.mkdtemp())
    for bad in ("", "../evil", "a/b", ".hidden"):
        with pytest.raises(ValueError):
            ls.lease(bad)


def test_filelease_held_is_public_and_expiry_aware():
    def run(M):
        lease = M.lease.FileLease(path=os.path.join(tempfile.mkdtemp(), "x.lease"),
                                  lease_duration_seconds=10.0)
        out = [lease.held(now=0.0), lease.try_acquire(now=0.0), lease.held(now=5.0),
               lease.held(now=10.0), lease.try_acquire(now=11.0), lease.held(now=12.0)]
        assert out == [False, True, True, False, True, True]
        return out

    twin(run)


# ---- the recorder's segment manifest ------------------------------------------------


def test_recorder_writes_segment_manifest_and_prunes_it():
    def run(M):
        d = tempfile.mkdtemp()
        rec = M.rec.TraceRecorder(d, max_records_per_file=2, max_files=2)
        rec.start()
        for i in range(10):
            rec.capture_action(float(i), "noop", f"obj-{i}")
        rec.stop()
        manifest = M.rec.read_manifest(d)
        files = sorted(f for f in os.listdir(d) if f.startswith("segment-"))
        assert [s["file"] for s in manifest["segments"]] == files and 0 < len(files) <= 2
        assert sum(s["records"] for s in manifest["segments"]) == len(M.rec.read_journal(d))
        assert M.rec.read_manifest(tempfile.mkdtemp()) is None
        return {k: v for k, v in manifest.items() if k != "updatedAt"}

    twin(run)


def test_manifest_names_the_resume_point_for_wave_journals():
    def run(M):
        topo, nodes = fleet(M, zones=1, racks=1, hosts=2)
        arrivals, pods = trace(M, duration_s=6.0, rate=0.8)
        jp = os.path.join(tempfile.mkdtemp(), "cell-0")
        c = cell(M, "cell-0", nodes, topo, jp, warm_path=warm(M))
        c.start()
        c.serve(arrivals, pods)
        c.close()
        manifest = M.rec.read_manifest(jp)
        last = None
        for seg in manifest["segments"]:
            if seg["waveRange"] is not None:
                assert seg["waveRange"][0].startswith("c")
                last = seg["waveRange"][1]
        assert manifest["waves"] > 0 and manifest["lastWave"] == last is not None
        return manifest["lastWave"], manifest["waves"], \
            [s["waveRange"] for s in manifest["segments"]]

    twin(run)


# ---- the tentpole: a 2-cell kill and resume from the journal tail ----------------------


def test_two_cell_kill_resume_recovers_from_journal_tail():
    def run(M):
        root = tempfile.mkdtemp()
        topo, nodes = fleet(M, zones=2, racks=1, hosts=2)
        plan = M.cells.with_fleet(M.cells.partition_tree(None, 2), nodes, M.wl.ZONE_KEY)
        slices = M.cells.fleet_slices(plan, nodes, M.wl.ZONE_KEY)
        arrivals, pods = trace(M, duration_s=11.0, rate=1.2)
        inj = M.faults.FaultInjector(
            {"cell.crash": M.faults.SiteSpec(kind="error", rate=1.0, count=1)}, seed=3)
        cells = {c: cell(M, c, slices[c], topo, os.path.join(root, c),
                         faults=inj if c == "cell-0" else None, crash_check_every=4,
                         warm_path=warm(M)) for c in plan.cells}
        for c in cells.values():
            c.start()
        assigned = M.cells.CellCoordinator(plan, cells).assign(arrivals)
        survivor = cells["cell-1"].serve(assigned["cell-1"], pods)
        with pytest.raises(M.cells.CellCrash):
            cells["cell-0"].serve(assigned["cell-0"], pods)
        pre_decided, pre_bound = set(cells["cell-0"].decided), dict(cells["cell-0"].bindings)
        assert pre_decided
        jp0 = os.path.join(root, "cell-0")
        repl, report = M.cells.recover("cell-0", slices["cell-0"], topo, journal_path=jp0,
                                       crash_check_every=4, warm_path=warm(M), **M.kw)
        assert report.verified and report.divergences == 0 and report.waves_replayed > 0
        assert repl.decided == pre_decided and set(repl.bindings) == set(pre_bound)
        repl.start()
        resumed = repl.serve(assigned["cell-0"], pods)
        repl.close()
        cells["cell-1"].close()
        assert not set(resumed) & set(pre_bound)
        assert {g.name for _, g in assigned["cell-0"]} <= repl.decided
        audit = M.cells.audit_journal(M.rec.read_journal(jp0))
        assert audit["oversubscribed"] == 0 and audit["nodeTicks"] > 0
        check, _ = M.cells.recover("cell-0", slices["cell-0"], topo, journal_path=jp0,
                                   verify=False, **M.kw)
        np.testing.assert_allclose(check.snapshot.allocated, repl.snapshot.allocated,
                                   rtol=1e-5)
        return survivor, pre_bound, resumed, report.to_doc(), audit, stats_doc(repl)

    twin(run)


def test_recover_flags_rotation_truncated_journal():
    def run(M):
        topo, nodes = fleet(M, zones=1, racks=1, hosts=2)
        arrivals, pods = trace(M, duration_s=8.0, rate=1.0)
        jp = os.path.join(tempfile.mkdtemp(), "cell-0")
        c = cell(M, "cell-0", nodes, topo, jp, warm_path=warm(M), crash_check_every=2,
                 max_records_per_file=1, max_files=2)
        c.start()
        c.serve(arrivals, pods)
        c.close()
        assert M.rec.read_manifest(jp)["prunedSegments"] > 0 and M.rec.journal_truncated(jp)
        _, report = M.cells.recover("cell-0", nodes, topo, journal_path=jp,
                                    warm_path=warm(M), **M.kw)
        assert report.truncated and report.divergences == 0 and not report.verified
        jp2 = os.path.join(tempfile.mkdtemp(), "cell-1")
        c2 = cell(M, "cell-1", nodes, topo, jp2, warm_path=warm(M))
        c2.start()
        c2.serve(arrivals[:2], pods)
        c2.close()
        assert not M.rec.journal_truncated(jp2)
        _, rep2 = M.cells.recover("cell-1", nodes, topo, journal_path=jp2, verify=False, **M.kw)
        assert not rep2.truncated
        return report.to_doc(), rep2.to_doc()

    twin(run)


def test_cell_needs_the_card_unless_asked(tmp_path):
    import torch

    assert not torch.cuda.is_available()
    topo, nodes = fleet(PORT, zones=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cells.Cell("cell-0", nodes, topo, journal_path=str(tmp_path / "c"))


# ---- bench.py's cells scenario ---------------------------------------------------------


def test_cells_bench_document_equals_jax(monkeypatch):
    """bench.py's run_cells_bench (its GROVE_BENCH_CELLS_* knobs set to a
    4 s trace, 4 arrivals between crash checks, so the injected crash lands
    between chunks) and the port's at the same arguments: every gate green,
    the documents equal but for their wall-clock keys."""
    import bench

    monkeypatch.setenv("GROVE_BENCH_CELLS_DURATION_S", "4")
    monkeypatch.setenv("GROVE_BENCH_CELLS_RATE", "4")
    monkeypatch.setenv("GROVE_BENCH_CELLS_SEED", str(SEED))
    monkeypatch.setenv("GROVE_BENCH_CELLS_CHUNK", "4")
    ref = bench.run_cells_bench()
    port = p_bench.run_cells_bench(device="cpu", duration_s=4.0, rate=4.0, seed=SEED, chunk=4)
    assert set(port) == set(ref)
    assert p_bench.cells_doc_core(port) == p_bench.cells_doc_core(ref)
    assert port["vs_baseline"] == 1.0 and all(port["gates"].values()), port["gates"]
    assert port["nodes"] == 32 and port["gangs_offered"] > 0


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_cells.py` on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cells_bench_on_the_card_equals_the_cpu(cuda):
    """chip_smoke.py phase 17 at a 4 s trace: every gate green on the card,
    the document the CPU run's (wall-clock keys aside)."""
    card = p_bench.run_cells_bench(device=cuda, duration_s=4.0, chunk=4)
    cpu = p_bench.run_cells_bench(device="cpu", duration_s=4.0, chunk=4)
    assert card["vs_baseline"] == 1.0, card["gates"]
    assert p_bench.cells_doc_core(card) == p_bench.cells_doc_core(cpu)
