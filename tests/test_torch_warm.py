"""The port's warm path (grove_tpu_torch/solver/warm.py and the vectorized
encode) against the JAX package's (grove_tpu/solver/warm.py), on the same
inputs built from the same descriptions:

  - encode_gangs with a cold and a warm EncodeRowCache equals JAX
    encode_gangs with its own, byte for byte, decode info included, with
    the same hits, misses, sets_hits and sets_misses; a new epoch misses,
    bucket drift demotes a hit, a fresh pin re-encodes the pinned gang;
  - gang_row_digest tuples and encode epochs equal JAX's; the digest tracks
    the spec, not the object (tests/test_warm.py:187,
    tests/test_hostpath.py:351);
  - SnapshotDeviceCache reuses its uploads and the DomainIndex across
    rebuilt snapshots (tests/test_warm.py:129);
  - ExecutableCache keying, donation, prewarm from history and the idle
    prewarm thread (tests/test_warm.py:52-127); its history file after a
    drain equals JAX's, descriptors and counts; its LRU bound;
  - solve(warm=), replay_journal(warm_path=) and sweep_journal(warm_path=)
    give JAX's results with JAX's counters; solve() without `warm` goes
    through the process-shared warm path;
  - on the card (`gpu`): a cached replay equals a direct launch, two
    snapshots under one entry each get their own answer, spread waves
    replayed again and chained under one entry equal direct launches,
    replays count as launches.

The drain matrix (every harvest discipline, dense and pruned, cold then
warm) is tests/test_torch_warm_drain.py.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from grove_tpu.solver import core as rc
from grove_tpu.solver import pruning as rp
from grove_tpu.solver import warm as rw
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.drain import plan_waves as r_plan
from grove_tpu.trace.replay import replay_journal as r_replay
from grove_tpu.tuning import default_grid as r_grid
from grove_tpu.tuning import incumbent_config as r_incumbent
from grove_tpu.tuning import sweep_journal as r_sweep
from grove_tpu_torch.solver import core as pc
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver import warm as pw
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.drain import plan_waves as p_plan
from grove_tpu_torch.trace.replay import replay_journal as p_replay
from grove_tpu_torch.tuning import default_grid, incumbent_config, sweep_journal
from test_torch_host import (
    PORT,
    RACK,
    REF,
    ZONE,
    _bench,
    _simple1,
    assert_batches_equal,
    build_pair,
    mk_nodes,
    topology,
)

ROW_COUNTERS = ("hits", "misses", "sets_hits", "sets_misses")
EXEC_COUNTERS = ("hits", "misses", "lowerings")


@pytest.fixture(autouse=True, scope="module")
def _no_shared_xla_cache():
    """This module's JAX compiles stay out of the suite's persistent XLA
    cache (tests/conftest.py): the cache writes its entries in place, and a
    worker reading an entry that another worker is writing at that moment
    can crash. The module compiles without it; the setting is restored
    after."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    cc.reset_cache()


def _keys(mod, gangs, pods, epoch):
    return [(mod.gang_row_digest(g, pods), epoch) for g in gangs]


def _same_encode(rout, pout):
    (rb, rdec), (pb, pdec) = rout, pout
    assert_batches_equal(rb, pb)
    assert rdec.gang_names == pdec.gang_names
    assert rdec.pod_names == pdec.pod_names
    assert rdec.group_names == pdec.group_names


def _same_rows(rcache, pcache):
    for f in ROW_COUNTERS:
        assert getattr(pcache, f) == getattr(rcache, f), f
    assert pcache.stats().keys() == rcache.stats().keys()


def _tainted(P):
    """simple1 with a nodeSelector on 8 nodes, three of them tainted
    NoSchedule, and the pods of one clique tolerating the taint."""
    gangs, pods, _ = _simple1(P, selector={"pool": "tpu"})
    nodes = mk_nodes(P, 8, pool_from=2)
    for nd in nodes[2:5]:
        nd.taints = [{"key": "dedicated", "value": "x", "effect": "NoSchedule"}]
    nodes[6].taints = [{"key": "soft", "effect": "PreferNoSchedule"}]
    first = gangs[0].spec.pod_groups[0]
    for ref in first.pod_references:
        pods[ref.name].spec.tolerations = [
            {"key": "dedicated", "operator": "Equal", "value": "x", "effect": "NoSchedule"}]
    return gangs, pods, P.build_snapshot(nodes, topology(P, ((ZONE, "zone"), (RACK, "rack"))))


# ---- encode-row reuse -------------------------------------------------------------


@pytest.mark.parametrize("name", ["bench_small", "selector", "spread_pack", "nondyadic",
                                  "wl3", "tainted"])
def test_encode_cold_and_warm_equal_jax(name):
    """Cold then warm encode of the whole backlog, padded past the pow2 edge
    (padded rows exercised), with reuse seeds: batches, decode info and the
    row cache's counters equal JAX's."""
    if name == "tainted":
        (rg, rp_, rs), (pg, pp_, ps) = _tainted(REF), _tainted(PORT)
        assert ps.tainted_node_indices(("NoSchedule", "NoExecute")) == [2, 3, 4]
    else:
        (rg, rp_, rs), (pg, pp_, ps) = build_pair(name)
    assert ps.encode_epoch() == rs.encode_epoch()
    rkeys, pkeys = _keys(rw, rg, rp_, rs.encode_epoch()), _keys(pw, pg, pp_, ps.encode_epoch())
    assert pkeys == rkeys
    pad = 1 << len(rg).bit_length()
    kw = dict(pad_gangs_to=pad, reuse_nodes_by_gang={rg[0].name: [0, 1]},
              scheduled_gangs={g.name for g in rg[::3]})
    rcache, pcache = rw.EncodeRowCache(), pw.EncodeRowCache()
    for _ in range(2):
        rout = REF.encode_gangs(rg, rp_, rs, row_cache=rcache, row_keys=rkeys, **kw)
        pout = PORT.encode_gangs(pg, pp_, ps, row_cache=pcache, row_keys=pkeys, **kw)
        _same_encode(rout, pout)
        _same_rows(rcache, pcache)
    assert pcache.hits == len(pg) and pcache.misses == len(pg)
    if name == "tainted":
        assert pout[0].group_node_ok is not None


def test_bench_backlog_waves_cold_and_warm_equal_jax():
    """The bench backlog at scale 0.25 (1280 nodes), encoded wave by wave as
    the drain encodes it, twice through one row cache: every wave byte-equal
    to JAX's, and the warm pass all hits."""
    n = tuple(max(1, round(k * 0.25)) for k in (350, 250, 300))
    (rg, rp_, rs), (pg, pp_, ps) = _bench(REF, racks_per_block=4, n=n), \
        _bench(PORT, racks_per_block=4, n=n)
    assert [pw.gang_row_digest(g, pp_) for g in pg] == [rw.gang_row_digest(g, rp_) for g in rg]
    rwaves, pwaves = r_plan(rg, 256), p_plan(pg, 256)
    rgi = {g.name: i for i, g in enumerate(rg)}
    pgi = {g.name: i for i, g in enumerate(pg)}
    rcache, pcache = rw.EncodeRowCache(), pw.EncodeRowCache()
    for rnd in range(2):
        for (rwv, (mg, ms, mp), pad), (pwv, _, _) in zip(rwaves, pwaves):
            kw = dict(max_groups=mg, max_sets=ms, max_pods=mp, pad_gangs_to=pad)
            rout = REF.encode_gangs(rwv, rp_, rs, global_index_of=rgi, row_cache=rcache,
                                    row_keys=_keys(rw, rwv, rp_, rs.encode_epoch()), **kw)
            pout = PORT.encode_gangs(pwv, pp_, ps, global_index_of=pgi, row_cache=pcache,
                                     row_keys=_keys(pw, pwv, pp_, ps.encode_epoch()), **kw)
            _same_encode(rout, pout)
        _same_rows(rcache, pcache)
    assert pcache.hits == len(pg) == pcache.misses


def test_epoch_change_drift_and_fresh_pin_equal_jax():
    """A new epoch misses every gang; a wider bucket demotes every hit (its
    constraint walk still hits the sets memo); a gang given a bound pod
    re-encodes alone, pinned. Counters and batches equal JAX's each time."""
    (rg, rp_, rs), (pg, pp_, ps) = build_pair("bench_small")
    rcache, pcache = rw.EncodeRowCache(), pw.EncodeRowCache()

    def both(repoch, pepoch, **kw):
        rout = REF.encode_gangs(rg, rp_, rs, row_cache=rcache,
                                row_keys=_keys(rw, rg, rp_, repoch), **kw)
        pout = PORT.encode_gangs(pg, pp_, ps, row_cache=pcache,
                                 row_keys=_keys(pw, pg, pp_, pepoch), **kw)
        _same_encode(rout, pout)
        _same_rows(rcache, pcache)
        return pout

    n = len(pg)
    both(rs.encode_epoch(), ps.encode_epoch())
    both(("other-epoch",), ("other-epoch",))
    assert pcache.misses == 2 * n and pcache.hits == 0
    mp = max(g.total_pods() for g in pg)
    both(rs.encode_epoch(), ps.encode_epoch(), max_pods=2 * mp)
    assert pcache.hits == 0 and pcache.misses == 3 * n and pcache.sets_hits >= n
    # A gang with a required pack-set gains a bound pod: it alone misses.
    gang = next(g for g in pg if g.spec.topology_constraint is not None)
    bound = {gang.name: {gang.spec.pod_groups[0].name: [5]}}
    b, _ = both(rs.encode_epoch(), ps.encode_epoch(), max_pods=2 * mp,
                bound_nodes_by_group=bound)
    assert pcache.misses == 3 * n + 1 and pcache.hits == n - 1
    assert (b.set_pinned >= 0).any()


# ---- the digest ---------------------------------------------------------------------


def test_gang_row_digest_tracks_spec_not_identity():
    """tests/test_warm.py:187: a rebuilt equal gang digests the same, a floor
    change does not; tests/test_hostpath.py:351: a replaced pod object with
    other requests changes the digest (the memo guards it)."""
    (rg, rp_, _), (pg, pp_, _) = build_pair("simple1")
    (_, _, _), (pg2, pp2, _) = build_pair("simple1")
    assert [pw.gang_row_digest(g, pp_) for g in pg] == [rw.gang_row_digest(g, rp_) for g in rg]
    assert pw.gang_row_digest(pg[0], pp_) == pw.gang_row_digest(pg2[0], pp2)
    pg2[0].spec.pod_groups[0].min_replicas += 1
    assert pw.gang_row_digest(pg[0], pp_) != pw.gang_row_digest(pg2[0], pp2)
    gang = pg[0]
    d1 = pw.gang_row_digest(gang, pp_)
    assert pw.gang_row_digest(gang, pp_) == d1
    first = gang.spec.pod_groups[0].pod_references[0].name
    replacement = copy.deepcopy(pp_[first])
    for c in replacement.spec.containers:
        c.requests = {k: v + 1 for k, v in c.requests.items()}
    assert pw.gang_row_digest(gang, {**pp_, first: replacement}) != d1


# ---- the device cache ---------------------------------------------------------------


def test_device_cache_reuses_uploads_and_domain_index():
    """Rebuilt snapshots of equal content reuse the same tensors and the
    same DomainIndex; changed content uploads anew."""
    dc = pw.SnapshotDeviceCache()
    _, (_, _, snap_a) = build_pair("simple1")
    _, (_, _, snap_b) = build_pair("simple1")
    first = dc.snapshot_arrays(snap_a, device="cpu")
    dom = dc.domain_index(snap_a.node_domain_id, "cpu")
    misses = dc.misses
    second = dc.snapshot_arrays(snap_b, device="cpu")
    assert all(a is b for a, b in zip(first, second))
    assert dc.misses == misses and dc.hits >= 4
    assert dc.domain_index(snap_b.node_domain_id, "cpu") is dom
    assert (dc.domain_hits, dc.domain_misses) == (1, 1)
    snap_b.capacity[0, 0] -= 1.0
    assert dc.snapshot_arrays(snap_b, device="cpu")[1] is not first[1]
    rdc = rw.SnapshotDeviceCache()
    assert set(rdc.stats()) <= set(dc.stats())


# ---- the launch cache ---------------------------------------------------------------


def _solve_args(P, pad):
    gangs, pods, _ = _simple1(P)
    nodes = mk_nodes(P, 8, cpu=16.0)
    snap = P.build_snapshot(nodes, topology(P), pad_nodes_to=pad)
    batch, _ = P.encode_gangs(gangs, pods, snap)
    return snap.free, snap.capacity, snap.schedulable, snap.node_domain_id, batch


def test_executable_cache_keying_and_no_second_lowering():
    """Node pads 8 and 16 never alias, a repeated key is a hit, another
    coarse_dmax is another key, donation is another key; the cached solve
    equals solve_batch."""
    cache = pw.ExecutableCache()
    args8, args16 = _solve_args(PORT, 8), _solve_args(PORT, 16)
    r8 = cache.solve(*args8, device="cpu")
    assert (cache.lowerings, cache.misses) == (1, 1)
    cache.solve(*args16, device="cpu")
    assert cache.lowerings == 2
    r8b = cache.solve(*args8, device="cpu")
    assert cache.lowerings == 2 and cache.hits == 1
    cache.solve(*args8, coarse_dmax=4, device="cpu")
    assert cache.lowerings == 3
    cache.solve(*args8, donate=True, device="cpu")
    assert cache.lowerings == 4
    ref = pc.solve_batch(*args8, device="cpu")
    for a, b, c in zip(r8[:4], ref[:4], r8b[:4]):
        assert torch.equal(a, b) and torch.equal(a, c)
    # The same sequence through JAX's cache counts the same.
    rcache = rw.ExecutableCache()
    r8a, r16a = _solve_args(REF, 8), _solve_args(REF, 16)
    for args, kw in ((r8a, {}), (r16a, {}), (r8a, {}), (r8a, {"coarse_dmax": 4}),
                     (r8a, {"donate": True})):
        rcache.solve(*args, **kw)
    for f in EXEC_COUNTERS:
        assert getattr(cache, f) == getattr(rcache, f), f
    assert cache.stats().keys() == rcache.stats().keys()


def test_executable_cache_keeps_the_most_recently_used_entries():
    """Past `max_entries` the least recently used entry goes: a hit renews
    an entry, and an evicted key prepares again."""
    cache = pw.ExecutableCache(max_entries=2)
    args8, args16 = _solve_args(PORT, 8), _solve_args(PORT, 16)
    cache.solve(*args8, device="cpu")
    cache.solve(*args16, device="cpu")
    cache.solve(*args8, device="cpu")  # a hit: pad 8 is now the newest
    cache.solve(*args8, coarse_dmax=4, device="cpu")  # a third key evicts pad 16
    assert (cache.lowerings, cache.hits, cache.stats()["executables"]) == (3, 1, 2)
    cache.solve(*args8, device="cpu")
    assert (cache.lowerings, cache.hits) == (3, 2)
    cache.solve(*args16, device="cpu")
    assert (cache.lowerings, cache.misses, cache.stats()["executables"]) == (4, 4, 2)


def test_solve_without_a_warm_path_uses_the_shared_one():
    """solve() with no `warm` goes through default_warm_path(): its launch
    cache prepares the solve's shape once, and the result is the one an
    explicit WarmPath gives."""
    gangs, pods, snap = build_pair("bench_small")[1]
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    shared = pw.default_warm_path().executables
    before = (shared.lowerings, shared.hits)
    got = [pc.solve(snap, batch, device="cpu") for _ in range(2)]
    assert shared.lowerings - before[0] <= 1 and shared.hits - before[1] >= 1
    want = pc.solve(snap, batch, device="cpu", warm=pw.WarmPath())
    for res in got:
        for a, b in zip(res[:4], want[:4]):
            assert torch.equal(a, b)


def test_prewarm_from_history(tmp_path):
    """A fresh cache prepares the recorded shapes from the history file
    alone, and the first real solve is then a hit."""
    history = str(tmp_path / "solve-shapes.json")
    args = _solve_args(PORT, 8)
    recorder = pw.ExecutableCache(history_path=history)
    recorder.solve(*args, device="cpu")
    fresh = pw.ExecutableCache(history_path=history)
    prepared = fresh.prewarm_from_history(top_k=4, device="cpu")
    assert prepared == 1 and fresh.prewarmed == 1 and fresh.lowerings == 1
    fresh.solve(*args, device="cpu")
    assert fresh.lowerings == 1 and fresh.hits == 1
    assert fresh.prewarm_from_history(top_k=4, device="cpu") == 0


def test_prewarm_thread_noop_without_history(tmp_path):
    cache = pw.ExecutableCache(history_path=str(tmp_path / "missing.json"))
    assert cache.start_prewarm_thread(4, device="cpu") is None
    assert pw.ExecutableCache().start_prewarm_thread(4, device="cpu") is None


@pytest.mark.parametrize("harvest", ["chained", "scan"])
def test_history_file_equals_jax(tmp_path, harvest):
    """After the same drain, the port's shape history holds JAX's
    descriptors with JAX's counts (scan descriptors included)."""
    (rg, rp_, rs), (pg, pp_, ps) = build_pair("bench_small")
    rwp, pwp = rw.WarmPath(), pw.WarmPath()
    rwp.executables.history_path = str(tmp_path / "jax.json")
    pwp.executables.history_path = str(tmp_path / "port.json")
    r_drain(rg, rp_, rs, wave_size=4, harvest=harvest, warm_path=rwp)
    p_drain(pg, pp_, ps, wave_size=4, harvest=harvest, warm_path=pwp, device="cpu")
    jax_doc = json.loads((tmp_path / "jax.json").read_text())
    port_doc = json.loads((tmp_path / "port.json").read_text())
    assert port_doc == jax_doc and port_doc["shapes"]
    if harvest == "scan":
        assert any(e["desc"].get("scan") for e in port_doc["shapes"].values())
    fresh = pw.ExecutableCache(history_path=str(tmp_path / "port.json"))
    assert fresh.prewarm_from_history(top_k=64, device="cpu") == len(port_doc["shapes"])


# ---- solve(warm=), replay and the sweep ----------------------------------------------


def _warm_solves(P, wmod, core, snap, batch, **kw):
    wp = wmod.WarmPath()
    results = [core.solve(snap, batch, warm=wp, **kw) for _ in range(2)]
    return wp, results


@pytest.mark.parametrize("case", ["bench_small", "contended", "trap", "pruned"])
def test_solve_warm_equals_jax(case):
    """solve(warm=) twice: JAX's verdicts, assignments, scores and carry,
    and JAX's launch, device and prune counters."""
    scen = {"trap": "binpack_trap", "pruned": "contended"}.get(case, case)
    (rg, rp_, rs), (pg, pp_, ps) = build_pair(scen)
    rb, _ = REF.encode_gangs(rg, rp_, rs)
    pb, _ = PORT.encode_gangs(pg, pp_, ps)
    rkw, pkw = {}, {"device": "cpu"}
    if case == "trap":
        rkw["escalate_portfolio"] = pkw["escalate_portfolio"] = 4
    if case == "pruned":
        cfg = dict(enabled=True, max_candidates=32, min_fleet=16, min_pad=8)
        rkw["pruning"], pkw["pruning"] = rp.PruningConfig(**cfg), pp.PruningConfig(**cfg)
    rwp, rres = _warm_solves(REF, rw, rc, rs, rb, **rkw)
    pwp, pres = _warm_solves(PORT, pw, pc, ps, pb, **pkw)
    for r, p in zip(rres, pres):
        for name in ("ok", "assigned", "placement_score", "free_after"):
            want = np.asarray(getattr(r, name))
            got = getattr(p, name).numpy()
            assert want.dtype == got.dtype and np.array_equal(want, got), name
    rstats, pstats = rwp.stats(), pwp.stats()
    assert set(rstats) <= set(pstats)
    for key in ("execHits", "execMisses", "lowerings", "deviceHits", "deviceMisses",
                "pruneSolves", "pruneEscalations", "pruneEscalationsAdopted",
                "pruneDenseFallbacks"):
        assert pstats[key] == rstats[key], key
    if case == "pruned":
        assert pstats["pruneSolves"] == 2
    else:
        assert pstats["lowerings"] == 1 and pstats["execHits"] >= 1


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    from test_torch_sweep import SMALL
    from test_torch_trace import PRUNED, jax_drain_journal

    d = tmp_path_factory.mktemp("warm_journals")
    return {
        "scan": jax_drain_journal(d / "scan", harvest="scan", **SMALL)[0],
        "pruned": jax_drain_journal(d / "pruned", pruning=PRUNED, n=(5, 4, 4),
                                    wave_size=16)[0],
    }


@pytest.mark.parametrize("name", ["scan", "pruned"])
def test_replay_and_sweep_through_one_warm_path_equal_jax(journals, name):
    """replay_journal and sweep_journal (K = 4), each through one WarmPath:
    0 divergences, and the launch cache's counters equal JAX's."""
    records = journals[name]
    rwp, pwp = rw.WarmPath(), pw.WarmPath()
    rrep = r_replay(records, warm_path=rwp)
    prep = p_replay(records, warm_path=pwp, device="cpu")
    assert prep.divergence_count == rrep.divergence_count == 0
    for f in EXEC_COUNTERS:
        assert getattr(pwp.executables, f) == getattr(rwp.executables, f), f
    rwp2, pwp2 = rw.WarmPath(), pw.WarmPath()
    r_sweep(records, r_grid(r_incumbent(records), 4), warm_path=rwp2)
    port = sweep_journal(records, default_grid(incumbent_config(records), 4), warm_path=pwp2,
                         device="cpu")
    assert sum(t.divergences for t in port.tallies.values()) == 0
    for f in EXEC_COUNTERS:
        assert getattr(pwp2.executables, f) == getattr(rwp2.executables, f), f
    assert pwp2.executables.lowerings > 0


# ---- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_warm.py` on the card")
    return torch.device("cuda", 0)


def _card_case(dev, scenario="bench_small"):
    _, (gangs, pods, snap) = build_pair(scenario)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    okg = torch.zeros(len(gangs), dtype=torch.bool, device=dev)
    return snap, batch, okg


def _direct(snap, batch, okg, dev):
    from grove_tpu_torch.kernels.place_wave import domain_index

    free = torch.as_tensor(snap.free, dtype=torch.float32, device=dev)
    return pc.solve_batch(free, snap.capacity, snap.schedulable, snap.node_domain_id, batch,
                          None, okg.clone(), device=dev,
                          domains=domain_index(snap.node_domain_id, dev))


@pytest.mark.gpu
def test_cached_replay_equals_direct_launch(cuda):
    snap, batch, okg = _card_case(cuda)
    cache = pw.ExecutableCache()
    args = (torch.as_tensor(snap.free, device=cuda), snap.capacity, snap.schedulable,
            snap.node_domain_id, batch, None, okg)
    first = cache.solve(*args, device=cuda)
    again = cache.solve(*args, device=cuda)
    want = _direct(snap, batch, okg, cuda)
    for got in (first, again):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (cache.lowerings, cache.hits) == (1, 1)


@pytest.mark.gpu
def test_two_snapshots_under_one_entry_get_their_own_answers(cuda):
    """The same shapes, other contents: the replay reads the new inputs."""
    snap, batch, okg = _card_case(cuda, "bench_small")
    _, (g2, p2, snap2) = build_pair("bench_small")
    snap2.allocated[::3] = snap2.capacity[::3] * np.float32(0.5)
    cache = pw.ExecutableCache()
    outs = []
    for s in (snap, snap2):
        out = cache.solve(torch.as_tensor(s.free, device=cuda), s.capacity, s.schedulable,
                          s.node_domain_id, batch, None, okg, device=cuda)
        want = _direct(s, batch, okg, cuda)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        outs.append(out)
    assert cache.lowerings == 1
    assert not torch.equal(outs[0].free_after, outs[1].free_after)


@pytest.mark.gpu
@pytest.mark.parametrize("scenario", ["bench_spread", "spread_pack"])
def test_spread_wave_replays_equal_direct_launches(cuda, scenario):
    """A spread wave through one entry twice, then a chain of two waves of
    that key: every replay equals a direct launch. (A replay that did not
    zero the spread family rows its entry's last replay marked would
    not.)"""
    snap, batch, okg = _card_case(cuda, scenario)
    assert batch.spread_level is not None
    cache = pw.ExecutableCache()
    free = torch.as_tensor(snap.free, device=cuda)
    node = (snap.capacity, snap.schedulable, snap.node_domain_id)
    want = _direct(snap, batch, okg, cuda)
    for _ in range(2):
        for a, b in zip(cache.solve(free, *node, batch, None, okg, device=cuda), want):
            assert torch.equal(a, b)
    second = cache.solve(want.free_after, *node, batch, None, want.ok_global, device=cuda)
    direct2 = pc.solve_batch(want.free_after.clone(), *node, batch, None,
                             want.ok_global.clone(), device=cuda)
    for a, b in zip(second, direct2):
        assert torch.equal(a, b)
    assert (cache.lowerings, cache.hits) == (1, 2)


@pytest.mark.gpu
def test_replays_count_as_launches(cuda):
    from grove_tpu_torch.kernels.place_wave import place_wave, reset_launches

    _, (gangs, pods, snap) = build_pair("bench_small")
    wp = pw.WarmPath()
    p_drain(gangs, pods, snap, wave_size=4, warm_path=wp)
    reset_launches()
    _, stats = p_drain(gangs, pods, snap, wave_size=4, warm_path=wp)
    assert stats.lowerings == 0
    assert place_wave.variant_launches["dense"] == stats.waves == place_wave.launches
