"""The port's drain through its warm path against the JAX drain through
JAX's (plain versions, device="cpu"), every harvest discipline, dense and
pruned, each drained cold and then warm through one WarmPath per package:

  - bindings (order included) equal the JAX drain's, cold and warm;
  - exec_cache_hits, exec_cache_misses, lowerings, encode_reuse_hits,
    encode_reuse_misses and donated equal JAX's DrainStats, and the warm
    drain prepares nothing and reuses every row;
  - WarmPath.stats() carries JAX's keys;
  - scan chunks are padded to a power of two with null waves as JAX pads
    them: the chunk lengths each scan launch receives, and the lengths the
    warm pre-pass prepares for the full-width bench backlog at wave sizes
    32 and 256, equal JAX's.

Sizes are tests/test_torch_scan.py's (every cold JAX drain pays XLA
compiles on the CPU).
"""

from __future__ import annotations

import numpy as np
import pytest

from grove_tpu.solver import pruning as rp
from grove_tpu.solver import warm as rw
from grove_tpu.solver.drain import DrainStats as RDrainStats
from grove_tpu.solver.drain import ScanConfig as RScanConfig
from grove_tpu.solver.drain import _WavePipeline as RPipeline
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.drain import plan_waves as r_plan
from grove_tpu.solver.core import SolverParams as RParams
from grove_tpu_torch.solver import pruning as pp
from grove_tpu_torch.solver import warm as pw
from grove_tpu_torch.solver.core import SolverParams as PParams
from grove_tpu_torch.solver.drain import HARVEST_MODES, DrainStats, ScanConfig
from grove_tpu_torch.solver.drain import _WavePipeline as PPipeline
from grove_tpu_torch.solver.drain import class_runs
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.drain import plan_waves as p_plan
from test_torch_host import PORT, REF, _bench
from test_torch_scan import adopt_fleet, bench_small
from torch_jax_programs import _release_jax_programs  # noqa: F401

WARM = ("exec_cache_hits", "exec_cache_misses", "lowerings", "encode_reuse_hits",
        "encode_reuse_misses", "donated")
CASES = {
    "dense": (bench_small, 4, None),
    "pruned": (adopt_fleet, 8, dict(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)),
}


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


def _spy_scan_lengths(monkeypatch, cls, name, into):
    """Record the leading (wave) axis of every chunk a cache's scan method
    receives."""
    orig = getattr(cls, name)

    def spy(self, *args, **kwargs):
        batch = args[5] if name == "solve_scan_pruned" else args[4]
        into.append(int(np.shape(batch.gang_valid)[0]))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(cls, name, spy)


@pytest.mark.parametrize("mode", HARVEST_MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cold_then_warm_drain_equals_jax(monkeypatch, case, mode):
    build, wave_size, cfg = CASES[case]
    rg, rpods, rs = build(REF)
    pg, ppods, ps = build(PORT)
    rkw = {} if cfg is None else {"pruning": rp.PruningConfig(**cfg)}
    pkw = {} if cfg is None else {"pruning": pp.PruningConfig(**cfg)}
    rlens, plens = [], []
    for cls, into in ((rw.ExecutableCache, rlens), (pw.ExecutableCache, plens)):
        for name in ("solve_scan", "solve_scan_pruned"):
            _spy_scan_lengths(monkeypatch, cls, name, into)
    rwp, pwp = rw.WarmPath(), pw.WarmPath()
    stats = []
    for _ in range(2):
        rb, rstats = r_drain(rg, rpods, rs, wave_size=wave_size, harvest=mode, warm_path=rwp,
                             **rkw)
        pb, pstats = p_drain(pg, ppods, ps, wave_size=wave_size, harvest=mode, warm_path=pwp,
                             device="cpu", **pkw)
        assert pb == rb and list(pb) == list(rb)
        for f in WARM:
            assert getattr(pstats, f) == getattr(rstats, f), f
        stats.append(pstats)
    cold, warm = stats
    np.testing.assert_array_equal(cold.free_after, warm.free_after)
    assert cold.lowerings == cold.exec_cache_misses > 0
    assert warm.lowerings == warm.exec_cache_misses == 0
    assert warm.encode_reuse_hits == len(pg) and warm.encode_reuse_misses == 0
    assert cold.encode_reuse_misses == len(pg)
    assert warm.compile_s >= 0 and cold.donated is False  # the CPU does not donate
    assert plens == rlens
    if mode in ("scan", "resident"):
        assert plens and all(n & (n - 1) == 0 for n in plens)
    assert set(rwp.stats()) <= set(pwp.stats())
    assert pwp.last_drain["drainWaves"] == warm.waves


def test_donate_on_the_card_default_and_its_key():
    """donation_default follows the device; donate=True drains a dense
    backlog with its own keys (JAX's counts), a pruned drain never donates."""
    assert pw.donation_default("cpu") is False and pw.donation_default("cuda") is True
    rg, rpods, rs = bench_small(REF)
    pg, ppods, ps = bench_small(PORT)
    rwp, pwp = rw.WarmPath(), pw.WarmPath()
    for donate in (False, True):
        _, rstats = r_drain(rg, rpods, rs, wave_size=16, warm_path=rwp, donate=donate)
        _, pstats = p_drain(pg, ppods, ps, wave_size=16, warm_path=pwp, device="cpu",
                            donate=donate)
        for f in WARM:
            assert getattr(pstats, f) == getattr(rstats, f), f
    assert pstats.donated is True and pstats.lowerings > 0
    cfg = CASES["pruned"][2]
    _, pstats = p_drain(*adopt_fleet(PORT), wave_size=8, device="cpu", donate=True,
                        warm_path=pw.WarmPath(), pruning=pp.PruningConfig(**cfg))
    assert pstats.donated is False


class _Recorder:
    """An executables stand-in for the warm pre-pass: records the scan
    lengths it is asked to prepare."""

    def __init__(self):
        self.lengths = []

    def ensure_compiled_scan(self, *args, **kwargs):
        avals = args[0] if len(args) == 1 else None
        if avals is not None:  # JAX: the stacked avals
            self.lengths.append(int(avals[4].gang_valid.shape[0]))
        else:  # the port: one wave's arrays and the length
            self.lengths.append(int(args[7]))
        return True


@pytest.mark.parametrize("wave_size", [32, 256])
def test_full_bench_scan_lengths_equal_jax(wave_size):
    """The bench backlog at full width (5120 nodes, 1250 gangs): per run of
    same-shape waves, the padded chunk lengths the warm pre-pass prepares
    equal JAX's warm_scan's."""
    (rg, rpods, rs), (pg, ppods, ps) = _bench(REF, racks_per_block=16, n=(350, 250, 300)), \
        _bench(PORT, racks_per_block=16, n=(350, 250, 300))
    rwaves, pwaves = r_plan(rg, wave_size), p_plan(pg, wave_size)
    rwp, pwp = rw.WarmPath(), pw.WarmPath()
    rwp.executables, pwp.executables = _Recorder(), _Recorder()
    r_eng = RPipeline(gangs=rg, pods_by_name=rpods, snapshot=rs, params=RParams(),
                      warm_path=rwp, stats=RDrainStats(), scan=RScanConfig())
    p_eng = PPipeline(gangs=pg, pods_by_name=ppods, snapshot=ps, params=PParams(),
                      stats=DrainStats(), dev=pw.resolve_device("cpu"), warm_path=pwp,
                      scan=ScanConfig())
    rlens, plens = [], []
    for rrun, prun in zip(class_runs(rwaves), class_runs(pwaves)):
        assert len(rrun) == len(prun)
        r_eng.warm_scan(rrun)
        p_eng.warm_scan(prun)
        rlens.append(sorted(rwp.executables.lengths))
        plens.append(sorted(pwp.executables.lengths))
        rwp.executables.lengths.clear()
        pwp.executables.lengths.clear()
    assert plens == rlens
    expect = {32: [[16], [8], [16], [16]], 256: [[2], [], [2], [2]]}[wave_size]
    assert plens == expect
