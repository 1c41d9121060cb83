"""The node-sharded solve (parallel/mesh.py SolveLayout, kernel B7's plain
version) against the JAX package's on the suite's 8 virtual CPU devices
(tests/conftest.py); the port runs on 8 virtual devices of the CPU
(`force_virtual_devices`). Inputs come from the JAX tests' own scenarios
(tests/test_mesh.py) and numpy seeds.

  - negotiation: solve_layout_for over device counts 1-8 (prime counts,
    minNodes, maxDevices), the fallback counts (repeated resolves of a
    MeshConfig at 1-8 devices), resolve_layout, fingerprint,
    layout_from_fingerprint and the layout's row spans, all equal to the
    JAX package's decisions;
  - solves: the port's sharded solve at S = 2, 4, 8, dense and pruned,
    exactly equal to JAX `sharded_solve_fn` on the same k (ok, assigned,
    placement_score, free_after, ok_global) and to the port's unsharded
    solve, on the synthetic, contended, quality and mixed scenarios;
  - the kernel source: its sharded instantiation built for the host (the
    shards as threads meeting at the barriers) equals the plain version;
  - drains: chained, wave and pipeline (and pipelined pruned) under a
    layout, bindings, free_after and shard_devices equal to JAX's; the
    scan disciplines under a layout raise;
  - the stream's mesh rung: a chaos run whose faults step the mesh down
    and back up (strip_layout / adopt_layout) equals JAX's;
  - the controller's journal under a mesh equals JAX's, fingerprint
    included, and replays;
  - replay: a JAX journal recorded under a 4-device mesh replays with 0
    divergences, the layout rebuilt and unsharded;
  - cache keying: sharded and unsharded entries are distinct, a second
    sharded solve adds none, prewarm rebuilds a sharded entry.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from grove_tpu.orchestrator import expand_podcliqueset as r_expand
from grove_tpu.parallel import mesh as r_mesh
from grove_tpu.sim import workloads as r_wl
from grove_tpu.solver.core import SolverParams as RParams
from grove_tpu.solver.core import solve as r_solve
from grove_tpu.solver.drain import drain_backlog as r_drain
from grove_tpu.solver.encode import encode_gangs as r_encode
from grove_tpu.solver.pruning import PruningConfig as RPruning
from grove_tpu.solver.warm import WarmPath as RWarm
from grove_tpu.state import build_snapshot as r_snapshot
from grove_tpu_torch.kernels import build
from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.orchestrator import expand_podcliqueset as p_expand
from grove_tpu_torch.parallel import mesh as p_mesh
from grove_tpu_torch.sim import workloads as p_wl
from grove_tpu_torch.solver import core as core_mod
from grove_tpu_torch.solver.core import SolverParams, batch_to, sharded_solve_fn
from grove_tpu_torch.solver.core import solve as p_solve
from grove_tpu_torch.solver.drain import drain_backlog as p_drain
from grove_tpu_torch.solver.encode import encode_gangs as p_encode
from grove_tpu_torch.solver.pruning import PruningConfig as PPruning
from grove_tpu_torch.solver.reference import sharded_solve_ref
from grove_tpu_torch.solver.warm import WarmPath as PWarm
from grove_tpu_torch.state import build_snapshot as p_snapshot
from torch_jax_programs import _release_jax_programs  # noqa: F401

PRUNED = dict(enabled=True, max_candidates=120, min_fleet=16, min_pad=8)
FIELDS = ("assigned", "ok", "placement_score", "free_after", "ok_global")


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


@pytest.fixture(autouse=True)
def virtual8():
    """8 virtual devices of the CPU for the port, as the suite gives JAX 8
    virtual CPU devices; the real device list again after each test."""
    assert len(jax.devices()) == 8
    p_mesh.force_virtual_devices(8, "cpu")
    yield p_mesh.mesh_devices()
    p_mesh.force_virtual_devices(0)


def expand(exp, topo, backlog):
    gangs, pods = [], {}
    for pcs in backlog:
        ds = exp(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    return gangs, pods


def world(pkg: str, name: str):
    """(gangs, pods, snapshot) of one of tests/test_mesh.py's scenarios in
    one package: synthetic (its drain problem, 160 nodes), contended (256
    nodes, 24 gangs), quality (quality_cluster + mixed_backlog, 32 nodes)
    and mixed (mixed_backlog on the synthetic fleet)."""
    wl, exp, snap_of = (r_wl, r_expand, r_snapshot) if pkg == "jax" else \
        (p_wl, p_expand, p_snapshot)
    topo = wl.bench_topology()
    synthetic = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=4)
    bound = None
    if name == "synthetic":
        nodes, backlog = synthetic, wl.synthetic_backlog(n_disagg=14, n_agg=10, n_frontend=10)
    elif name == "contended":
        (nodes, bound), backlog = wl.contended_cluster(), wl.contended_backlog(n_gangs=24)
    elif name == "quality":
        nodes, backlog = wl.quality_cluster(), wl.mixed_backlog()
    else:
        nodes, backlog = synthetic, wl.mixed_backlog()
    gangs, pods = expand(exp, topo, backlog)
    snap = snap_of(nodes, topo, bound_pods=bound) if bound else snap_of(nodes, topo)
    return gangs, pods, snap


def both(name):
    out = {}
    for pkg, enc in (("jax", r_encode), ("port", p_encode)):
        gangs, pods, snap = world(pkg, name)
        batch, _ = enc(gangs, pods, snap,
                       global_index_of={g.name: i for i, g in enumerate(gangs)})
        out[pkg] = (gangs, pods, snap, batch)
    return out


def arrays(result) -> dict:
    return {f: None if getattr(result, f) is None else np.asarray(
        getattr(result, f).cpu() if torch.is_tensor(getattr(result, f)) else getattr(result, f))
        for f in FIELDS}


def assert_same(got: dict, want: dict, label: str):
    for f in FIELDS:
        assert (got[f] is None) == (want[f] is None), (label, f)
        if want[f] is not None:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label}: {f}")


# ---- negotiation ---------------------------------------------------------------


def _decision(mod, fn, *args, **kw):
    """(the layout's node axis or None, the fallback ledger's move)."""
    before = mod.shard_fallbacks()
    layout = fn(*args, **kw)
    return (None if layout is None else layout.node_devices), mod.shard_fallbacks() - before


@pytest.mark.parametrize("nd", range(1, 9))
def test_solve_layout_for_equal_jax_over_device_counts(nd, virtual8):
    jd = jax.devices()[:nd]
    pd = virtual8[:nd]
    cases = [dict(n=n) for n in (1024, 160, 12, 13, 30, 7, 64, 9)]
    cases += [dict(n=1024, max_devices=4), dict(n=64, min_nodes=512), dict(n=13, min_nodes=8),
              dict(n=13, count_fallback=False), dict(n=1024, max_devices=3)]
    for c in cases:
        kw = {k: v for k, v in c.items() if k != "n"}
        want = _decision(r_mesh, r_mesh.solve_layout_for, c["n"], jd, **kw)
        got = _decision(p_mesh, p_mesh.solve_layout_for, c["n"], pd, **kw)
        assert got == want, (nd, c)


@pytest.mark.parametrize("nd", [1, 2, 3, 5, 7, 8])
def test_resolve_fallback_counts_equal_jax(nd):
    """The ledger's move at each of three resolves of one MeshConfig per
    (axis, minNodes), on nd devices: the JAX package on its first nd (the
    config's maxDevices), the port on nd virtual devices (one device: the
    CPU itself). Both count once per memoized (config, axis), never on
    one device."""
    if nd == 1:
        p_mesh.force_virtual_devices(0)
    else:
        p_mesh.force_virtual_devices(nd, "cpu")
    assert len(p_mesh.mesh_devices()) == nd
    with r_mesh._LAYOUT_MEMO_LOCK:
        r_mesh._LAYOUT_MEMO.clear()
    for n, min_nodes in ((1024, 64), (160, 64), (13, 0), (7, 0), (30, 0), (64, 512),
                         (1024, 2048), (105, 8)):
        rcfg = r_mesh.MeshConfig(enabled=True, min_nodes=min_nodes, max_devices=nd)
        pcfg = p_mesh.MeshConfig(enabled=True, min_nodes=min_nodes)
        for i in range(3):
            want = _decision(r_mesh, r_mesh.resolve_layout, rcfg, n)
            got = _decision(p_mesh, p_mesh.resolve_layout, pcfg, n)
            assert got == want, (nd, n, min_nodes, i)
    assert _decision(p_mesh, p_mesh.resolve_layout,
                     p_mesh.MeshConfig(enabled=False), 13) == (None, 0)


def test_resolve_layout_fingerprint_and_rebuild_equal_jax():
    for cfg in (dict(enabled=False), dict(enabled=True, min_nodes=64),
                dict(enabled=True, min_nodes=64, max_devices=4), dict(enabled=True, max_devices=6)):
        for n in (1024, 160, 96, 13):
            want = r_mesh.resolve_layout(r_mesh.MeshConfig(**cfg), n)
            got = p_mesh.resolve_layout(p_mesh.MeshConfig(**cfg), n)
            assert (None if got is None else got.fingerprint()) == \
                (None if want is None else want.fingerprint()), (cfg, n)
    layout = p_mesh.solve_layout_for(1024)
    assert p_mesh.resolve_layout(layout, 1024) is layout
    with pytest.raises(TypeError):
        p_mesh.resolve_layout(object(), 1024)
    for fp, n in (({"portfolio": 1, "node": 8}, 1024), ({"portfolio": 1, "node": 16}, 1024),
                  ({"portfolio": 1, "node": 8}, 1023), (None, 1024),
                  ({"portfolio": 1, "node": 1}, 1024), ({"portfolio": 1, "node": 4}, 160)):
        want = r_mesh.layout_from_fingerprint(fp, n)
        got = p_mesh.layout_from_fingerprint(fp, n)
        assert (None if got is None else got.fingerprint()) == \
            (None if want is None else want.fingerprint()), (fp, n)
    rebuilt = p_mesh.layout_from_fingerprint(layout.fingerprint(), 1024)
    assert rebuilt.key() == layout.key()
    for k, pad in ((1, 64), (8, 64), (3, 64), (8, 4), (8, 9)):
        assert p_mesh.mesh_divisible_pad(pad, k) == r_mesh.mesh_divisible_pad(pad, k)


def test_one_device_resolves_no_layout_and_a_real_layout_keys_apart():
    """One device (no virtual devices): no layout and no counted fallback,
    the JAX package's decision on one device; a layout over real devices
    never shares a key with a virtual one, and its launch needs one
    device."""
    p_mesh.force_virtual_devices(0)
    assert len(p_mesh.mesh_devices()) == 1
    before = p_mesh.shard_fallbacks()
    assert p_mesh.resolve_layout(p_mesh.MeshConfig(enabled=True, min_nodes=8), 1024) is None
    assert p_mesh.shard_fallbacks() == before
    virtual = p_mesh.solve_layout_for(1024, p_mesh.force_virtual_devices(2, "cpu"))
    real = p_mesh.SolveLayout(p_mesh.Mesh(((p_mesh.MeshDevice(torch.device("cpu"), 0),
                                            p_mesh.MeshDevice(torch.device("cpu"), 1)),)))
    assert virtual.fingerprint() == real.fingerprint() and virtual.key() != real.key()
    cards = p_mesh.SolveLayout(p_mesh.Mesh(((p_mesh.MeshDevice(torch.device("cuda", 0), 0),
                                             p_mesh.MeshDevice(torch.device("cuda", 1), 1)),)))
    with pytest.raises(NotImplementedError, match="distinct cards"):
        cards.device  # noqa: B018


def test_layout_spans_args_and_row_ops_equal_jax(virtual8):
    """SolveLayout's row spans against the JAX layout's shards of every
    solver argument (`shard_solve_args`), and the pruned gather/scatter the
    port runs over those spans (sharded_solve_ref's, kernel B7's inside its
    launch) against the JAX layout's row ops."""
    from grove_tpu_torch.solver.reference import gather_free_ref, scatter_free_ref

    (_, _, rs, rb), (_, _, ps, pb) = both("synthetic").values()
    n = int(ps.free.shape[0])
    rl, pl = jax_layout(4, n), p_mesh.solve_layout_for(n, virtual8[:4])
    spans = pl.spans(n)
    assert pl.fingerprint() == rl.fingerprint() and spans == [(0, 40), (40, 80), (80, 120),
                                                              (120, 160)]

    def jax_spans(x, axis):
        return sorted({(s.index[axis].start or 0, s.index[axis].stop or x.shape[axis])
                       for s in x.addressable_shards})

    free, cap, sched, ndid, batch, okg = rl.shard_solve_args(
        rs.free, rs.capacity, rs.schedulable, rs.node_domain_id, rb, np.zeros(3, bool))
    for x, axis in ((free, 0), (cap, 0), (sched, 0), (ndid, 1)):
        assert jax_spans(x, axis) == spans
    for name in ("reuse_nodes", "spread_avoid", "group_node_ok"):
        x = getattr(batch, name)
        if x is not None:
            assert jax_spans(x, x.ndim - 1) == spans, name
    rng = np.random.default_rng(11)
    idx = np.concatenate([rng.choice(n, 37, replace=False), np.full(11, n + 5)]).astype(np.int32)
    fleet = torch.as_tensor(ps.free, dtype=torch.float32)
    tidx = torch.as_tensor(idx)
    pad = pl.spans(idx.shape[0])
    rows = torch.cat([gather_free_ref(fleet, tidx[lo:hi]) for lo, hi in pad])
    want = np.asarray(rl.gather_rows(jax.numpy.asarray(ps.free, jax.numpy.float32), idx))
    np.testing.assert_array_equal(rows.numpy(), want)
    back = fleet
    for lo, hi in pad:
        back = scatter_free_ref(back, rows[lo:hi] + 1.0, tidx[lo:hi])
    np.testing.assert_array_equal(back.numpy(), np.asarray(rl.scatter_rows(
        jax.numpy.asarray(ps.free, jax.numpy.float32), idx, jax.numpy.asarray(want + 1.0))))


# ---- solves ----------------------------------------------------------------------


def jax_layout(k, n):
    layout = r_mesh.solve_layout_for(n, jax.devices()[:k])
    assert layout is not None and layout.node_devices == k
    return layout


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["synthetic", "contended", "quality", "mixed"])
def test_sharded_solve_equals_jax_and_unsharded(name, shards, virtual8):
    w = both(name)
    (rg, _, rs, rb), (pg, _, ps, pb) = w["jax"], w["port"]
    n = int(rs.free.shape[0])
    okg = np.zeros(len(rg), bool)
    want = arrays(r_solve(rs, rb, RParams(), ok_global=okg, mesh=jax_layout(shards, n)))
    layout = p_mesh.solve_layout_for(n, virtual8[:shards])
    core_mod._SHARDED_FN.clear()
    got = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=PWarm(), mesh=layout))
    assert list(core_mod._SHARDED_FN) == [(False, layout.key())]
    base = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=PWarm()))
    assert_same(got, want, f"{name} S={shards} vs JAX")
    assert_same(got, base, f"{name} S={shards} vs unsharded")
    # sharded_solve_fn, the memoized entry the launch cache solved through,
    # called without the cache.
    fn = sharded_solve_fn(layout)
    assert sharded_solve_fn(layout) is fn
    node = [torch.as_tensor(np.asarray(x)) for x in (ps.free, ps.capacity, ps.schedulable,
                                                     ps.node_domain_id)]
    direct = fn(node[0].float(), *node[1:], pb, SolverParams(), torch.as_tensor(okg),
                device="cpu")
    assert torch.equal(node[0].float(), torch.as_tensor(ps.free, dtype=torch.float32))
    assert_same(arrays(direct), want, f"{name} S={shards} sharded_solve_fn vs JAX")


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_pruned_solve_equals_jax_and_unsharded(shards, virtual8):
    w = both("synthetic")
    (rg, _, rs, rb), (pg, _, ps, pb) = w["jax"], w["port"]
    n = int(rs.free.shape[0])
    okg = np.zeros(len(rg), bool)
    want = arrays(r_solve(rs, rb, RParams(), ok_global=okg, pruning=RPruning(**PRUNED),
                          mesh=jax_layout(shards, n)))
    wp = PWarm()
    got = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=wp,
                         pruning=PPruning(**PRUNED),
                         mesh=p_mesh.solve_layout_for(n, virtual8[:shards])))
    assert wp.prune.pruned_solves == 1 and wp.prune.last_candidate_pad % shards == 0
    base = arrays(p_solve(ps, pb, ok_global=okg, device="cpu", warm=PWarm(),
                          pruning=PPruning(**PRUNED), mesh_axis=shards))
    assert_same(got, want, f"pruned S={shards} vs JAX")
    assert_same(got, base, f"pruned S={shards} vs unsharded")


def test_portfolio_under_a_layout_waits():
    _, _, ps, pb = both("quality")["port"]
    layout = p_mesh.solve_layout_for(int(ps.free.shape[0]))
    with pytest.raises(NotImplementedError, match="portfolio mesh"):
        p_solve(ps, pb, portfolio=4, device="cpu", warm=PWarm(), mesh=layout)


# ---- the kernel source on the host -----------------------------------------------

_SHARD_SHIM = r"""
#include <cmath>
#include <cstdint>
#define PLACE_WAVE_HOST_EMULATION 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(n) alignas(n)
struct Dim3 { unsigned x; };
static Dim3 threadIdx = {0}, blockDim = {1};
static inline void __syncthreads() {}
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static long long clock64() { return 0; }
using std::isinf;
thread_local float pw_plane[1 << 16];
#include "place_wave.cu"
"""


@pytest.fixture(scope="module")
def host_sharded(tmp_path_factory):
    """The kernel source built for the host with each shard a thread (its
    walk plane thread-local); returns its sharded launch."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for emulation")
    d = tmp_path_factory.mktemp("place_wave_shards")
    (d / "shim.cpp").write_text(_SHARD_SHIM)
    lib = d / "libplace_wave_shards.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{build.CSRC}", "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    assert so.place_wave_args_size() == ctypes.sizeof(pwm.PlaceWaveArgs)
    fn = so.place_wave_sharded_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _emulated_vs_plain(launch, snap, batch, shards, plan=None, plane_words=None):
    tb = batch_to(batch if plan is None else plan.gather_batch(batch), "cpu")
    free = torch.as_tensor(snap.free, dtype=torch.float32)
    okg = torch.zeros(batch.gang_valid.shape[0] * 2, dtype=torch.bool)
    if plan is None:
        rest = tuple(torch.as_tensor(np.asarray(x)) for x in (snap.capacity, snap.schedulable,
                                                              snap.node_domain_id))
        cand = (None, None)
    else:
        pt = plan.tensors("cpu")
        rest, cand = (pt.capacity, pt.schedulable, pt.node_domain_id), (pt.cand_idx, plan.count)
    n = rest[0].shape[0]
    spans = [(s * n // shards, (s + 1) * n // shards) for s in range(shards)]
    want = sharded_solve_ref(free.clone(), *rest, tb, SolverParams(), okg.clone(), spans, *cand)
    got_free, got_okg = free.clone(), okg.clone()
    args, smem, out, _keep = pwm.build_args(
        got_free, *rest, tb, SolverParams(), got_okg,
        pwm.domain_index_sharded(rest[2], shards, "cpu"), *cand, plane_words=plane_words,
        shards=shards)
    assert launch(ctypes.byref(args), None, smem) == 0
    got = (out["assigned"][0], out["ok"][0], out["score"][0], got_free, got_okg)
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f"{name}: emulated B7 != plain at {torch.nonzero(a != b)[:8]}"
    return want


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["synthetic", "contended", "quality", "spread"])
def test_kernel_source_sharded_on_host_equals_plain(host_sharded, name, shards):
    if name == "spread":
        from test_torch_host import PORT, SCENARIOS

        gangs, pods, snap = SCENARIOS["uniform"](PORT)
        gidx = {g.name: i for i, g in enumerate(gangs)}
        batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
        rng = np.random.default_rng(3)
        g, n = batch.gang_valid.shape[0], snap.capacity.shape[0]
        batch = batch._replace(spread_level=np.full(g, 1, np.int32),
                               spread_family=(np.arange(g) % 3).astype(np.int32),
                               spread_avoid=rng.random((g, n)) < 0.1,
                               reuse_nodes=rng.random((g, n)) < 0.1)
    else:
        gangs, _, snap, batch = both(name)["port"]
    want = _emulated_vs_plain(host_sharded, snap, batch, shards, plane_words=64)
    assert bool(want[1].any())


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_kernel_source_sharded_pruned_on_host_equals_plain(host_sharded, shards):
    from grove_tpu_torch.solver.pruning import plan_candidates

    gangs, _, snap, batch = both("synthetic")["port"]
    plan = plan_candidates(snap, batch, PPruning(**PRUNED), mesh_axis=shards)
    assert plan is not None and plan.pad % shards == 0
    _emulated_vs_plain(host_sharded, snap, batch, shards, plan=plan)


# ---- drains ----------------------------------------------------------------------


def drain_world(pkg):
    gangs, pods, snap = world(pkg, "synthetic")
    return gangs, pods, snap


@pytest.mark.parametrize("harvest,pruned", [("chained", False), ("wave", False),
                                            ("pipeline", False), ("pipeline", True)])
def test_sharded_drains_equal_jax(harvest, pruned):
    """The pruned drain runs pipelined, as tests/test_mesh.py runs it."""
    rg, rp, rs = drain_world("jax")
    pg, pp, ps = drain_world("port")
    rkw = {"pruning": RPruning(**PRUNED)} if pruned else {}
    pkw = {"pruning": PPruning(**PRUNED)} if pruned else {}
    want, rstats = r_drain(rg, rp, rs, wave_size=16, warm_path=RWarm(), harvest=harvest,
                           mesh=r_mesh.MeshConfig(enabled=True, min_nodes=64), **rkw)
    got, pstats = p_drain(pg, pp, ps, wave_size=16, warm_path=PWarm(), harvest=harvest,
                          device="cpu", mesh=p_mesh.MeshConfig(enabled=True, min_nodes=64), **pkw)
    base, bstats = p_drain(pg, pp, ps, wave_size=16, warm_path=PWarm(), harvest=harvest,
                           device="cpu", **pkw)
    assert got == want == base
    assert pstats.shard_devices == rstats.shard_devices == 8
    assert pstats.shard_fallbacks == rstats.shard_fallbacks == 0
    assert (pstats.pruned_waves, pstats.candidate_pad) == (rstats.pruned_waves,
                                                           rstats.candidate_pad)
    assert np.array_equal(pstats.free_after, bstats.free_after)
    # The carry left equals the snapshot minus every bound pod.
    from grove_tpu_torch.state.cluster import pod_request_vector

    free = ps.free.astype(np.float32)
    for pods in got.values():
        for pod, node in pods.items():
            free[ps.node_index(node)] -= pod_request_vector(pp[pod], ps.resource_names)
    assert np.array_equal(pstats.free_after, free)


def test_sharded_drain_fallback_counted_and_scan_waits():
    pg, pp, ps = drain_world("port")
    before = p_mesh.shard_fallbacks()
    _, stats = p_drain(pg, pp, ps, wave_size=16, warm_path=PWarm(), device="cpu",
                       mesh=p_mesh.MeshConfig(enabled=True, min_nodes=1 << 20))
    assert (stats.shard_devices, stats.shard_fallbacks) == (0, 1)
    assert p_mesh.shard_fallbacks() == before + 1
    for harvest in ("scan", "resident"):
        with pytest.raises(NotImplementedError, match="scan and resident"):
            p_drain(pg, pp, ps, wave_size=16, warm_path=PWarm(), device="cpu", harvest=harvest,
                    mesh=p_mesh.MeshConfig(enabled=True, min_nodes=64))


# ---- the stream's mesh rung ----------------------------------------------------


def test_stream_mesh_rung_steps_down_and_up_as_jax():
    """A pipelined stream under a mesh whose dispatch faults charge the mesh
    rung: the ladder strips the layout and adopts it again after probation;
    bindings, counters, ladder transitions and each journaled wave's mesh
    fingerprint equal the JAX run's (one step clock each)."""
    import itertools

    from grove_tpu import faults as r_faults
    from grove_tpu.solver import resilience as r_res
    from grove_tpu.solver.stream import StreamConfig as RStream
    from grove_tpu.solver.stream import drain_stream as r_stream
    from grove_tpu_torch import faults as p_faults
    from grove_tpu_torch.solver import resilience as p_res
    from grove_tpu_torch.solver.stream import StreamConfig as PStream
    from grove_tpu_torch.solver.stream import drain_stream as p_stream

    out = {}
    try:
        for pkg, wl, snap_of, faults, res, cfg, stream, mesh, warm, kw in (
                ("jax", r_wl, r_snapshot, r_faults, r_res, RStream, r_stream, r_mesh, RWarm, {}),
                ("port", p_wl, p_snapshot, p_faults, p_res, PStream, p_stream, p_mesh, PWarm,
                 {"device": "cpu"})):
            topo = wl.bench_topology()
            nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=2,
                                         hosts_per_rack=6)
            arrivals, pods = wl.expand_arrivals(wl.arrival_process(20260804, duration_s=6.0,
                                                                   base_rate=4.0))
            snap = snap_of(nodes, topo)
            c = itertools.count(1)
            lad = res.DegradationLadder(res.ResilienceConfig(
                enabled=True, max_wave_retries=1, breaker_threshold=2,
                breaker_window_seconds=300.0, probation_seconds=0.01),
                clock=lambda: next(c) * 0.001)
            inj = faults.FaultInjector({"solver.dispatch": faults.SiteSpec(
                kind="error", rate=1.0, count=4, after=1)}, seed=20260804)
            base, _ = stream(arrivals, pods, snap, config=cfg(depth=2, wave_size=16),
                             warm_path=warm(), **kw)
            got, stats = stream(arrivals, pods, snap, config=cfg(depth=2, wave_size=16),
                                warm_path=warm(), faults=inj, resilience=lad,
                                mesh=mesh.MeshConfig(enabled=True, min_nodes=8), **kw)
            assert got == base
            out[pkg] = dict(bindings=got, res=stats.drain.resilience_doc(), ladder=lad.stats(),
                            counters=lad.counters(), shard=stats.drain.shard_devices,
                            fallbacks=stats.drain.shard_fallbacks,
                            doc=stats.to_doc()["shardDevices"])
    finally:
        r_faults.install(None)
        p_faults.install(None)
    assert out["port"]["counters"]["mesh"]["stepDowns"] >= 1
    assert out["port"]["counters"]["mesh"]["stepUps"] >= 1
    assert out["port"] == out["jax"]


def test_stream_under_a_mesh_equals_jax():
    from grove_tpu.solver.stream import StreamConfig as RStream
    from grove_tpu.solver.stream import drain_stream as r_stream
    from grove_tpu_torch.solver.stream import StreamConfig as PStream
    from grove_tpu_torch.solver.stream import drain_stream as p_stream

    out = {}
    for pkg, wl, snap_of, cfg, stream, mesh, warm, kw in (
            ("jax", r_wl, r_snapshot, RStream, r_stream, r_mesh, RWarm, {}),
            ("port", p_wl, p_snapshot, PStream, p_stream, p_mesh, PWarm, {"device": "cpu"})):
        nodes = wl.synthetic_cluster(zones=1, blocks_per_zone=2, racks_per_block=4)
        snap = snap_of(nodes, wl.bench_topology())
        arrivals, pods = wl.expand_arrivals(wl.arrival_process(7, duration_s=6.0, base_rate=6.0),
                                            wl.bench_topology())
        got, stats = stream(arrivals, pods, snap, config=cfg(depth=2, wave_size=16),
                            warm_path=warm(), pipeline=True,
                            mesh=mesh.MeshConfig(enabled=True, min_nodes=64), **kw)
        out[pkg] = (got, stats.drain.shard_devices, stats.to_doc()["shardDevices"])
    assert out["port"] == out["jax"]
    assert out["port"][1] == 8


# ---- the controller's journal --------------------------------------------------


def test_controller_journal_under_a_mesh_equals_jax_and_replays(tmp_path):
    from test_torch_controller import TwinScenario, normalize_journal
    from scenario_harness import wl2

    from grove_tpu_torch.trace.replay import replay_journal

    s = TwinScenario(16)
    s.ref.controller.mesh_cfg = r_mesh.MeshConfig(enabled=True, min_nodes=8)
    s.port.controller.mesh_cfg = p_mesh.MeshConfig(enabled=True, min_nodes=8)
    s.record(tmp_path)
    s.deploy(wl2())
    assert s.until_ready(10)
    r_records, p_records = s.journals()
    waves = [r for r in p_records if r.get("kind") == "wave"]
    assert waves and all(w["solver"]["mesh"] == {"portfolio": 1, "node": 8} for w in waves)
    assert normalize_journal(p_records) == normalize_journal(r_records)
    assert s.port.controller.last_shard_devices == 8
    for records in (p_records, r_records):
        assert replay_journal(records, device="cpu").divergence_count == 0


# ---- replay --------------------------------------------------------------------


def test_jax_journal_recorded_under_4_devices_replays_rebuilt_and_unsharded(tmp_path):
    from grove_tpu.trace.recorder import TraceRecorder, read_journal

    from grove_tpu_torch.trace.replay import replay_journal

    rg, rp, rs = drain_world("jax")
    rec = TraceRecorder(str(tmp_path / "j"))
    rec.start()
    try:
        _, stats = r_drain(rg, rp, rs, wave_size=16, warm_path=RWarm(), harvest="pipeline",
                           pruning=RPruning(**PRUNED), recorder=rec,
                           mesh=r_mesh.MeshConfig(enabled=True, min_nodes=64, max_devices=4))
    finally:
        rec.stop()
    assert stats.shard_devices == 4 and stats.pruned_waves > 0
    records = read_journal(str(tmp_path / "j"))
    assert all(w["solver"]["mesh"] == {"portfolio": 1, "node": 4}
               for w in records if w.get("kind") == "wave")
    wp = PWarm()
    assert replay_journal(records, warm_path=wp, device="cpu").divergence_count == 0
    keys = list(wp.executables._entries)
    assert keys and all(k[4] is not None and k[4][1] == 4 for k in keys)  # rebuilt: sharded
    p_mesh.force_virtual_devices(0)
    wp = PWarm()
    assert replay_journal(records, warm_path=wp, device="cpu").divergence_count == 0
    assert all(k[4] is None for k in wp.executables._entries)  # unsharded


# ---- cache keying --------------------------------------------------------------


def test_sharded_entries_key_apart_and_warm_once(tmp_path):
    _, _, ps, pb = both("quality")["port"]
    n = int(ps.free.shape[0])
    wp = PWarm()
    p_solve(ps, pb, device="cpu", warm=wp)
    dense = wp.executables.lowerings
    layout = p_mesh.solve_layout_for(n)
    p_solve(ps, pb, device="cpu", warm=wp, mesh=layout)
    assert wp.executables.lowerings == dense + 1
    p_solve(ps, pb, device="cpu", warm=wp, mesh=layout)
    assert wp.executables.lowerings == dense + 1
    p_solve(ps, pb, device="cpu", warm=wp,
            mesh=p_mesh.solve_layout_for(n, p_mesh.mesh_devices()[:4]))
    assert wp.executables.lowerings == dense + 2
    # The shape history records the mesh; a fresh cache prewarms the
    # sharded entry, and the live sharded solve then prepares nothing.
    history = str(tmp_path / "shapes.json")
    wp1 = PWarm()
    wp1.executables.history_path = history
    p_solve(ps, pb, device="cpu", warm=wp1, mesh=layout)
    wp2 = PWarm()
    wp2.executables.history_path = history
    assert wp2.executables.prewarm_from_history(top_k=4, device="cpu") >= 1
    before = wp2.executables.lowerings
    p_solve(ps, pb, device="cpu", warm=wp2, mesh=layout)
    assert wp2.executables.lowerings == before
