"""The place_wave CUDA kernel (grove_tpu_torch/kernels) against its plain
PyTorch version.

Tests marked `gpu` need an NVIDIA card: they decide inside the `cuda`
fixture whether one is present and skip with a reason where there is none.
On the card (python -m pytest -m gpu tests/test_torch_kernels.py) they repeat
chip_smoke.py's exactness phase: the kernel and the plain version, both on
the card, must agree exactly (torch.equal) on ok, assigned,
placement_score, free_after and ok_global — for both places the carry can
live (shared or global memory), with the replica-spread planes, and for a
candidate-pruned wave (the B3 gather, scatter and remap inside the launch).
The unmarked tests check the wrapper's host side, and the kernel source
compiled for the host (one-thread emulation), which run anywhere.
"""

from __future__ import annotations

import re

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest
import torch

from grove_tpu_torch.kernels import build
from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.solver.core import SolverParams, batch_to
from grove_tpu_torch.solver.drain import drain_backlog
from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates
from grove_tpu_torch.solver.reference import (
    _domain_sum,
    group_slots_ref,
    solve_batch_ref,
    solve_pruned_ref,
)
from test_torch_host import PORT, SCENARIOS, _bench
from test_torch_solver import pinned_bench_small

FIELDS = ("assigned", "ok", "placement_score", "free_after", "ok_global")
KERNEL_SCENARIOS = sorted(SCENARIOS)
# Budgets below the test fleets, so the candidate bucket beats the fleet axis.
CFG = PruningConfig(enabled=True, max_candidates=60, min_fleet=16, min_pad=8)
CLIPPED = PruningConfig(enabled=True, max_candidates=24, min_fleet=16, min_pad=8)


def _pruning_fleet(P, racks=4, n=(6, 4, 5)):
    """tests/test_pruning.py `_setup`: one zone, one block, `racks` racks."""
    topo = P.wl.bench_topology()
    backlog = P.wl.synthetic_backlog(*n)
    gangs, pods = [], {}
    for pcs in backlog:
        ds = P.expand(pcs, topo)
        gangs.extend(ds.podgangs)
        pods.update({p.name: p for p in ds.pods})
    nodes = P.wl.synthetic_cluster(zones=1, blocks_per_zone=1, racks_per_block=racks)
    return gangs, pods, P.build_snapshot(nodes, topo)


def _half_full(P):
    """tests/test_pruning.py's first fleet: half the nodes full, three
    cordoned, so candidate ordinals differ from fleet ordinals."""
    gangs, pods, snap = _pruning_fleet(P)
    n = snap.capacity.shape[0]
    snap.allocated[: n // 2] = snap.capacity[: n // 2]
    snap.schedulable[n // 2 : n // 2 + 3] = False
    return gangs, pods, snap


def pruned_cases():
    """(label, snapshot, batch, plan): candidate-pruned waves — a plan whose
    candidates skip full and cordoned nodes, a clipped one, one with
    pack-set pins remapped onto the candidate axis, and one carrying the
    replica-spread planes."""
    out = []
    for label, (gangs, pods, snap), cfg in (
        ("half_full", _half_full(PORT), CFG),
        ("clipped", _pruning_fleet(PORT, racks=2, n=(10, 10, 10)), CLIPPED),
        ("spread", SCENARIOS["bench_spread"](PORT), CFG),
    ):
        batch, _ = PORT.encode_gangs(gangs, pods, snap)
        out.append((label, snap, batch, plan_candidates(snap, batch, cfg)))
    _, rs, batch = pinned_bench_small()
    out.append(("pinned", rs, batch, plan_candidates(rs, batch, CFG)))
    for label, _, _, plan in out:
        assert plan is not None, label
    assert out[1][3].clipped
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run `python -m pytest -m gpu "
                    "tests/test_torch_kernels.py` on the card")
    return torch.device("cuda", 0)


def _node_tensors(snap, dev):
    return (
        torch.as_tensor(snap.free, dtype=torch.float32, device=dev),
        torch.as_tensor(snap.capacity, device=dev),
        torch.as_tensor(snap.schedulable, device=dev),
        torch.as_tensor(snap.node_domain_id, device=dev),
    )


def _launch_vs_plain(launch, snap, batch, okg_np, dev, plan=None, shared_carry=None):
    """One wave through `launch(args, smem, shared)` (the kernel, on the card
    or compiled for the host) against the plain version, exactly."""
    okg = torch.as_tensor(okg_np, device=dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    cand = (None, None)
    if plan is not None:
        batch = plan.gather_batch(batch)
        pt = plan.tensors(dev)
        cap, sched, ndid, cand = pt.capacity, pt.schedulable, pt.node_domain_id, (pt.cand_idx, plan.count)
    tb = batch_to(batch, dev)
    okg_k = okg.clone()
    args, smem, shared, out, _keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), okg_k, pwm.domain_index(ndid.cpu(), dev),
        *cand, shared_carry,
    )
    launch(args, smem, shared)
    got = (out["assigned"], out["ok"], out["score"], free, okg_k)
    free0 = _node_tensors(snap, dev)[0]
    if plan is None:
        want = solve_batch_ref(free0, cap, sched, ndid, tb, SolverParams(), okg.clone())
    else:
        want = solve_pruned_ref(free0, cap, sched, ndid, tb, SolverParams(), okg.clone(), *cand)
    if dev != "cpu":
        torch.cuda.synchronize()
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f"{name}: kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    return want


def _card_launch(args, smem, shared):
    import ctypes

    fn = build.load("place_wave").place_wave_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    assert fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream, smem, int(shared)) == 0
    torch.cuda.synchronize()


def _kernel_vs_plain(snap, batch, okg_np, dev):
    """Through the public wrapper: one launch, counted."""
    tb = batch_to(batch, dev)
    okg = torch.as_tensor(okg_np, device=dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    dom = pwm.domain_index(snap.node_domain_id, dev)
    n0 = pwm.place_wave.launches
    got = pwm.place_wave(free, cap, sched, ndid, tb, SolverParams(), okg.clone(), domains=dom)
    assert pwm.place_wave.launches == n0 + 1
    free, cap, sched, ndid = _node_tensors(snap, dev)
    want = solve_batch_ref(free, cap, sched, ndid, tb, SolverParams(), okg.clone())
    torch.cuda.synchronize()
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f"{name}: kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    return want


def _domain_tables_vs_plain(launch, dev):
    """The kernel's hoisted domain tables for one gang of the non-dyadic
    scenario — per level, per domain, the sums of [free, slots per group, 1]
    over schedulable nodes — against the plain version's domain sums."""
    gangs, pods, snap = SCENARIOS["nondyadic"](PORT)
    batch, _ = PORT.encode_gangs(gangs[:1], pods, snap)
    tb = batch_to(batch, dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    n, r = free.shape
    slots = group_slots_ref(free, tb.group_req[0])
    feat = torch.cat([free, slots.T.float(), torch.ones((n, 1), device=dev)], dim=1)
    feat = torch.where(sched[:, None], feat, 0.0)
    seg = torch.where(ndid >= 0, ndid, n).long()
    want = [_domain_sum(feat, seg[lv], n) for lv in range(ndid.shape[0])]
    args, smem, shared, _out, keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), None, pwm.domain_index(snap.node_domain_id, dev)
    )
    launch(args, smem, shared)
    got = keep["tables"].view(ndid.shape[0], n, feat.shape[1])
    for lv, d in enumerate(snap.num_domains.tolist()):
        assert torch.equal(got[lv, :d], want[lv][:d]), f"level {lv}: kernel != plain domain sums"
    return feat, seg, want


# ---- on the card ------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNEL_SCENARIOS)
def test_kernel_equals_plain(cuda, name):
    gangs, pods, snap = SCENARIOS[name](PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    _kernel_vs_plain(snap, batch, np.zeros(len(gangs), bool), cuda)


@pytest.mark.gpu
def test_kernel_equals_plain_with_masks_and_gating(cuda):
    gangs, pods, snap = _bench(PORT, n=(12, 8, 10))
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    rng = np.random.default_rng(11)
    g, mg = batch.group_total.shape
    n = snap.capacity.shape[0]
    batch = batch._replace(
        group_node_ok=rng.random((g, mg, n)) < 0.85,
        reuse_nodes=rng.random((g, n)) < 0.05,
    )
    _kernel_vs_plain(snap, batch, np.zeros(len(gangs), bool), cuda)
    scaled = [x for x in gangs if x.base_podgang_name is not None]
    sbatch, _ = PORT.encode_gangs(scaled, pods, snap, global_index_of=gidx)
    assert (sbatch.depends_global >= 0).any()
    want = _kernel_vs_plain(snap, sbatch, rng.random(len(gangs)) < 0.5, cuda)
    assert not bool(want[1].all()), "the ok_global gate rejected nothing"


@pytest.mark.gpu
def test_kernel_equals_plain_with_pins(cuda):
    rg, rs, batch = pinned_bench_small()
    _kernel_vs_plain(rs, batch, np.zeros(len(rg), bool), cuda)


@pytest.mark.gpu
def test_kernel_domain_sums_equal_plain_on_card(cuda):
    _domain_tables_vs_plain(_card_launch, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bench_small", "nondyadic", "spread_pack", "bench_spread"])
def test_kernel_global_carry_equals_plain(cuda, name):
    gangs, pods, snap = SCENARIOS[name](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    _launch_vs_plain(_card_launch, snap, batch, np.zeros(len(gangs), bool), cuda,
                     shared_carry=False)


@pytest.mark.gpu
def test_kernel_spread_seeds_equal_plain(cuda):
    snap, batch = spread_seeded_batch()
    _kernel_vs_plain(snap, batch, np.zeros(batch.gang_valid.shape[0], bool), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shared_carry", [True, False])
def test_kernel_pruned_wave_equals_plain(cuda, shared_carry):
    for label, snap, batch, plan in pruned_cases():
        okg = np.zeros(batch.gang_valid.shape[0], bool)
        _launch_vs_plain(_card_launch, snap, batch, okg, cuda, plan, shared_carry)


@pytest.mark.gpu
def test_pruned_solve_batch_on_card_counts_a_pruned_launch(cuda):
    from grove_tpu_torch.solver.core import solve_batch

    _, snap, batch, plan = pruned_cases()[0]
    pwm.reset_launches()
    res = solve_batch(snap.free, snap.capacity, snap.schedulable, snap.node_domain_id, batch,
                      plan=plan)
    want = solve_batch(snap.free, snap.capacity, snap.schedulable, snap.node_domain_id, batch,
                       plan=plan, device="cpu")
    assert pwm.place_wave.variant_launches == {"shared": 0, "global": 0, "pruned": 1}
    for name, a, b in zip(FIELDS[:4], res, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.gpu
def test_drain_on_card_counts_one_launch_per_wave(cuda):
    gangs, pods, snap = _bench(PORT, n=(18, 12, 15))
    cpu_bindings, cpu_stats = drain_backlog(gangs, pods, snap, wave_size=16, device="cpu")
    pwm.place_wave.launches = 0
    bindings, stats = drain_backlog(gangs, pods, snap, wave_size=16)
    assert pwm.place_wave.launches == stats.waves > 1
    assert bindings == cpu_bindings
    assert np.array_equal(stats.free_after, cpu_stats.free_after)


# ---- host side of the wrapper (runs anywhere) --------------------------------


def test_args_struct_mirrors_the_cuda_source():
    src = (build.CSRC / "place_wave.cu").read_text()
    body = re.search(r"struct PlaceWaveArgs \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [x.strip() for x in re.sub(r"^(const\s+)?\w+\s*\**\s*", "", decl).split(",")]
    assert names == [f for f, _ in pwm.PlaceWaveArgs._fields_]


def test_domain_index_is_node_ordered_csr():
    ndid = np.array([[0, 1, 0, -1, 1, 2], [0, 1, 2, 3, 4, 5]], dtype=np.int32)
    idx = pwm.domain_index(ndid, "cpu")
    assert idx.count.tolist() == [3, 6]
    assert idx.offsets[0].tolist() == [0, 2, 4, 5, 5, 5, 5]
    assert idx.nodes[0, :5].tolist() == [0, 2, 1, 4, 5]
    assert idx.nodes[1].tolist() == [0, 1, 2, 3, 4, 5]


def _args_for(name):
    gangs, pods, snap = SCENARIOS[name](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    free, cap, sched, ndid = _node_tensors(snap, "cpu")
    return free, cap, sched, ndid, batch_to(batch, "cpu"), pwm.domain_index(ndid, "cpu")


def test_wrapper_refuses_cpu_tensors():
    free, cap, sched, ndid, tb, dom = _args_for("mixed")
    with pytest.raises(ValueError, match="CUDA device only"):
        pwm.place_wave(free, cap, sched, ndid, tb, SolverParams(), domains=dom)


def test_plain_domain_sum_is_a_node_order_fold():
    """The plain version's domain sum adds each domain's nodes one after
    another in node order, on data where that order shows in the last bits."""
    rng = np.random.default_rng(2)
    n, d = 600, 5
    seg = rng.integers(0, d + 1, size=n)
    vals = (rng.integers(1, 400, size=(n, 3)) * 0.1).astype(np.float32)
    want = np.zeros((d + 1, 3), np.float32)
    for i in range(n):
        want[seg[i]] = want[seg[i]] + vals[i]
    got = _domain_sum(torch.as_tensor(vals), torch.as_tensor(seg), d).numpy()
    assert np.array_equal(got, want[:d])
    rev = _domain_sum(torch.as_tensor(vals[::-1].copy()), torch.as_tensor(seg[::-1].copy()), d)
    assert not np.array_equal(rev.numpy(), got), "the data does not tell the orders apart"


def spread_seeded_batch():
    """bench_spread with spread_avoid seeds: sibling replicas already live in
    the store on a few nodes."""
    gangs, pods, snap = SCENARIOS["bench_spread"](PORT)
    n = snap.capacity.shape[0]
    avoid = {g.name: [(37 * i) % n, (101 * i + 5) % n] for i, g in enumerate(gangs[::3])}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, spread_avoid_by_gang=avoid)
    assert batch.spread_avoid.any()
    return snap, batch


def test_spread_planes_move_placements():
    """The spread scenarios' planes change what the plain version places,
    so the kernel tests on them test the planes."""
    for snap, batch in (
        spread_seeded_batch(),
        (lambda g, p, s: (s, PORT.encode_gangs(g, p, s)[0]))(*SCENARIOS["spread_pack"](PORT)),
    ):
        tb = batch_to(batch, "cpu")
        plain = batch_to(batch._replace(spread_level=None, spread_family=None, spread_avoid=None),
                         "cpu")
        a = solve_batch_ref(*_node_tensors(snap, "cpu"), tb, SolverParams())
        b = solve_batch_ref(*_node_tensors(snap, "cpu"), plain, SolverParams())
        assert not torch.equal(a[0], b[0])


def test_wrapper_picks_the_carry_by_size():
    free, cap, sched, ndid, tb, dom = _args_for("contended")
    n, r = free.shape
    _, smem, shared, _, keep = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom)
    assert shared and smem == 2 * n * r * 4 <= pwm.SHARED_CARRY_BYTES
    assert keep["carry_g"] is None
    _, smem, shared, _, keep = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None,
                                              dom, shared_carry=False)
    assert not shared and smem == 0 and keep["carry_g"].numel() == n * r
    assert keep["carry"] is None  # a dense solve works on the fleet tensor itself


def test_wrapper_takes_a_fleet_past_the_shared_carry():
    """20480 nodes x 8 resources: 1.25 MiB of carry, far past shared memory;
    the wrapper fills the global-carry arguments and never raises on size."""
    n, r, levels = 20480, 8, 4
    free = torch.zeros((n, r))
    ndid = torch.as_tensor(np.stack([np.arange(n) // (n >> k) for k in (2, 4, 6)] +
                                    [np.arange(n)]).astype(np.int32))
    _, _, _, _, _, dom = _args_for("mixed")
    tb = _args_for("mixed")[4]
    tb = tb._replace(group_req=torch.zeros(tb.group_req.shape[:2] + (r,)))
    dom = pwm.domain_index(ndid, "cpu")
    args, smem, shared, _, keep = pwm.build_args(
        free, torch.ones((n, r)), torch.ones(n, dtype=torch.bool), ndid, tb, SolverParams(),
        None, dom,
    )
    assert not shared and smem == 0 and args.N == n and args.R == r
    with pytest.raises(ValueError, match="shared carry"):
        pwm.build_args(free, torch.ones((n, r)), torch.ones(n, dtype=torch.bool), ndid, tb,
                       SolverParams(), None, dom, shared_carry=True)


def test_wrapper_fills_pruned_args():
    label, snap, batch, plan = pruned_cases()[0]
    pt = plan.tensors("cpu")
    tb = batch_to(plan.gather_batch(batch), "cpu")
    free = torch.as_tensor(snap.free, dtype=torch.float32)
    args, smem, shared, _, keep = pwm.build_args(
        free, pt.capacity, pt.schedulable, pt.node_domain_id, tb, SolverParams(), None,
        pwm.domain_index(pt.node_domain_id, "cpu"), pt.cand_idx, plan.count,
    )
    assert (args.N, args.NF, args.cand_count) == (plan.pad, free.shape[0], plan.count)
    assert args.cand_idx == pt.cand_idx.data_ptr() and args.free_io == free.data_ptr()
    assert pt.cand_idx[plan.count:].eq(free.shape[0]).all()
    with pytest.raises(ValueError, match="cand_count"):
        pwm.build_args(free, pt.capacity, pt.schedulable, pt.node_domain_id, tb,
                       SolverParams(), None, pwm.domain_index(pt.node_domain_id, "cpu"),
                       pt.cand_idx, None)


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda a: a.__setitem__(0, a[0].double()), "free is torch.float64"),
        (lambda a: a.__setitem__(2, a[2].to(torch.uint8)), "schedulable is torch.uint8"),
        (lambda a: a.__setitem__(3, a[3][:, :-1]), "node_domain_id has shape"),
        (lambda a: a.__setitem__(1, a[1].t().contiguous().t()), "capacity is not contiguous"),
        (lambda a: a.__setitem__(4, a[4]._replace(pod_rank=a[4].pod_rank[:, :1])), "pod_rank has shape"),
    ],
)
def test_wrapper_checks_inputs(mutate, match):
    args = list(_args_for("mixed"))
    mutate(args)
    free, cap, sched, ndid, tb, dom = args
    with pytest.raises(ValueError, match=match):
        pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom)


def test_wrapper_fills_args_for_a_valid_batch():
    free, cap, sched, ndid, tb, dom = _args_for("contended")
    okg = torch.zeros(tb.gang_valid.shape[0], dtype=torch.bool)
    args, smem, shared, out, keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), okg, dom
    )
    n, r = free.shape
    assert shared and smem == 2 * n * r * 4
    assert (args.N, args.R, args.G, args.T) == (n, r, tb.gang_valid.shape[0], okg.shape[0])
    assert args.free_io == free.data_ptr() and args.ok_global == okg.data_ptr()
    assert args.reuse_nodes is None and args.group_node_ok is None
    assert out["ok"].dtype == torch.bool and not out["ok"].any()


# ---- the kernel source on the host (runs where a C++ compiler is) ------------
#
# place_wave.cu compiles as plain C++ when PLACE_WAVE_HOST_EMULATION is
# defined and the CUDA built-ins below stand in for a one-thread block (warp
# width 1, barriers no-ops, the _rn intrinsics plain IEEE operations under
# -ffp-contract=off). That runs the kernel's own control flow and arithmetic
# against the plain version on the CPU; races and the warp reductions are
# checked only on the card.

_HOST_SHIM = r"""
#include <cmath>
#include <cstdint>
#define PLACE_WAVE_HOST_EMULATION 1
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
struct Dim3 { unsigned x; };
static Dim3 threadIdx = {0}, blockDim = {1};
static inline void __syncthreads() {}
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
using std::isinf;
float pw_smem[1 << 20];
#include "place_wave.cu"
extern "C" int place_wave_launch(const PlaceWaveArgs* a, void*, int, int shared_carry) {
  if (shared_carry) place_wave_kernel<true>(*a);
  else place_wave_kernel<false>(*a);
  return 0;
}
extern "C" int place_wave_args_size() { return (int)sizeof(PlaceWaveArgs); }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for emulation")
    d = tmp_path_factory.mktemp("place_wave_host")
    (d / "shim.cpp").write_text(_HOST_SHIM)
    lib = d / "libplace_wave_host.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         f"-I{build.CSRC}", "-o", str(lib), str(d / "shim.cpp")],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    assert so.place_wave_args_size() == ctypes.sizeof(pwm.PlaceWaveArgs)
    fn = so.place_wave_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, smem, shared):
        assert fn(ctypes.byref(args), None, smem, int(shared)) == 0

    return launch


def _host_vs_plain(host_kernel, snap, batch, okg_np, plan=None, shared_carry=None):
    return _launch_vs_plain(host_kernel, snap, batch, okg_np, "cpu", plan, shared_carry)


def test_kernel_source_on_host_with_pins(host_kernel):
    rg, rs, batch = pinned_bench_small()
    _host_vs_plain(host_kernel, rs, batch, np.zeros(len(rg), bool))


def test_kernel_source_on_host_domain_sums_equal_plain(host_kernel):
    feat, seg, want = _domain_tables_vs_plain(host_kernel, "cpu")
    n = feat.shape[0]
    rev = [_domain_sum(feat.flip(0), s.flip(0), n) for s in seg]
    assert any(not torch.equal(a, b) for a, b in zip(rev, want)), (
        "the scenario's domain sums do not tell the summation orders apart"
    )


@pytest.mark.parametrize("name", KERNEL_SCENARIOS)
def test_kernel_source_on_host_equals_plain(host_kernel, name):
    gangs, pods, snap = SCENARIOS[name](PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    _host_vs_plain(host_kernel, snap, batch, np.zeros(len(gangs), bool))


def test_kernel_source_on_host_masks_and_gating(host_kernel):
    gangs, pods, snap = _bench(PORT, n=(12, 8, 10))
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    rng = np.random.default_rng(5)
    g, mg = batch.group_total.shape
    n = snap.capacity.shape[0]
    masked = batch._replace(
        group_node_ok=rng.random((g, mg, n)) < 0.85, reuse_nodes=rng.random((g, n)) < 0.05
    )
    _host_vs_plain(host_kernel, snap, masked, np.zeros(len(gangs), bool))
    scaled = [x for x in gangs if x.base_podgang_name is not None]
    sbatch, _ = PORT.encode_gangs(scaled, pods, snap, global_index_of=gidx)
    want = _host_vs_plain(host_kernel, snap, sbatch, rng.random(len(gangs)) < 0.5)
    assert not bool(want[1].all())


@pytest.mark.parametrize("name", ["bench_small", "nondyadic", "spread_pack", "bench_spread"])
def test_kernel_source_on_host_global_carry(host_kernel, name):
    gangs, pods, snap = SCENARIOS[name](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    _host_vs_plain(host_kernel, snap, batch, np.zeros(len(gangs), bool), shared_carry=False)


def test_kernel_source_on_host_spread_seeds(host_kernel):
    snap, batch = spread_seeded_batch()
    for shared_carry in (True, False):
        _host_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                       shared_carry=shared_carry)


@pytest.mark.parametrize("shared_carry", [True, False])
@pytest.mark.parametrize("case", ["half_full", "clipped", "spread", "pinned"])
def test_kernel_source_on_host_pruned_wave(host_kernel, case, shared_carry):
    """The fused B3: gather through cand_idx, solve on the candidate axis,
    scatter back into the fleet carry, remap assigned to fleet ordinals."""
    label, snap, batch, plan = next(c for c in pruned_cases() if c[0] == case)
    want = _host_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                          plan, shared_carry)
    # Candidate rows changed only where the solve placed pods; the rest of
    # the fleet carry passes through untouched.
    untouched = np.setdiff1d(np.arange(snap.capacity.shape[0]), plan.idx)
    assert np.array_equal(want[3].numpy()[untouched], snap.free[untouched].astype(np.float32))
    placed = want[0][want[0] >= 0].numpy()
    assert placed.size and np.isin(placed, plan.idx).all()
    if case == "half_full":
        assert plan.idx.min() >= plan.fleet_pad // 2, "candidate ordinals equal fleet ordinals"
