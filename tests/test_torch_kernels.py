"""The place_wave CUDA kernel (grove_tpu_torch/kernels) against its plain
PyTorch version.

Tests marked `gpu` need an NVIDIA card: they decide inside the `cuda`
fixture whether one is present and skip with a reason where there is none.
On the card (python -m pytest -m gpu tests/test_torch_kernels.py) they repeat
chip_smoke.py's exactness phase: the kernel and the plain version, both on
the card, must agree exactly (torch.equal) on ok, assigned,
placement_score, free_after and ok_global. The unmarked tests check the
wrapper's host side, which runs anywhere.
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
from grove_tpu_torch.solver.reference import _domain_sum, group_slots_ref, solve_batch_ref
from test_torch_host import PORT, SCENARIOS, _bench
from test_torch_solver import pinned_bench_small

FIELDS = ("assigned", "ok", "placement_score", "free_after", "ok_global")
KERNEL_SCENARIOS = sorted(n for n in SCENARIOS if not n.startswith("spread"))


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


def _kernel_vs_plain(snap, batch, okg_np, dev):
    tb = batch_to(batch, dev)
    okg = torch.as_tensor(okg_np, device=dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    dom = pwm.domain_index(snap.node_domain_id, dev)
    got = pwm.place_wave(free, cap, sched, ndid, tb, SolverParams(), okg.clone(), domains=dom)
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
    args, smem, _out, keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), None, pwm.domain_index(snap.node_domain_id, dev)
    )
    launch(args, smem)
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
    import ctypes

    fn = build.load("place_wave").place_wave_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, smem):
        assert fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream, smem) == 0
        torch.cuda.synchronize()

    _domain_tables_vs_plain(launch, cuda)


@pytest.mark.gpu
def test_kernel_raises_on_spread_planes(cuda):
    gangs, pods, snap = SCENARIOS["spread"](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    assert batch.spread_level is not None
    free, cap, sched, ndid = _node_tensors(snap, cuda)
    dom = pwm.domain_index(snap.node_domain_id, cuda)
    with pytest.raises(NotImplementedError, match="spread planes in the B1 kernel"):
        pwm.place_wave(free, cap, sched, ndid, batch_to(batch, cuda), SolverParams(), domains=dom)


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


def test_wrapper_raises_on_spread_planes_before_any_launch():
    free, cap, sched, ndid, tb, dom = _args_for("spread")
    with pytest.raises(NotImplementedError, match="spread planes in the B1 kernel"):
        pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom)


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
    args, smem, out, keep = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), okg, dom)
    n, r = free.shape
    assert smem == 2 * n * r * 4
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
extern "C" int place_wave_launch(const PlaceWaveArgs* a, void*, int) {
  place_wave_kernel(*a);
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
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, smem):
        assert fn(ctypes.byref(args), None, smem) == 0

    return launch


def _host_vs_plain(host_kernel, snap, batch, okg_np):
    tb = batch_to(batch, "cpu")
    okg = torch.as_tensor(okg_np)
    free, cap, sched, ndid = _node_tensors(snap, "cpu")
    okg_k = okg.clone()
    args, smem, out, _keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), okg_k, pwm.domain_index(ndid, "cpu")
    )
    host_kernel(args, smem)
    got = (out["assigned"], out["ok"], out["score"], free, okg_k)
    want = solve_batch_ref(*_node_tensors(snap, "cpu"), tb, SolverParams(), okg.clone())
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), f"{name}: kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    return want


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
