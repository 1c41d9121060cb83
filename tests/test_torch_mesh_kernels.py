"""The two compositions of kernel B7 in host emulation, against their plain
versions at tolerance 0: the stacked launch over shards (B5 x B7, a
portfolio under a (portfolio, node) mesh: K weight rows times S shards in
one launch, then the select) and the scan over shards (B4 x B7: S shards
walking a chunk's steps together, dense and pruned, with the retained
carries).

The kernel source is built for the host with g++ as tests/test_torch_mesh.py
builds it (`_SHARD_SHIM`: each block a thread, the walk plane
thread-local), on the synthetic, contended, quality and spread cases of that
module; the plain versions are solver/reference.py
`sharded_stacked_solve_ref` + `portfolio_select_ref`,
`sharded_scan_solve_ref` and `sharded_scan_pruned_solve_ref`. A small
`plane_words` makes every walk stage in many chunks. No JAX program runs
here.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grove_tpu_torch.kernels import build
from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.parallel.portfolio import params_population
from grove_tpu_torch.solver import reference as ref
from grove_tpu_torch.solver.core import SolverParams, batch_to
from grove_tpu_torch.solver.encode import encode_gangs, stack_batches
from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates, stack_plan_arrays
from test_torch_mesh import _SHARD_SHIM, world

OUT = ("assigned", "ok", "score", "free_after")
SCAN_OUT = ("assigned", "ok", "score", "free_in", "okg_in", "free_after", "ok_global")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The kernel source built for the host, each shard a thread."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for emulation")
    d = tmp_path_factory.mktemp("place_wave_compositions")
    (d / "shim.cpp").write_text(_SHARD_SHIM)
    so_path = d / "libplace_wave_compositions.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{build.CSRC}", "-o", str(so_path), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(so_path))
    assert so.place_wave_args_size() == ctypes.sizeof(pwm.PlaceWaveArgs)
    for name, extra in (("place_wave_stacked_sharded_launch", True),
                        ("place_wave_scan_sharded_launch", False)):
        fn = getattr(so, name)
        fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int] + (
            [ctypes.c_int] if extra else [])
        fn.restype = ctypes.c_int
    return so


def case(name):
    """(gangs, pods, snapshot, batch) of one case on the port: the mesh
    module's synthetic, contended and quality worlds, and the spread case
    (every node alike, spread planes and reuse seeds drawn from a seed)."""
    if name != "spread":
        gangs, pods, snap = world("port", name)
        batch, _ = encode_gangs(gangs, pods, snap,
                                global_index_of={g.name: i for i, g in enumerate(gangs)})
        return gangs, pods, snap, batch
    from test_torch_host import PORT, SCENARIOS

    gangs, pods, snap = SCENARIOS["uniform"](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap,
                                 global_index_of={g.name: i for i, g in enumerate(gangs)})
    rng = np.random.default_rng(3)
    g, n = batch.gang_valid.shape[0], snap.capacity.shape[0]
    batch = batch._replace(spread_level=np.full(g, 1, np.int32),
                           spread_family=(np.arange(g) % 3).astype(np.int32),
                           spread_avoid=rng.random((g, n)) < 0.1,
                           reuse_nodes=rng.random((g, n)) < 0.1)
    return gangs, pods, snap, batch


def node_state(snap):
    return (torch.as_tensor(snap.free, dtype=torch.float32),
            *(torch.as_tensor(np.asarray(x)) for x in (snap.capacity, snap.schedulable,
                                                        snap.node_domain_id)))


def spans_of(n, shards):
    return [(s * n // shards, (s + 1) * n // shards) for s in range(shards)]


def assert_equal(names, got, want, label):
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), (label, name)
        if b is not None:
            assert torch.equal(a, b), f"{label}: {name} differs at {torch.nonzero(a != b)[:8]}"


# ---- B5 x B7 ----------------------------------------------------------------------


@pytest.mark.parametrize("rows,shards", [(4, 2), (2, 4), (3, 8)])
@pytest.mark.parametrize("name", ["synthetic", "contended", "quality", "spread"])
def test_stacked_sharded_on_host_equals_plain(lib, name, rows, shards):
    """Every row (its shard 0's verdicts, the carry its shards share) and
    the select's winner, objectives, carry and ok_global equal the plain
    versions; the select=False launch leaves the fleet carry as it was."""
    gangs, _, snap, batch = case(name)
    tb = batch_to(batch, "cpu")
    free, cap, sched, ndid = node_state(snap)
    okg = torch.as_tensor(np.random.default_rng(5).random(len(gangs)) < 0.3)
    pstack = torch.as_tensor(np.array(params_population(rows)))
    plain = ref.sharded_stacked_solve_ref(free, cap, sched, ndid, tb, pstack, okg,
                                          spans_of(cap.shape[0], shards))
    want = ref.portfolio_select_ref(*plain, tb, okg.clone())
    domains = pwm.domain_index_sharded(ndid, shards, "cpu")
    for select in (False, True):
        got_free, got_okg = free.clone(), okg.clone()
        args, smem, out, _keep = pwm.build_args(
            got_free, cap, sched, ndid, tb, None, got_okg, domains, params_stack=pstack,
            select=select, shards=shards, plane_words=64)
        assert lib.place_wave_stacked_sharded_launch(ctypes.byref(args), None, smem,
                                                     int(select)) == 0
        rows_got = (out["assigned"][:, 0], out["ok"][:, 0], out["score"][:, 0],
                    out["free_after"])
        assert_equal(OUT, rows_got, plain, f"{name} K={rows} S={shards} rows")
        for s in range(1, shards):  # every shard holds the replicated verdicts
            assert torch.equal(out["ok"][:, s], plain[1]), s
        if select:
            assert_equal(("assigned", "ok", "score", "free", "ok_global", "winner",
                          "objectives"),
                         (out["win_assigned"], out["win_ok"], out["win_score"], got_free,
                          got_okg, out["winner"], out["objectives"]), want,
                         f"{name} K={rows} S={shards} select")
        else:
            assert torch.equal(got_free, free) and torch.equal(got_okg, okg)
    assert bool(want[1].any())


# ---- B4 x B7 ----------------------------------------------------------------------


def chunk(gangs, pods, snap, batch, waves):
    """The case's gangs cut into `waves` waves of one shape, stacked (the
    ok_global indices run over every gang, so later steps gate on earlier
    ones)."""
    gidx = {g.name: i for i, g in enumerate(gangs)}
    per = -(-len(gangs) // waves)
    shape = dict(max_groups=batch.group_req.shape[1], max_sets=batch.set_member.shape[1],
                 max_pods=batch.pod_group.shape[1], pad_gangs_to=max(per, 1))
    out = []
    for w in range(waves):
        b, _ = encode_gangs(gangs[w * per:(w + 1) * per], pods, snap, global_index_of=gidx,
                            **shape)
        if batch.spread_level is not None:  # the spread case's drawn planes, cut per wave
            sl = slice(w * per, w * per + b.gang_valid.shape[0])
            b = b._replace(spread_level=batch.spread_level[sl],
                           spread_family=batch.spread_family[sl],
                           spread_avoid=batch.spread_avoid[sl], reuse_nodes=batch.reuse_nodes[sl])
        out.append(b)
    return out


def launch_scan(lib, free, cap, sched, ndid, sb, okg, domains, shards, cand=None,
                retain=True):
    got_free, got_okg = free.clone(), okg.clone()
    args, smem, out, _keep = pwm.build_scan_args(
        got_free, cap, sched, ndid, sb, SolverParams(), got_okg, domains, cand, retain,
        plane_words=64, shards=shards)
    assert lib.place_wave_scan_sharded_launch(ctypes.byref(args), None, smem) == 0
    return (out["assigned"][:, 0], out["ok"][:, 0], out["score"][:, 0], out["free_in"],
            out["okg_in"], got_free, got_okg)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", ["synthetic", "contended", "quality", "spread"])
def test_scan_sharded_on_host_equals_plain(lib, name, shards):
    """Three steps (the last a null wave where the case cuts short) with the
    carries retained: every step's verdicts, the entering carries and the
    final carry equal sharded_scan_solve_ref."""
    gangs, pods, snap, batch = case(name)
    sb = batch_to(stack_batches(chunk(gangs, pods, snap, batch, 3), pad_to=4), "cpu")
    free, cap, sched, ndid = node_state(snap)
    okg = torch.zeros(len(gangs), dtype=torch.bool)
    want = ref.sharded_scan_solve_ref(free, cap, sched, ndid, sb, SolverParams(), okg, True,
                                      spans_of(cap.shape[0], shards))
    got = launch_scan(lib, free, cap, sched, ndid, sb, okg,
                      pwm.domain_index_sharded(ndid, shards, "cpu"), shards)
    assert_equal(SCAN_OUT, got, want, f"{name} S={shards}")
    assert bool(want[1].any())


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_scan_sharded_pruned_on_host_equals_plain(lib, shards):
    """Each step on its own candidate axis, split over the shards (each
    gathering and scattering its own candidate rows): equal to
    sharded_scan_pruned_solve_ref, assigned in fleet ordinals, the
    retained carries fleet-shaped."""
    gangs, pods, snap, batch = case("synthetic")
    waves = chunk(gangs, pods, snap, batch, 3)
    cfg = PruningConfig(enabled=True, max_candidates=120, min_fleet=16, min_pad=128)
    plans = [plan_candidates(snap, b, cfg, mesh_axis=shards) for b in waves]
    assert all(p is not None and p.pad == plans[0].pad for p in plans)
    cand, cap_p, sched_p, ndid_p, pbatch = stack_plan_arrays(plans, waves, pad_to=4)
    cand, cap_p, sched_p, ndid_p = (torch.as_tensor(x) for x in (cand, cap_p, sched_p, ndid_p))
    sb = batch_to(pbatch, "cpu")
    free = torch.as_tensor(snap.free, dtype=torch.float32)
    okg = torch.zeros(len(gangs), dtype=torch.bool)
    want = ref.sharded_scan_pruned_solve_ref(free, cand, cap_p, sched_p, ndid_p, sb,
                                             SolverParams(), okg, True,
                                             spans_of(cap_p.shape[1], shards))
    got = launch_scan(lib, free, cap_p, sched_p, ndid_p, sb, okg,
                      pwm.domain_index_stacked_sharded(ndid_p, shards, "cpu"), shards, cand)
    assert_equal(SCAN_OUT, got, want, f"pruned S={shards}")
    assert bool(want[1].any())
    # The plain version's steps are the pruned scan's: the same verdicts.
    unsharded = ref.scan_pruned_solve_ref(free, cand, cap_p, sched_p, ndid_p, sb,
                                          SolverParams(), okg, True)
    assert_equal(SCAN_OUT, want, unsharded, f"pruned S={shards} vs unsharded")
