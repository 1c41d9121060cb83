"""The place_wave CUDA kernel (grove_tpu_torch/kernels) against its plain
PyTorch version.

Tests marked `gpu` need an NVIDIA card: they decide inside the `cuda`
fixture whether one is present and skip with a reason where there is none.
On the card (python -m pytest -m gpu tests/test_torch_kernels.py) they repeat
chip_smoke.py's exactness phase: the kernel and the plain version, both on
the card, must agree exactly (torch.equal) on ok, assigned,
placement_score, free_after and ok_global — with walks staged whole or in
many chunks, with the replica-spread planes, and for a candidate-pruned wave
(the B3 gather, scatter and remap inside the launch).
The stacked launch (B5, `place_wave_stacked`) is held against the plain
stacked solve and the plain portfolio select the same way: every weight row
(odd rows worst-fit), the winner, its rows, the carry and ok_global it
leaves, and the objectives.
The unmarked tests check the wrapper's host side, and the kernel source
compiled for the host (one-thread emulation), which run anywhere.
"""

from __future__ import annotations

import ctypes
import re

import jax  # noqa: F401  (JAX stays on the CPU: conftest forces the platform)
import numpy as np
import pytest
import torch

from grove_tpu_torch.kernels import build
from grove_tpu_torch.kernels import place_wave as pwm
from grove_tpu_torch.solver.core import SolverParams, batch_to
from grove_tpu_torch.solver.encode import GangBatch, gang_shape, next_pow2, stack_batches
from grove_tpu_torch.solver.drain import drain_backlog
from grove_tpu_torch.solver.pruning import PruningConfig, plan_candidates
from grove_tpu_torch.parallel.portfolio import params_population
from grove_tpu_torch.solver.reference import (
    _domain_sum,
    group_slots_ref,
    params_row,
    portfolio_select_ref,
    solve_batch_ref,
    solve_pruned_ref,
    stacked_solve_ref,
)
from test_torch_host import PORT, SCENARIOS, _bench
from test_torch_solver import pinned_bench_small
from torch_jax_programs import _release_jax_programs  # noqa: F401

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


def _launch_vs_plain(launch, snap, batch, okg_np, dev, plan=None, plane_words=None,
                     profile=False):
    """One wave through `launch(args, smem, profile)` (the kernel, on the card
    or compiled for the host) against the plain version, exactly. A small
    `plane_words` makes every walk stage its nodes in many chunks. Returns
    the plain outputs, and with `profile` also the kernel's scratch tensors
    (the cycle table under "prof", the gang records under "ginv")."""
    okg = torch.as_tensor(okg_np, device=dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    cand = (None, None)
    if plan is not None:
        batch = plan.gather_batch(batch)
        pt = plan.tensors(dev)
        cap, sched, ndid, cand = pt.capacity, pt.schedulable, pt.node_domain_id, (pt.cand_idx, plan.count)
    tb = batch_to(batch, dev)
    okg_k = okg.clone()
    args, smem, out, _keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), okg_k, pwm.domain_index(ndid.cpu(), dev),
        *cand, profile=profile, plane_words=plane_words,
    )
    launch(args, smem, profile)
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
    return (want, {**_keep, "prof": out.get("prof")}) if profile else want


def _card_launch(args, smem, profile=False):
    import ctypes

    fn = build.load("place_wave").place_wave_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p] + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(ctypes.byref(args), stream, smem, int(profile)) == 0
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


def table_columns(batch, gi, levels):
    """{level: [group, ...]}: the narrow-set tables the kernel builds for gang
    gi — at the required level of every valid set that some valid set's
    nested pass reads (it overlaps it and requires a narrower level), with
    the slot columns of those sets' member2 groups in first-seen order."""
    member = np.asarray(batch.set_member[gi], bool)
    m2 = member & np.asarray(batch.group_valid[gi], bool)[None, :]
    req = np.asarray(batch.set_req_level[gi])
    valid = np.asarray(batch.set_valid[gi], bool)
    ms = member.shape[0]
    cols: dict[int, list[int]] = {}
    for s2 in range(ms):
        if not any(valid[s] and req[s] >= 0 and valid[s2] and req[s2] > req[s]
                   and (member[s] & member[s2]).any() for s in range(ms)):
            continue
        groups = cols.setdefault(int(np.clip(req[s2], 0, levels - 1)), [])
        groups += [g for g in np.flatnonzero(m2[s2]).tolist() if g not in groups]
    return cols


def _domain_tables_vs_plain(launch, dev):
    """The kernel's narrow-set tables for one gang of the non-dyadic
    scenario — at each level some nested pass reads, per domain, the sums of
    [free, slots of the groups the fits read] over schedulable nodes —
    against the plain version's domain sums; no other level is written.
    Returns {level: (features, plain sums)} and the per-level segments."""
    gangs, pods, snap = SCENARIOS["nondyadic"](PORT)
    batch, _ = PORT.encode_gangs(gangs[:1], pods, snap)
    tb = batch_to(batch, dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    n, r = free.shape
    levels, mg = ndid.shape[0], tb.group_req.shape[1]
    cols = table_columns(batch, 0, levels)
    assert cols, "the gang reads no table"
    slots = group_slots_ref(free, tb.group_req[0])
    seg = torch.where(ndid >= 0, ndid, n).long()
    want = {}
    for lv, groups in cols.items():
        feat = torch.where(sched[:, None], torch.cat([free, slots[groups].T.float()], dim=1), 0.0)
        want[lv] = (feat, _domain_sum(feat, seg[lv], n)[: snap.num_domains[lv]])
    args, smem, _out, keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), None, pwm.domain_index(snap.node_domain_id, dev)
    )
    keep["tables"].fill_(float("nan"))
    launch(args, smem)
    got = keep["tables"].view(levels, n * (r + mg))
    for lv in range(levels):
        if lv not in want:
            assert torch.isnan(got[lv]).all(), f"level {lv}: a table no nested pass reads was built"
            continue
        d, k = want[lv][1].shape
        assert torch.equal(got[lv, : d * k].view(d, k), want[lv][1]), (
            f"level {lv}: kernel != plain domain sums"
        )
    return want, seg


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
    """The carry in global memory with every walk staged in many chunks."""
    gangs, pods, snap = SCENARIOS[name](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    _launch_vs_plain(_card_launch, snap, batch, np.zeros(len(gangs), bool), cuda,
                     plane_words=min_plane_words(batch))


@pytest.mark.gpu
def test_kernel_spread_seeds_equal_plain(cuda):
    snap, batch = spread_seeded_batch()
    _kernel_vs_plain(snap, batch, np.zeros(batch.gang_valid.shape[0], bool), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("staging", ["whole", "chunked"])
def test_kernel_pruned_wave_equals_plain(cuda, staging):
    for label, snap, batch, plan in pruned_cases():
        okg = np.zeros(batch.gang_valid.shape[0], bool)
        _launch_vs_plain(_card_launch, snap, batch, okg, cuda, plan,
                         min_plane_words(batch) if staging == "chunked" else None)


@pytest.mark.gpu
def test_profiled_kernel_equals_plain_and_skips_unread_tables(cuda):
    batch, snap = partly_active_batch()
    _, keep = _launch_vs_plain(_card_launch, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                               cuda, profile=True)
    check_table_cycles(batch, snap, keep["prof"].cpu().numpy())


@pytest.mark.gpu
def test_kernel_is_deterministic_over_20_launches(cuda):
    """The same wave launched 20 times gives bitwise-equal outputs: races
    between threads, which the one-thread emulation cannot show, would not."""
    snap, batch = spread_seeded_batch()
    g, mg = batch.group_total.shape
    rng = np.random.default_rng(7)
    batch = batch._replace(group_node_ok=rng.random((g, mg, snap.capacity.shape[0])) < 0.9)
    tb = batch_to(batch, cuda)
    dom = pwm.domain_index(snap.node_domain_id, cuda)
    runs = []
    for _ in range(20):
        free, cap, sched, ndid = _node_tensors(snap, cuda)
        okg = torch.zeros(g, dtype=torch.bool, device=cuda)
        out = pwm.place_wave(free, cap, sched, ndid, tb, SolverParams(), okg, domains=dom)
        runs.append([x.clone() for x in out])
    torch.cuda.synchronize()
    assert bool(runs[0][1].any())
    for run in runs[1:]:
        for name, a, b in zip(FIELDS, run, runs[0]):
            assert torch.equal(a, b), f"{name} differs between launches"


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_kernel_is_deterministic_at_full_width(cuda, scale):
    """The bench's first wave on 5120 or 20480 nodes, launched 20 times,
    gives bitwise-equal outputs: every warp owns nodes, so the cross-warp
    take and the owner warp's rescan run at full width."""
    from grove_tpu_torch.bench import build_backlog, build_fleet
    from grove_tpu_torch.solver.drain import plan_waves

    gangs, pods = build_backlog(1.0)
    snap = build_fleet(scale)
    wave, (mg, ms, mp), pad = plan_waves(gangs, 256)[0]
    batch, _ = PORT.encode_gangs(wave, pods, snap, max_groups=mg, max_sets=ms, max_pods=mp,
                                 pad_gangs_to=pad,
                                 global_index_of={g.name: i for i, g in enumerate(gangs)})
    tb = batch_to(batch, cuda)
    dom = pwm.domain_index(snap.node_domain_id, cuda)
    runs = []
    for _ in range(20):
        free, cap, sched, ndid = _node_tensors(snap, cuda)
        okg = torch.zeros(len(gangs), dtype=torch.bool, device=cuda)
        out = pwm.place_wave(free, cap, sched, ndid, tb, SolverParams(), okg, domains=dom)
        runs.append([x.clone() for x in out])
    torch.cuda.synchronize()
    # Nodes are strided over the block's 1024 threads: every warp owns some.
    assert snap.capacity.shape[0] >= 1024 and bool(runs[0][1].all())
    for run in runs[1:]:
        for name, a, b in zip(FIELDS, run, runs[0]):
            assert torch.equal(a, b), f"{name} differs between launches"


@pytest.mark.gpu
def test_pruned_solve_batch_on_card_counts_a_pruned_launch(cuda):
    from grove_tpu_torch.solver.core import solve_batch

    _, snap, batch, plan = pruned_cases()[0]
    pwm.reset_launches()
    res = solve_batch(snap.free, snap.capacity, snap.schedulable, snap.node_domain_id, batch,
                      plan=plan)
    want = solve_batch(snap.free, snap.capacity, snap.schedulable, snap.node_domain_id, batch,
                       plan=plan, device="cpu")
    assert pwm.place_wave.variant_launches == {**dict.fromkeys(pwm.VARIANTS, 0), "pruned": 1}
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


def test_wrapper_sizes_the_walk_planes():
    free, cap, sched, ndid, tb, dom = _args_for("contended")
    n, r = free.shape
    args, smem, _, keep = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom)
    assert smem == pwm.PLANE_BYTES and args.plane_words == pwm.PLANE_BYTES // 4
    assert keep["carry"] is None  # a dense solve works on the fleet tensor itself
    k_max = min_plane_words(tb)
    args, smem, _, _ = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom,
                                      plane_words=k_max)
    assert smem == 4 * k_max and args.plane_words == k_max
    for words in (k_max - 1, pwm.PLANE_BYTES // 4 + 1):
        with pytest.raises(ValueError, match="plane_words"):
            pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), None, dom,
                           plane_words=words)


def test_wrapper_takes_a_fleet_past_the_shared_carry():
    """20480 nodes x 8 resources: 1.25 MiB of carry, far past what shared
    memory could hold; the carry stays the fleet tensor in global memory, the
    tables' scratch covers every level, and the wrapper never raises on
    size."""
    n, r, levels = 20480, 8, 4
    free = torch.zeros((n, r))
    ndid = torch.as_tensor(np.stack([np.arange(n) // (n >> k) for k in (2, 4, 6)] +
                                    [np.arange(n)]).astype(np.int32))
    _, _, _, _, _, dom = _args_for("mixed")
    tb = _args_for("mixed")[4]
    tb = tb._replace(group_req=torch.zeros(tb.group_req.shape[:2] + (r,)))
    dom = pwm.domain_index(ndid, "cpu")
    args, smem, _, keep = pwm.build_args(
        free, torch.ones((n, r)), torch.ones(n, dtype=torch.bool), ndid, tb, SolverParams(),
        None, dom,
    )
    assert smem == pwm.PLANE_BYTES and args.N == n and args.R == r
    assert keep["carry"] is None and keep["tables"].numel() == levels * n * (r + tb.group_req.shape[1])


def test_wrapper_fills_pruned_args():
    label, snap, batch, plan = pruned_cases()[0]
    pt = plan.tensors("cpu")
    tb = batch_to(plan.gather_batch(batch), "cpu")
    free = torch.as_tensor(snap.free, dtype=torch.float32)
    args, smem, _, keep = pwm.build_args(
        free, pt.capacity, pt.schedulable, pt.node_domain_id, tb, SolverParams(), None,
        pwm.domain_index(pt.node_domain_id, "cpu"), pt.cand_idx, plan.count,
    )
    assert keep["carry"].numel() == plan.pad * free.shape[1]
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
    args, smem, out, keep = pwm.build_args(
        free, cap, sched, ndid, tb, SolverParams(), okg, dom
    )
    n, r = free.shape
    assert smem == 4 * args.plane_words and "prof" not in out
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
#define __align__(n) alignas(n)
struct Dim3 { unsigned x; };
static Dim3 threadIdx = {0}, blockDim = {1};
static inline void __syncthreads() {}
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static long long clock64() { static long long t = 0; return ++t; }
using std::isinf;
float pw_plane[1 << 16];
#include "place_wave.cu"
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernel source compiled for the host, loaded."""
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
    # The record is 16-byte aligned: its size rounds the fields up to 16.
    assert so.place_wave_inv_size() == -(-ctypes.sizeof(GangInv) // 16) * 16 <= pwm.INV_BYTES
    return so


@pytest.fixture(scope="module")
def host_kernel(host_lib):
    fn = host_lib.place_wave_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p] + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int

    def launch(args, smem, profile=False):
        assert fn(ctypes.byref(args), None, smem, int(profile)) == 0

    return launch


def _host_vs_plain(host_kernel, snap, batch, okg_np, plan=None, plane_words=None):
    return _launch_vs_plain(host_kernel, snap, batch, okg_np, "cpu", plan, plane_words)


def test_kernel_source_on_host_with_pins(host_kernel):
    rg, rs, batch = pinned_bench_small()
    _host_vs_plain(host_kernel, rs, batch, np.zeros(len(rg), bool))


def test_kernel_source_on_host_domain_sums_equal_plain(host_kernel):
    want, seg = _domain_tables_vs_plain(host_kernel, "cpu")
    n = seg.shape[1]
    rev = {lv: _domain_sum(f.flip(0), seg[lv].flip(0), n)[: w.shape[0]] for lv, (f, w) in want.items()}
    assert any(not torch.equal(rev[lv], w) for lv, (_, w) in want.items()), (
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
    """The carry in global memory with every walk staged in many chunks."""
    gangs, pods, snap = SCENARIOS[name](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    _host_vs_plain(host_kernel, snap, batch, np.zeros(len(gangs), bool),
                   plane_words=min_plane_words(batch))


def test_kernel_source_on_host_spread_seeds(host_kernel):
    snap, batch = spread_seeded_batch()
    for plane_words in (None, min_plane_words(batch)):
        _host_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                       plane_words=plane_words)


@pytest.mark.parametrize("staging", ["whole", "chunked"])
@pytest.mark.parametrize("case", ["half_full", "clipped", "spread", "pinned"])
def test_kernel_source_on_host_pruned_wave(host_kernel, case, staging):
    """The fused B3: gather through cand_idx, solve on the candidate axis,
    scatter back into the fleet carry, remap assigned to fleet ordinals."""
    label, snap, batch, plan = next(c for c in pruned_cases() if c[0] == case)
    words = min_plane_words(batch) if staging == "chunked" else None
    want = _host_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                          plan, words)
    # Candidate rows changed only where the solve placed pods; the rest of
    # the fleet carry passes through untouched.
    untouched = np.setdiff1d(np.arange(snap.capacity.shape[0]), plan.idx)
    assert np.array_equal(want[3].numpy()[untouched], snap.free[untouched].astype(np.float32))
    placed = want[0][want[0] >= 0].numpy()
    assert placed.size and np.isin(placed, plan.idx).all()
    if case == "half_full":
        assert plan.idx.min() >= plan.fleet_pad // 2, "candidate ordinals equal fleet ordinals"


# ---- redesign cases: unread tables, staging chunks, the prologue -------------


def min_plane_words(batch):
    """The fewest shared words the wrapper takes for this batch: one node
    position of the widest walk per chunk."""
    r, mg, ms = batch.group_req.shape[2], batch.group_req.shape[1], batch.set_member.shape[1]
    return r + mg + ms + 3


def _nondyadic_batch():
    gangs, pods, snap = SCENARIOS["nondyadic"](PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    return batch, snap


def partly_active_batch():
    """Non-dyadic gangs with the block pack, the rack-packed workers and (base
    gangs) the routers preferring a rack, where the routers also require a
    block: the block pack's nested pass reads the rack set (narrower) but
    not the routers' (same level). Half the gangs keep their sets, a quarter have
    no valid set, a quarter require no level and keep only preferences."""
    batch, snap = _nondyadic_batch()
    req = np.array(batch.set_req_level)
    valid = np.array(batch.set_valid)
    routers = valid[:, 2]
    assert routers.any() and (req[routers, 2] == -1).all()
    assert (np.asarray(batch.set_pref_level)[routers, 2] >= 0).all()
    req[routers, 2] = 1
    g = req.shape[0]
    valid[g // 2 : 3 * g // 4] = False
    req[3 * g // 4 :] = -1
    return batch._replace(set_req_level=req, set_valid=valid), snap


def _reads_a_level(batch, gi):
    return bool(((np.asarray(batch.set_req_level[gi]) >= 0) & np.asarray(batch.set_valid[gi])).any())


def check_table_cycles(batch, snap, prof):
    """Tables are built for exactly the gangs a nested pass reads them for:
    0 cycles in the table section for every gang whose sets require no
    level (or that no nested pass reads), some for the others."""
    col = pwm.SECTIONS.index("tables + feas2")
    levels = snap.node_domain_id.shape[0]
    reads = [bool(table_columns(batch, gi, levels)) for gi in range(batch.gang_valid.shape[0])]
    assert any(reads) and not all(reads)
    for gi, r in enumerate(reads):
        if not _reads_a_level(batch, gi):
            assert not r
        assert (prof[gi, col] > 0) == r, f"gang {gi}: table cycles {prof[gi, col]}"


def test_kernel_source_on_host_without_valid_sets(host_kernel):
    batch, snap = partly_active_batch()
    g = batch.gang_valid.shape[0]
    none = batch._replace(set_valid=np.zeros_like(batch.set_valid))
    _, keep = _host_vs_plain_profiled(host_kernel, snap, none)
    assert not keep["prof"][:g, pwm.SECTIONS.index("tables + feas2")].any()
    assert not keep["prof"][:g, pwm.SECTIONS.index("stage-1 walks")].any()
    assert g // 4 > 0 and not bool(np.asarray(batch.set_valid[g // 2 : 3 * g // 4]).any())


def test_kernel_source_on_host_preferred_level_without_required(host_kernel):
    batch, snap = partly_active_batch()
    pref_only = batch._replace(set_req_level=np.full_like(batch.set_req_level, -1))
    assert (np.asarray(pref_only.set_pref_level) >= 0).any()
    want, keep = _host_vs_plain_profiled(host_kernel, snap, pref_only)
    assert bool(want[1].any())
    assert not keep["prof"][:, pwm.SECTIONS.index("tables + feas2")].any()
    assert keep["prof"][:-1, pwm.SECTIONS.index("stage-1 walks")].any()


def test_kernel_source_on_host_partly_active_nested(host_kernel):
    batch, snap = partly_active_batch()
    want, keep = _host_vs_plain_profiled(host_kernel, snap, batch)
    assert bool(want[1].any())
    inv = gang_records(keep["ginv"], batch.gang_valid.shape[0])
    act = np.array(inv[0].active2).reshape(pwm.MS_MAX, pwm.MS_MAX)
    assert act[0, 1] and not act[0, 2], "the block pack reads the rack set, not the routers"
    check_table_cycles(batch, snap, keep["prof"].numpy())


@pytest.mark.parametrize("extra_words", [0, 5, 61])
def test_kernel_source_on_host_chunked_walks(host_kernel, extra_words):
    """Walks staged a few node positions at a time on non-dyadic free
    capacity: every chunk boundary falls inside some domain, whose running
    sum crosses it in node order."""
    batch, snap = _nondyadic_batch()
    words = min_plane_words(batch) + extra_words
    _host_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                   plane_words=words)


def _host_vs_plain_profiled(host_kernel, snap, batch):
    return _launch_vs_plain(host_kernel, snap, batch, np.zeros(batch.gang_valid.shape[0], bool),
                            "cpu", profile=True)


class GangInv(ctypes.Structure):
    """Mirror of `struct PwGangInv` in csrc/place_wave.cu (same order)."""

    _MG, _MS, _L, _R = pwm.MG_MAX, pwm.MS_MAX, pwm.L_MAX, pwm.R_MAX
    _fields_ = [
        ("req", ctypes.c_float * (_MG * _R)), ("demand", ctypes.c_float * (_MS * _R)),
        ("joint_need", ctypes.c_float * _MS), ("total", ctypes.c_int * _MG),
        ("required", ctypes.c_int * _MG), ("order", ctypes.c_int * _MG),
        ("req_level", ctypes.c_int * _MS), ("pref_level", ctypes.c_int * _MS),
        ("pinned", ctypes.c_int * _MS), ("valid0", ctypes.c_int), ("depends_on", ctypes.c_int),
        ("spread_level", ctypes.c_int), ("spread_family", ctypes.c_int),
        ("table_levels", ctypes.c_int),
        ("gvalid", ctypes.c_uint8 * _MG), ("member", ctypes.c_uint8 * (_MS * _MG)),
        ("svalid", ctypes.c_uint8 * _MS), ("homogeneous", ctypes.c_uint8 * _MS),
        ("need_table", ctypes.c_uint8 * _MS), ("overlap", ctypes.c_uint8 * (_MS * _MS)),
        ("active2", ctypes.c_uint8 * (_MS * _MS)), ("memb_bits", ctypes.c_uint8 * _MG),
        ("s_ng", ctypes.c_uint8 * _MS), ("s_grp", ctypes.c_uint8 * (_MS * _MG)),
        ("s_tcol", ctypes.c_uint8 * (_MS * _MG)), ("tab_ng", ctypes.c_uint8 * _L),
        ("tab_grp", ctypes.c_uint8 * (_L * _MG)),
    ]


def gang_records(ginv, g):
    raw = ginv.cpu().numpy().tobytes()
    size = ctypes.sizeof(GangInv)
    return [GangInv.from_buffer_copy(raw[k * pwm.INV_BYTES : k * pwm.INV_BYTES + size])
            for k in range(g)]


def test_gang_record_mirrors_the_cuda_source():
    src = (build.CSRC / "place_wave.cu").read_text()
    body = re.search(r"struct __align__\(16\) PwGangInv \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.sub(r"\[.*", "", x).strip()
                      for x in re.sub(r"^\w+\s+", "", decl).split(",")]
    assert names == [f for f, _ in GangInv._fields_]


def test_sections_mirror_the_cuda_source():
    """SECTIONS names the profiled instantiation's PW_SEC_* columns, in
    order, and every column is one the kernel marks."""
    src = (build.CSRC / "place_wave.cu").read_text()
    cols = {m[0]: int(m[1]) for m in re.findall(r"#define (PW_SEC_\w+) (\d+)", src)}
    nsec = int(re.search(r"#define PW_NSEC (\d+)", src).group(1))
    assert sorted(cols.values()) == list(range(nsec)) and nsec == len(pwm.SECTIONS)
    for name in cols:
        assert re.search(rf"prof\.mark\({name}\)|, {name}[,)]", src), f"{name} is never marked"


def _seq32(values):
    acc = np.float32(0.0)
    for x in values:
        acc = np.float32(acc + np.float32(x))
    return acc


def test_prologue_invariants_equal_numpy(host_kernel):
    """The prologue's record of every gang against the same invariants
    computed here: member2, demand and joint_need summed over groups in index
    order, homogeneous, overlap, each nested pass's active2, the ok_global
    gate, which feasibility rows and table levels are read, and the slot
    columns of each set."""
    batch, snap = partly_active_batch()
    g, mg, r = batch.group_req.shape
    ms, levels = batch.set_member.shape[1], snap.node_domain_id.shape[0]
    rng = np.random.default_rng(3)
    okg = rng.random(g) < 0.5
    dg = np.where(rng.random(g) < 0.5, rng.integers(0, g, g), -1).astype(np.int32)
    batch = batch._replace(depends_global=dg)
    _, keep = _launch_vs_plain(host_kernel, snap, batch, okg, "cpu", profile=True)
    inv = gang_records(keep["ginv"], g)
    M, S = pwm.MG_MAX, pwm.MS_MAX
    for gi, rec in enumerate(inv):
        req = np.asarray(batch.group_req[gi], np.float32)
        required = np.asarray(batch.group_required[gi])
        member = np.asarray(batch.set_member[gi], bool)
        m2 = member & np.asarray(batch.group_valid[gi], bool)[None, :]
        lvl = np.asarray(batch.set_req_level[gi])
        sval = np.asarray(batch.set_valid[gi], bool)
        got = lambda f, shape: np.array(getattr(rec, f)).reshape(shape)  # noqa: E731
        assert rec.valid0 == bool(batch.gang_valid[gi] and (dg[gi] < 0 or okg[dg[gi]]))
        assert np.array_equal(got("req", (M, pwm.R_MAX))[:mg, :r], req)
        for s in range(ms):
            dem = [_seq32(np.float32(req[k, c]) * np.float32(required[k] * m2[s, k])
                          for k in range(mg)) for c in range(r)]
            assert np.array_equal(got("demand", (S, pwm.R_MAX))[s, :r], np.array(dem, np.float32))
            assert got("joint_need", S)[s] == _seq32(np.float32(required[k]) * m2[s, k]
                                                     for k in range(mg))
            spread = req[m2[s]].max(axis=0) - req[m2[s]].min(axis=0) if m2[s].any() else None
            homog = spread is not None and bool((spread.astype(np.float32) <= np.float32(1e-6)).all())
            assert got("homogeneous", S)[s] == homog
            assert list(got("s_grp", (S, M))[s, : got("s_ng", S)[s]]) == np.flatnonzero(m2[s]).tolist()
            for s2 in range(ms):
                ov = bool((member[s] & member[s2]).any())
                assert got("overlap", (S, S))[s, s2] == ov
                act = sval[s] and lvl[s] >= 0 and sval[s2] and lvl[s2] > lvl[s] and ov
                assert got("active2", (S, S))[s, s2] == act
        cols = table_columns(batch, gi, levels)
        assert rec.table_levels == sum(1 << lv for lv in cols)
        for lv, groups in cols.items():
            assert list(got("tab_grp", (pwm.L_MAX, M))[lv, : rec.tab_ng[lv]]) == groups
        bits = [sum(1 << s for s in range(ms) if member[s, k]) for k in range(mg)]
        assert list(got("memb_bits", M)[:mg]) == bits


# ---- B5: the stacked launch and the portfolio select -------------------------

STACK_CASES = ["bench_spread", "binpack_trap", "contended", "gated"]


def stack_case(case):
    """(snapshot, batch, ok_global): a scenario of the corpus with every gang
    in one batch, or ("gated") the scaled gangs of a bench backlog gated by
    a seeded cross-wave bitmap."""
    if case == "gated":
        gangs, pods, snap = _bench(PORT, n=(12, 8, 10))
        gidx = {g.name: i for i, g in enumerate(gangs)}
        scaled = [g for g in gangs if g.base_podgang_name is not None]
        batch, _ = PORT.encode_gangs(scaled, pods, snap, global_index_of=gidx)
        return snap, batch, np.random.default_rng(11).random(len(gangs)) < 0.6
    gangs, pods, snap = SCENARIOS[case](PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    batch, _ = PORT.encode_gangs(gangs, pods, snap, global_index_of=gidx)
    return snap, batch, np.zeros(len(gangs), bool)


def stack_rows(k):
    """k weight rows of the population, odd rows worst-fit; for k = 1 the
    worst-fit row alone."""
    pop = params_population(max(k, 2))
    return torch.as_tensor(np.array(pop[1:2] if k == 1 else pop[:k]))


def _card_stacked_launch(args, smem, select):
    fn = build.load("place_wave").place_wave_stacked_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p] + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    assert fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream, smem, int(select)) == 0
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def host_stacked(host_lib):
    fn = host_lib.place_wave_stacked_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p] + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int

    def launch(args, smem, select):
        assert fn(ctypes.byref(args), None, smem, int(select)) == 0

    return launch


def _stacked_vs_plain(launch, snap, batch, okg_np, dev, pstack, select=True, plane_words=None):
    """One stacked launch (the kernel on the card or compiled for the host)
    against the plain versions, exactly: every row against
    stacked_solve_ref; with `select` the winner, its rows, the carry it
    leaves in `free`, ok_global and the objectives against
    portfolio_select_ref, and without it `free` and ok_global untouched.
    Returns the plain rows and the plain select."""
    okg = torch.as_tensor(okg_np, device=dev)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    tb = batch_to(batch, dev)
    pstack = pstack.to(dev)
    okg_k = okg.clone()
    args, smem, out, _keep = pwm.build_args(
        free, cap, sched, ndid, tb, None, okg_k, pwm.domain_index(ndid.cpu(), dev),
        plane_words=plane_words, params_stack=pstack, select=select,
    )
    launch(args, smem, select)
    free0 = _node_tensors(snap, dev)[0]
    rows = stacked_solve_ref(free0, cap, sched, ndid, tb, pstack, okg)
    sel = portfolio_select_ref(*rows, tb, okg.clone())
    got = (out["assigned"], out["ok"], out["score"], out["free_after"])
    for name, a, b in zip(FIELDS, got, rows):
        assert torch.equal(a, b), f"{name}: stacked kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    if not select:
        assert torch.equal(free, free0) and torch.equal(okg_k, okg), "a stacked row wrote the carry"
        return rows, sel
    got = (out["win_assigned"], out["win_ok"], out["win_score"], free, okg_k, out["winner"],
           out["objectives"])
    for name, a, b in zip(FIELDS + ("winner", "objectives"), got, sel):
        assert torch.equal(a, b), f"select {name}: kernel != plain"
    return rows, sel


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("staging", ["whole", "chunked"])
@pytest.mark.parametrize("case", STACK_CASES)
def test_kernel_source_on_host_stacked_and_select(host_stacked, case, staging, k):
    snap, batch, okg = stack_case(case)
    words = min_plane_words(batch) if staging == "chunked" else None
    rows, sel = _stacked_vs_plain(host_stacked, snap, batch, okg, "cpu", stack_rows(k),
                                  plane_words=words)
    if case == "binpack_trap" and k > 1:
        assert not torch.equal(rows[1][0], rows[1][1]), "the worst-fit row admits what best-fit does"
        assert int(sel[5]) == 1, "the trap's winner is the worst-fit row"


def test_kernel_source_on_host_stacked_without_select(host_stacked):
    snap, batch, okg = stack_case("gated")
    _stacked_vs_plain(host_stacked, snap, batch, okg, "cpu", stack_rows(4), select=False)


def test_kernel_source_on_host_rows_equal_single_launches(host_kernel, host_stacked):
    """Row k of the stacked launch equals one place_wave launch under row k's
    weights, bit for bit (the contract the JAX package pins for its
    stacked solve)."""
    snap, batch, okg = stack_case("bench_spread")
    pstack = stack_rows(4)
    rows, _ = _stacked_vs_plain(host_stacked, snap, batch, okg, "cpu", pstack, select=False)
    tb = batch_to(batch, "cpu")
    for k in range(pstack.shape[0]):
        free, cap, sched, ndid = _node_tensors(snap, "cpu")
        args, smem, out, _ = pwm.build_args(free, cap, sched, ndid, tb, params_row(pstack[k]),
                                            torch.as_tensor(okg), pwm.domain_index(ndid, "cpu"))
        host_kernel(args, smem)
        for name, a, b in zip(FIELDS, (out["assigned"], out["ok"], out["score"], free), rows):
            assert torch.equal(a, b[k]), f"row {k} {name}: stacked != single launch"


@pytest.mark.parametrize("kind", ["single", "stacked"])
@pytest.mark.parametrize("case", ["bench_spread", "spread_pack"])
def test_kernel_source_on_host_reused_buffers_after_reset_equal_fresh(host_kernel, host_stacked,
                                                                       kind, case):
    """A prepared launch (solver/warm.py's launch cache) keeps one set of
    buffers from replay to replay and zeroes pwm.LAUNCH_ZEROED at the head
    of each. Two launches on one set of buffers, reset before the second,
    each equal a launch on fresh buffers; without the reset a third reads
    the spread family rows the earlier ones marked, and differs."""
    gangs, pods, snap = SCENARIOS[case](PORT)
    batch, _ = PORT.encode_gangs(gangs, pods, snap)
    assert batch.spread_level is not None
    tb = batch_to(batch, "cpu")
    stacked = kind == "stacked"
    pstack = stack_rows(2) if stacked else None

    def prepared():
        free, cap, sched, ndid = _node_tensors(snap, "cpu")
        built = pwm.build_args(free, cap, sched, ndid, tb, None if stacked else SolverParams(),
                               None, pwm.domain_index(ndid, "cpu"), params_stack=pstack)
        return free, free.clone(), built

    def launch(free, free0, built):
        args, smem, out, _ = built
        free.copy_(free0)
        if stacked:
            host_stacked(args, smem, False)
        else:
            host_kernel(args, smem)
        after = out["free_after"] if stacked else free
        return [t.clone() for t in (out["assigned"], out["ok"], out["score"], after)]

    want = launch(*prepared())
    reused = prepared()
    got = [launch(*reused)]
    pwm.zero_launch_state(reused[2][3])
    got.append(launch(*reused))
    for run, planes in enumerate(got):
        for name, a, b in zip(FIELDS, planes, want):
            assert torch.equal(a, b), f"launch {run} on reused buffers: {name} != a fresh launch"
    stale = launch(*reused)
    assert any(not torch.equal(a, b) for a, b in zip(stale, want)), (
        "the case does not show the family rows an earlier launch left"
    )


def test_stacked_wrapper_refuses_a_candidate_plan():
    _, snap, batch, plan = pruned_cases()[0]
    pt = plan.tensors("cpu")
    tb = batch_to(plan.gather_batch(batch), "cpu")
    free = torch.as_tensor(snap.free, dtype=torch.float32)
    rest = (pt.capacity, pt.schedulable, pt.node_domain_id, tb)
    for k in (2, 4):
        with pytest.raises(ValueError, match="dense"):
            pwm.build_args(free, *rest, None, None, pt.domains, pt.cand_idx, plan.count,
                           params_stack=stack_rows(k), select=k == 4)


def test_wrapper_fills_stacked_args():
    free, cap, sched, ndid, tb, dom = _args_for("contended")
    n, r = free.shape
    g, mg, _ = tb.group_req.shape
    okg = torch.zeros(g, dtype=torch.bool)
    single = pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), okg, dom)[3]
    args, smem, out, keep = pwm.build_args(free, cap, sched, ndid, tb, None, okg, dom,
                                           params_stack=stack_rows(4), select=True)
    assert args.K == 4 and args.params_stack == keep["params_stack"].data_ptr()
    assert args.free_io == free.data_ptr() and args.ok_global == okg.data_ptr()
    assert out["assigned"].shape == (4, g, tb.pod_group.shape[1]) and out["ok"].shape == (4, g)
    assert out["free_after"].shape == (4, n, r) and not out["ok"].any()
    assert out["winner"].shape == () and out["objectives"].shape == (4,)
    for name in ("tables", "agg", "feas2", "nword", "entries", "undo", "norm_free"):
        assert keep[name].numel() == 4 * single[name].numel(), name
    assert keep["ginv"].numel() == single["ginv"].numel(), "one prologue for every row"
    with pytest.raises(ValueError, match="params_stack"):
        pwm.build_args(free, cap, sched, ndid, tb, None, okg, dom,
                       params_stack=torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="select needs a weight stack"):
        pwm.build_args(free, cap, sched, ndid, tb, SolverParams(), okg, dom, select=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case", STACK_CASES)
def test_stacked_kernel_equals_plain(cuda, case):
    snap, batch, okg = stack_case(case)
    _stacked_vs_plain(_card_stacked_launch, snap, batch, okg, cuda, stack_rows(4))
    _stacked_vs_plain(_card_stacked_launch, snap, batch, okg, cuda, stack_rows(2), select=False)


@pytest.mark.gpu
def test_stacked_rows_equal_single_launches_on_card(cuda):
    snap, batch, okg = stack_case("bench_spread")
    pstack = stack_rows(4)
    tb = batch_to(batch, cuda)
    dom = pwm.domain_index(snap.node_domain_id, cuda)
    okg_t = torch.as_tensor(okg, device=cuda)
    free, cap, sched, ndid = _node_tensors(snap, cuda)
    rows = pwm.place_wave_stacked(free, cap, sched, ndid, tb, pstack.to(cuda), okg_t,
                                  domains=dom, select=False)
    for k in range(pstack.shape[0]):
        free, cap, sched, ndid = _node_tensors(snap, cuda)
        single = pwm.place_wave(free, cap, sched, ndid, tb, params_row(pstack[k]), okg_t.clone(),
                                domains=dom)
        torch.cuda.synchronize()
        for name, a, b in zip(FIELDS, single, rows):
            assert torch.equal(a, b[k]), f"row {k} {name}: stacked != single launch"


@pytest.mark.gpu
def test_stacked_select_is_deterministic_over_20_launches(cuda):
    snap, batch, okg = stack_case("contended")
    tb = batch_to(batch, cuda)
    dom = pwm.domain_index(snap.node_domain_id, cuda)
    pstack = stack_rows(4).to(cuda)
    runs = []
    for _ in range(20):
        free, cap, sched, ndid = _node_tensors(snap, cuda)
        okg_t = torch.as_tensor(okg, device=cuda)
        out = pwm.place_wave_stacked(free, cap, sched, ndid, tb, pstack, okg_t, domains=dom,
                                     select=True)
        runs.append([x.clone() for x in out])
    torch.cuda.synchronize()
    for run in runs[1:]:
        for name, a, b in zip(FIELDS + ("winner", "objectives"), run, runs[0]):
            assert torch.equal(a, b), f"{name} differs between launches"


# ---- B4: the scan launch -------------------------------------------------------

SCAN_CASES = ["dense", "gated", "spread", "pruned", "pruned_clipped"]
SCAN_OUT = ("assigned", "ok", "placement_score", "free_in", "okg_in", "free_after", "ok_global")


def _spread_steps():
    """bench_spread's gangs in three waves of one shape, its replicas spread
    across zones, then the first wave once more: the family rows must start
    empty at every step, or the repeat would see the rows its families left
    the first time."""
    gangs, pods, snap = SCENARIOS["bench_spread"](PORT)
    gidx = {g.name: i for i, g in enumerate(gangs)}
    shape = tuple(max(_padded_shape(g)[k] for g in gangs) for k in range(3))
    size = -(-len(gangs) // 3)
    steps = [PORT.encode_gangs(gangs[k : k + size], pods, snap, max_groups=shape[0],
                               max_sets=shape[1], max_pods=shape[2], pad_gangs_to=size,
                               global_index_of=gidx)[0]
             for k in range(0, len(gangs), size)]
    assert len(steps) == 3 and all(s.spread_level is not None for s in steps)
    steps.append(steps[0])
    steps.append(GangBatch(*(None if x is None else np.zeros_like(x) for x in steps[0])))
    return snap, steps, np.zeros(len(gangs), bool)


def _padded_shape(g):
    mg, ms, mp = gang_shape(g)
    return mg, max(ms, 1), next_pow2(mp)


def scan_case(case):
    """(snapshot, steps [port GangBatch of numpy], ok_global, plans or None):
    a chunk whose steps share one shape, ending in a null wave where the
    drain's padding would put one — "dense" and "pruned": a base gang in one
    step gates its scaled gangs in the next, admitted and rejected
    (test_torch_scan.scan_chunk); "gated": the same under a seeded entering
    ok_global; "spread": the replica-spread planes in every step;
    "pruned_clipped": plans that clip the candidate budget."""
    from test_torch_scan import _port_stacked, scan_chunk

    if case == "spread":
        snap, steps, okg = _spread_steps()
        return snap, steps, okg, None
    rs, ref_steps, rg = scan_chunk()
    stacked = _port_stacked(ref_steps)
    steps = [GangBatch(*(None if x is None else x[w].numpy() for x in stacked))
             for w in range(len(ref_steps))]
    okg = np.zeros(len(rg), bool)
    if case == "gated":
        okg = np.random.default_rng(5).random(len(rg)) < 0.5
    plans = None
    if case.startswith("pruned"):
        cfg = PruningConfig(enabled=True, max_candidates=63 if case == "pruned" else 40,
                            min_fleet=16, min_pad=64)
        plans = [plan_candidates(rs, b, cfg) for b in steps[:-1]] + [None]
        assert all(p is not None and p.pad == 64 for p in plans[:-1])
        assert case == "pruned" or any(p.clipped for p in plans[:-1])
    return rs, steps, okg, plans


def _pruned_stack(plans, steps, snap, dev):
    """The pruned scan's stacked inputs; a None plan is a null step whose
    gather map points past the fleet everywhere."""
    from grove_tpu_torch.solver.pruning import stack_plans

    real = [(p, b) for p, b in zip(plans, steps) if p is not None]
    sp = stack_plans([p for p, _ in real], [b for _, b in real], "cpu")
    n_null = len(plans) - len(real)
    nf = snap.capacity.shape[0]

    def pad(t, fill=0):
        return torch.cat([t, torch.full((n_null,) + tuple(t.shape[1:]), fill, dtype=t.dtype)])

    cand = pad(sp.cand_idx, nf)
    ndid = pad(sp.node_domain_id)
    tb = GangBatch(*(None if x is None else pad(x) for x in sp.batch))
    return (cand.to(dev), pad(sp.capacity).to(dev), pad(sp.schedulable).to(dev), ndid.to(dev),
            batch_to(tb, dev), pwm.domain_index_stacked(ndid, dev))


def _scan_vs_plain(launch, case, dev, retain=True, plane_words=None):
    """One scan launch (the kernel on the card or compiled for the host)
    against the plain scan, exactly, on every output; returns the plain
    outputs and the case."""
    from grove_tpu_torch.solver.reference import scan_pruned_solve_ref, scan_solve_ref

    snap, steps, okg_np, plans = scan_case(case)
    free, cap, sched, ndid = _node_tensors(snap, dev)
    okg = torch.as_tensor(okg_np, device=dev)
    if plans is None:
        tb = batch_to(stack_batches(steps), dev)
        node = (cap, sched, ndid)
        domains, cand = pwm.domain_index(ndid.cpu(), dev), None
        want = scan_solve_ref(free.clone(), cap, sched, ndid, tb, SolverParams(), okg.clone(),
                              retain)
    else:
        cand, *node, tb, domains = _pruned_stack(plans, steps, snap, dev)
        want = scan_pruned_solve_ref(free.clone(), cand, *node, tb, SolverParams(), okg.clone(),
                                     retain)
    okg_k = okg.clone()
    args, smem, out, _keep = pwm.build_scan_args(free, *node, tb, SolverParams(), okg_k, domains,
                                                 cand, retain, plane_words=plane_words)
    launch(args, smem)
    got = (out["assigned"], out["ok"], out["score"], out["free_in"], out["okg_in"], free, okg_k)
    if dev != "cpu":
        torch.cuda.synchronize()
    for name, a, b in zip(SCAN_OUT, got, want):
        if b is None:
            assert a is None, name
            continue
        assert torch.equal(a, b), f"scan {name}: kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    ok = want[1].cpu()
    assert ok[:-1].any(dim=1).all() and not ok[-1].any(), "every step but the null one admits"
    if retain:
        assert torch.equal(want[3][-1], want[5]), "the null step moved the carry"
    return want, (snap, steps, okg_np, plans)


def _card_scan_launch(args, smem):
    fn = build.load("place_wave").place_wave_scan_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    assert fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream, smem) == 0
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def host_scan(host_lib):
    fn = host_lib.place_wave_scan_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, smem):
        assert fn(ctypes.byref(args), None, smem) == 0

    return launch


@pytest.mark.parametrize("staging", ["whole", "chunked"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_kernel_source_on_host_scan_equals_plain(host_scan, case, staging):
    words = None
    if staging == "chunked":
        words = min_plane_words(batch_to(scan_case(case)[1][0], "cpu"))
    _scan_vs_plain(host_scan, case, "cpu", plane_words=words)


def test_kernel_source_on_host_scan_without_retain(host_scan):
    _scan_vs_plain(host_scan, "gated", "cpu", retain=False)


def _steps_vs_single_launches(launch_scan, launch_single, case, dev):
    """Every step of the scan equals a single place_wave launch on the carry
    that step entered with, bit for bit."""
    want, (snap, steps, okg_np, plans) = _scan_vs_plain(launch_scan, case, dev)
    _, cap, sched, ndid = _node_tensors(snap, dev)
    for w, batch in enumerate(steps[:-1]):
        free, okg = want[3][w].clone().to(dev), want[4][w].clone().to(dev)
        node, extra = (cap, sched, ndid), (None, None)
        domains = pwm.domain_index(ndid.cpu(), dev)
        if plans is not None:
            pt = plans[w].tensors("cpu")
            node = tuple(t.to(dev) for t in (pt.capacity, pt.schedulable, pt.node_domain_id))
            extra = (pt.cand_idx.to(dev), plans[w].count)
            domains = pwm.domain_index(pt.node_domain_id, dev)
            batch = plans[w].gather_batch(batch)
        args, smem, out, _ = pwm.build_args(free, *node, batch_to(batch, dev), SolverParams(),
                                            okg, domains, *extra)
        launch_single(args, smem)
        nxt = want[5] if w == len(steps) - 2 else want[3][w + 1]
        single = (out["assigned"], out["ok"], out["score"], free)
        for name, a, b in zip(FIELDS, single, (want[0][w], want[1][w], want[2][w], nxt)):
            assert torch.equal(a, b.to(dev)), f"step {w} {name}: scan != single launch"


@pytest.mark.parametrize("case", ["gated", "spread", "pruned"])
def test_kernel_source_on_host_scan_steps_equal_single_launches(host_scan, host_kernel, case):
    _steps_vs_single_launches(host_scan, host_kernel, case, "cpu")


def test_wrapper_fills_scan_args():
    snap, steps, okg_np, plans = scan_case("pruned")
    free, cap, sched, ndid = _node_tensors(snap, "cpu")
    okg = torch.as_tensor(okg_np)
    w_len = len(steps)
    tb = batch_to(stack_batches(steps), "cpu")
    g, mg, r = steps[0].group_req.shape
    mp = steps[0].pod_group.shape[1]
    nf = free.shape[0]
    args, smem, out, keep = pwm.build_scan_args(free, cap, sched, ndid, tb, SolverParams(), okg,
                                                pwm.domain_index(ndid, "cpu"), retain=True)
    assert args.W == w_len and smem == pwm.PLANE_BYTES
    assert (args.st_group_req, args.st_pod_group, args.st_gang_valid) == (g * mg * r, g * mp, g)
    assert (args.st_capacity, args.st_dom_nodes, args.st_cand_idx) == (0, 0, 0)
    assert (args.st_assigned, args.st_ok, args.st_score) == (g * mp, g, g)
    assert (args.st_free_in, args.st_okg_in) == (nf * r, okg.shape[0])
    assert args.st_ginv == g * pwm.INV_BYTES and keep["ginv"].numel() == w_len * g * pwm.INV_BYTES
    assert args.st_reuse_nodes == 0 and args.reuse_nodes is None
    assert out["free_in"].shape == (w_len, nf, r) and out["okg_in"].shape == (w_len, okg.shape[0])
    assert out["assigned"].shape == (w_len, g, mp) and not out["ok"].any()
    assert args.group_req == tb.group_req.data_ptr() and args.cand_counts is None
    assert keep["carry"] is None, "a dense scan works on the fleet tensor itself"
    # Pruned: the node tensors and domain index are per step too.
    cand, *node, ptb, domains = _pruned_stack(plans, steps, snap, "cpu")
    args, _, out, keep = pwm.build_scan_args(free, *node, ptb, SolverParams(), None, domains,
                                             cand, retain=False)
    cp = cand.shape[1]
    assert (args.st_cand_idx, args.st_capacity, args.st_schedulable) == (cp, cp * r, cp)
    assert (args.st_node_domain_id, args.st_dom_count) == (ndid.shape[0] * cp, ndid.shape[0])
    assert args.st_dom_offsets == ndid.shape[0] * (cp + 1)
    assert keep["cand_counts"].tolist() == [p.count for p in plans[:-1]] + [0]
    assert args.free_in is None and args.okg_in is None and out["free_in"] is None
    assert keep["carry"].numel() == cp * r, "one candidate carry, reused by every step"
    with pytest.raises(ValueError, match="leading step axis"):
        pwm.build_scan_args(free, *node, ptb._replace(gang_valid=ptb.gang_valid[:2]),
                            SolverParams(), None, domains, cand)
    with pytest.raises(ValueError, match="not contiguous"):
        pwm.build_scan_args(free, *node, ptb._replace(pod_rank=ptb.pod_rank.transpose(1, 2)
                                                      .contiguous().transpose(1, 2)),
                            SolverParams(), None, domains, cand)


def test_wrapper_refuses_cpu_tensors_for_the_scan():
    snap, steps, okg_np, _ = scan_case("dense")
    free, cap, sched, ndid = _node_tensors(snap, "cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        pwm.place_wave_scan(free, cap, sched, ndid, batch_to(stack_batches(steps), "cpu"),
                            SolverParams(), domains=pwm.domain_index(ndid, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernel_equals_plain(cuda, case):
    _scan_vs_plain(_card_scan_launch, case, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["gated", "spread", "pruned"])
def test_scan_steps_equal_single_launches_on_card(cuda, case):
    _steps_vs_single_launches(_card_scan_launch, _card_launch, case, cuda)


@pytest.mark.gpu
def test_scan_drain_on_card_counts_one_launch_per_chunk(cuda):
    gangs, pods, snap = _bench(PORT, n=(18, 12, 15))
    cpu_bindings, cpu_stats = drain_backlog(gangs, pods, snap, wave_size=4, harvest="scan",
                                            device="cpu")
    pwm.reset_launches()
    bindings, stats = drain_backlog(gangs, pods, snap, wave_size=4, harvest="scan")
    launches = pwm.place_wave.variant_launches
    assert launches["scan"] == stats.scan_chunks > 0
    assert launches["dense"] == stats.waves - stats.scanned_waves
    assert bindings == cpu_bindings and np.array_equal(stats.free_after, cpu_stats.free_after)
    for f in ("dispatches", "device_roundtrips", "scan_chunks", "scanned_waves"):
        assert getattr(stats, f) == getattr(cpu_stats, f), f


# ---- B6: the sweep launch ------------------------------------------------------

SWEEP_CASES = ["dense", "spread"]


def sweep_case(case, k):
    """(snapshot, free_stack [W, N, R], steps, params_stack [K, 5]): a scan
    case's steps (its trailing null wave included), each from the carry the
    plain scan entered it with, as a scan drain's journal records them, and
    K weight rows (odd rows worst-fit)."""
    from grove_tpu_torch.solver.reference import scan_solve_ref

    snap, steps, okg_np, _ = scan_case(case)
    free, cap, sched, ndid = _node_tensors(snap, "cpu")
    entered = scan_solve_ref(free, cap, sched, ndid, batch_to(stack_batches(steps), "cpu"),
                             SolverParams(), torch.as_tensor(okg_np), True)[3]
    # The null wave's recorded free is zero, as the sweep pads a run.
    entered[-1] = 0
    return snap, entered.contiguous(), steps, stack_rows(k)


def _sweep_vs_plain(launch, case, k, dev, plane_words=None):
    """One sweep launch (the kernel on the card or compiled for the host)
    against stacked_scan_solve_ref, exactly; returns the plain outputs and
    the case."""
    from grove_tpu_torch.solver.reference import stacked_scan_solve_ref

    snap, free_stack, steps, pstack = sweep_case(case, k)
    _, cap, sched, ndid = _node_tensors(snap, dev)
    tb = batch_to(stack_batches(steps), dev)
    fs, pstack = free_stack.to(dev), pstack.to(dev)
    want = stacked_scan_solve_ref(fs, cap, sched, ndid, tb, pstack)
    fs_k = fs.clone()
    args, smem, out, _keep = pwm.build_sweep_args(fs_k, cap, sched, ndid, tb, pstack,
                                                  pwm.domain_index(ndid.cpu(), dev),
                                                  plane_words=plane_words)
    launch(args, smem)
    if dev != "cpu":
        torch.cuda.synchronize()
    for name, a, b in zip(("assigned", "ok", "placement_score"),
                          (out["assigned"], out["ok"], out["score"]), want):
        assert torch.equal(a, b), f"sweep {name}: kernel != plain at {torch.nonzero(a != b)[:8].tolist()}"
    assert torch.equal(fs_k, fs), "the sweep launch wrote its recorded free"
    ok = want[1].cpu()
    assert ok[:-1].any(dim=2).all() and not ok[-1].any(), "every wave but the null one admits"
    return want, (snap, free_stack, steps, pstack)


def _card_sweep_launch(args, smem):
    fn = build.load("place_wave").place_wave_sweep_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    assert fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream, smem) == 0
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def host_sweep(host_lib):
    fn = host_lib.place_wave_sweep_launch
    fn.argtypes = [ctypes.POINTER(pwm.PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def launch(args, smem):
        assert fn(ctypes.byref(args), None, smem) == 0

    return launch


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("staging", ["whole", "chunked"])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_kernel_source_on_host_sweep_equals_plain(host_sweep, case, staging, k):
    words = None
    if staging == "chunked":
        words = min_plane_words(batch_to(scan_case(case)[1][0], "cpu"))
    _sweep_vs_plain(host_sweep, case, k, "cpu", plane_words=words)


def _sweep_rows_vs_single_launches(launch_sweep, launch_single, case, dev):
    """Row (w, k) of the sweep launch equals a single place_wave launch of
    wave w from its recorded free under row k, bit for bit."""
    want, (snap, free_stack, steps, pstack) = _sweep_vs_plain(launch_sweep, case, 3, dev)
    _, cap, sched, ndid = _node_tensors(snap, dev)
    domains = pwm.domain_index(ndid.cpu(), dev)
    for w, batch in enumerate(steps):
        for k in range(pstack.shape[0]):
            free = free_stack[w].clone().to(dev)
            args, smem, out, _ = pwm.build_args(free, cap, sched, ndid, batch_to(batch, dev),
                                                params_row(pstack[k]), None, domains)
            launch_single(args, smem)
            for name, a, b in zip(FIELDS, (out["assigned"], out["ok"], out["score"]), want):
                assert torch.equal(a, b[w, k].to(dev)), f"row ({w}, {k}) {name}: sweep != single"


def test_kernel_source_on_host_sweep_rows_equal_single_launches(host_sweep, host_kernel):
    _sweep_rows_vs_single_launches(host_sweep, host_kernel, "spread", "cpu")


def test_wrapper_fills_sweep_args():
    snap, free_stack, steps, pstack = sweep_case("dense", 4)
    _, cap, sched, ndid = _node_tensors(snap, "cpu")
    tb = batch_to(stack_batches(steps), "cpu")
    w_len, n, r = free_stack.shape
    g, mg, _ = steps[0].group_req.shape
    mp = steps[0].pod_group.shape[1]
    dom = pwm.domain_index(ndid, "cpu")
    single = pwm.build_args(free_stack[0], cap, sched, ndid, batch_to(steps[0], "cpu"),
                            SolverParams(), None, dom)[3]
    args, smem, out, keep = pwm.build_sweep_args(free_stack, cap, sched, ndid, tb, pstack, dom)
    assert (args.W, args.K, args.T) == (w_len, 4, 0) and smem == pwm.PLANE_BYTES
    assert args.free_in == free_stack.data_ptr() and args.st_free_in == n * r
    assert (args.st_group_req, args.st_pod_group, args.st_gang_valid) == (g * mg * r, g * mp, g)
    assert (args.st_capacity, args.st_dom_nodes, args.st_cand_idx) == (0, 0, 0)
    assert (args.st_assigned, args.st_ok, args.st_score) == (0, 0, 0), "rows by block"
    assert args.st_ginv == g * pwm.INV_BYTES and keep["ginv"].numel() == w_len * g * pwm.INV_BYTES
    assert args.st_okg_in == 0 and args.okg_in is None and args.ok_global is None
    assert out["assigned"].shape == (w_len, 4, g, mp) and out["ok"].shape == (w_len, 4, g)
    assert not out["ok"].any() and "free_after" not in out
    for name in ("tables", "agg", "feas2", "nword", "entries", "undo", "norm_free"):
        assert keep[name].numel() == w_len * 4 * single[name].numel(), name
    assert keep["carry"].numel() == w_len * 4 * n * r, "each block copies its step's free"
    with pytest.raises(ValueError, match="leading step axis"):
        pwm.build_sweep_args(free_stack[:2], cap, sched, ndid, tb, pstack, dom)
    with pytest.raises(ValueError, match="params_stack"):
        pwm.build_sweep_args(free_stack, cap, sched, ndid, tb, torch.zeros((4, 3)), dom)


def test_wrapper_refuses_cpu_tensors_for_the_sweep():
    snap, free_stack, steps, pstack = sweep_case("dense", 2)
    _, cap, sched, ndid = _node_tensors(snap, "cpu")
    with pytest.raises(ValueError, match="CUDA device only"):
        pwm.place_wave_stacked_scan(free_stack, cap, sched, ndid,
                                    batch_to(stack_batches(steps), "cpu"), pstack,
                                    domains=pwm.domain_index(ndid, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_sweep_kernel_equals_plain(cuda, case):
    _sweep_vs_plain(_card_sweep_launch, case, 3, cuda)


@pytest.mark.gpu
def test_sweep_rows_equal_single_launches_on_card(cuda):
    _sweep_rows_vs_single_launches(_card_sweep_launch, _card_launch, "spread", cuda)


# ---- resilience on the card: re-dispatch from retained carries ------------------


@pytest.mark.gpu
def test_redispatch_from_retained_carry_equals_original_on_card(cuda):
    """A wave re-dispatched (watchdog path) from its retained entering carry,
    with two successors already enqueued on the carry it produced, gives
    the original launch's verdicts at tolerance 0 and leaves the live carry
    — object and values — untouched."""
    from grove_tpu_torch.solver.drain import DrainStats, _WavePipeline, plan_waves
    from grove_tpu_torch.solver.warm import WarmPath

    gangs, pods, snap = _bench(PORT, n=(18, 12, 15))
    stats = DrainStats()
    eng = _WavePipeline(gangs=gangs, pods_by_name=pods, snapshot=snap, params=SolverParams(),
                        stats=stats, dev=cuda, warm_path=WarmPath(), retire_lag=None,
                        max_wave_retries=1)
    assert eng.retain_carries and not eng.donate
    for ws in plan_waves(gangs, 16)[:3]:
        eng.submit(ws, retire=False)
    torch.cuda.synchronize()
    live, okg = eng.free, eng.ok_g
    live_copy, okg_copy = live.clone(), okg.clone()
    rec = eng.inflight[0]
    first = [h.clone() for h in rec["host"]]
    free_in_copy = rec["free_in"].clone()
    eng.cancel_wave(rec)
    eng._redispatch(rec)
    rec["event"].synchronize()
    for a, b in zip(rec["host"], first):
        assert torch.equal(a, b)
    assert eng.free is live and torch.equal(live, live_copy) and torch.equal(eng.ok_g, okg_copy)
    assert torch.equal(rec["free_in"], free_in_copy)
    eng.flush()
    assert stats.wave_redispatches == 1 and stats.waves == 3


@pytest.mark.gpu
@pytest.mark.parametrize("harvest", ["scan", "pipeline"])
def test_retained_chunk_under_injected_harvest_timeout_equals_fault_free_on_card(cuda, harvest):
    """A B4 chunk launched with retain=True (faults armed) whose first wave's
    fetch is hit by an injected harvest timeout: that wave re-dispatches
    alone from the chunk's retained step carry, the chunk's other waves keep
    their fetch, and the bindings and free_after equal the fault-free run."""
    from grove_tpu_torch.faults import FaultInjector, SiteSpec
    from grove_tpu_torch.solver.drain import ScanConfig
    from grove_tpu_torch.solver.resilience import ResilienceConfig
    from grove_tpu_torch.solver.warm import WarmPath

    gangs, pods, snap = _bench(PORT, n=(18, 12, 15))
    kw = dict(wave_size=8, harvest=harvest, depth=2, scan=ScanConfig(max_scan_len=4))
    base, base_stats = drain_backlog(gangs, pods, snap, warm_path=WarmPath(), **kw)
    inj = FaultInjector({"solver.harvest": SiteSpec(kind="timeout", count=1)}, seed=0)
    pwm.reset_launches()
    got, stats = drain_backlog(gangs, pods, snap, warm_path=WarmPath(), faults=inj,
                               resilience=ResilienceConfig(enabled=True, max_wave_retries=1),
                               **kw)
    assert got == base
    assert np.array_equal(stats.free_after, base_stats.free_after)
    assert (stats.watchdog_timeouts, stats.wave_redispatches) == (1, 1)
    assert not stats.donated
    if harvest == "scan":
        assert stats.scan_chunks >= 1 and pwm.place_wave.variant_launches["scan"] >= 1
        assert pwm.place_wave.variant_launches["dense"] >= 1  # the re-dispatch


@pytest.mark.gpu
def test_plan_migrations_on_card_equals_plain(cuda):
    from grove_tpu_torch.bench import defrag_world
    from grove_tpu_torch.solver.defrag import plan_migrations
    from grove_tpu_torch.solver.warm import WarmPath

    topo, nodes, gangs, pods, _, _ = defrag_world(0.25)
    want = plan_migrations(nodes, topo, gangs, dict(pods), warm=WarmPath(),
                           max_moves=len(gangs), device="cpu")
    pwm.reset_launches()
    got = plan_migrations(nodes, topo, gangs, dict(pods), warm=WarmPath(),
                          max_moves=len(gangs))
    assert pwm.place_wave.variant_launches["dense"] == got.candidates_evaluated > 0
    assert [(m.gang, m.bindings) for m in got.moves] == [(m.gang, m.bindings) for m in want.moves]
    assert (got.pods_migrated, got.capacity_recovered) == (want.pods_migrated,
                                                           want.capacity_recovered)
