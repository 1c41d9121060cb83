"""The placement engine's entry points: batched all-or-nothing gang
bin-packing, one wave per call (grove_tpu/solver/core.py counterpart).

`solve_batch` dispatches on the device its tensors lie on: on a CUDA device it
launches the hand-written Hopper kernel (grove_tpu_torch/kernels/place_wave.py);
on the CPU — only when the caller asks for it with device="cpu" — it runs
the plain PyTorch version (solver/reference.py). There is no fallback between
the two: a CUDA batch the kernel does not take raises. Given a candidate plan
(solver/pruning.py) it solves the wave on the plan's candidate axis, inside
the same single launch on the card.

`stacked_solve_batch` solves one wave under K weight rows (B5, one stacked
launch on the card), and `solve` is the serving entry: a snapshot and a
batch, one solve or a portfolio of them, and the portfolio escalation
when a valid gang is rejected.

`scan_solve` and `scan_pruned_solve` solve W waves of one shape, each from
the carry the previous one left (B4, one scan launch on the card per call):
the drain's "scan" and "resident" harvests fuse each run of same-shape waves
into them.

`stacked_scan_solve` solves W journaled waves of one shape under K weight
rows, each wave from its own recorded free (B6, one launch on the card per
call): the tuning sweep batches each run of same-shape journaled waves
into it.

`sharded_solve` solves one wave node-sharded under a parallel/mesh.py
SolveLayout (B7, one cooperative launch on the card over the layout's
virtual shards; `sharded_solve_ref` on the CPU), and `sharded_solve_fn`
is its memoized entry per (donate, layout key), the launch cache's entry
on the CPU (on the card the cache captures B7 under the layout's key).
`solve(..., mesh=)` takes a layout, dense or pruned. Under a layout the
scans are B4 x B7 (`scan_solve(..., layout=)`, `scan_pruned_solve(...,
layout=)`; `scan_solve_fn(layout)` and `scan_pruned_solve_fn(layout)` are
their memoized entries) and a stacked solve over node shards is B5 x B7
(`stacked_dispatch(..., layout=)`, parallel/portfolio.py's portfolio mesh).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.reference import (
    apply_global_deps_ref,
    portfolio_select_ref,
    scan_pruned_solve_ref,
    scan_solve_ref,
    sharded_scan_pruned_solve_ref,
    sharded_scan_solve_ref,
    sharded_solve_ref,
    sharded_stacked_solve_ref,
    solve_batch_ref,
    solve_pruned_ref,
    stacked_scan_solve_ref,
    stacked_solve_ref,
)


class SolverParams(NamedTuple):
    """Score weights (Score plugin analog)."""

    w_tight: float = 1.0  # bin-pack: prefer nodes with less free capacity
    w_pref: float = 4.0  # preferred-domain bonus per matching pack-set
    w_reuse: float = 2.0  # gang locality: prefer nodes this gang already uses
    w_reserve: float = 8.0  # keep non-members out of committed pack domains
    w_spread: float = 1.5  # replica-spread repulsion (soft)


class SolveResult(NamedTuple):
    assigned: torch.Tensor  # i32 [G, MP] node index or -1
    ok: torch.Tensor  # bool [G] gang admitted whole
    placement_score: torch.Tensor  # f32 [G] quality in (0,1], 1.0 = optimal
    free_after: torch.Tensor  # f32 [N, R]
    # Updated global verdict bitmap (wave chaining): present iff the caller
    # passed ok_global.
    ok_global: torch.Tensor | None = None


class ScanSolveResult(NamedTuple):
    """W waves solved as one scan (core.py `ScanSolveResult`): the verdict
    planes gain a leading [W] axis; free_in/okg_in are each step's entering
    carry (present iff retain=True), free_after/ok_global the final one."""

    assigned: torch.Tensor  # i32 [W, G, MP] (fleet ordinals when pruned)
    ok: torch.Tensor  # bool [W, G]
    placement_score: torch.Tensor  # f32 [W, G]
    free_in: torch.Tensor | None  # f32 [W, N, R] entering fleet free per step
    okg_in: torch.Tensor | None  # bool [W, T] entering verdict bitmap per step
    free_after: torch.Tensor  # f32 [N, R]
    ok_global: torch.Tensor | None  # bool [T]


class StackedScanResult(NamedTuple):
    """W journaled waves under K configs (core.py `StackedScanResult`): the
    verdict planes gain leading [W, K] axes; no carry, no free_after."""

    assigned: torch.Tensor  # i32 [W, K, G, MP]
    ok: torch.Tensor  # bool [W, K, G]
    placement_score: torch.Tensor  # f32 [W, K, G]


def resolve_device(device=None) -> torch.device:
    """None means the card. A CUDA device without a card raises; only an
    explicit "cpu" selects the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: grove_tpu_torch runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions"
        )
    return dev


def to_device(x, device):
    """numpy array (or tensor) -> tensor on `device`. Host arrays bound for
    the card go through pinned memory without blocking: a copy from
    pageable memory would wait for the kernel already running, so uploading
    wave k+1 would wait for wave k."""
    device = torch.device(device)
    if torch.is_tensor(x):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def tensor_on(x, dtype, device):
    """`x` (numpy array, tensor or None) as a `dtype` tensor on `device`; a
    tensor already there is returned as is."""
    return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)


def batch_to(batch: GangBatch, device) -> GangBatch:
    """GangBatch of numpy arrays (or tensors) -> GangBatch of tensors on
    `device` (see to_device)."""
    return GangBatch(*(None if x is None else to_device(x, device) for x in batch))


def stack_on(params_stack, dev) -> torch.Tensor:
    """A weight stack (numpy, possibly read-only, or a tensor) as an f32
    tensor on `dev`."""
    if torch.is_tensor(params_stack):
        return params_stack.to(device=dev, dtype=torch.float32)
    return to_device(np.array(params_stack, dtype=np.float32), dev)


def solve_batch(
    free,
    capacity,
    schedulable,
    node_domain_id,
    batch: GangBatch,
    params: SolverParams | None = None,
    ok_global=None,
    *,
    device=None,
    domains=None,
    plan=None,
) -> SolveResult:
    """Sequentially commit every gang in the batch (priority = batch order).

    Array arguments may be numpy arrays or tensors; they are moved to
    `device` (None = the card). `ok_global` threads the cross-wave verdict
    bitmap. On the card the kernel updates `free` and `ok_global` in place
    when they already lie there (the JAX package donates them), and returns
    them as `free_after` / `ok_global`. `domains` is the per-level node index
    the kernel sums domains over (kernels.place_wave.DomainIndex); when not
    given it is built here from node_domain_id, which copies that array to
    the host if it lies on the card — callers solving many waves build it
    once.

    `plan` (solver.pruning.CandidatePlan cut for this batch, whose fields
    are numpy arrays) solves on the plan's candidate axis: `free` and
    `ok_global` stay the fleet's carry, the plan's static node tensors
    stand in for capacity/schedulable/node_domain_id (which are then not
    read), and `assigned` comes back in fleet ordinals."""
    dev = resolve_device(device)
    params = params or SolverParams()
    if plan is not None:
        return _solve_pruned(free, batch, params, ok_global, dev, plan)
    if dev.type == "cuda" and domains is None:
        from grove_tpu_torch.kernels.place_wave import domain_index

        domains = domain_index(node_domain_id, dev)

    free = tensor_on(free, torch.float32, dev)
    capacity = tensor_on(capacity, torch.float32, dev)
    schedulable = tensor_on(schedulable, torch.bool, dev)
    node_domain_id = tensor_on(node_domain_id, torch.int32, dev)
    ok_global = tensor_on(ok_global, torch.bool, dev)
    tbatch = batch_to(batch, dev)
    if free.is_cuda:
        from grove_tpu_torch.kernels.place_wave import place_wave

        out = place_wave(
            free, capacity, schedulable, node_domain_id, tbatch, params, ok_global,
            domains=domains,
        )
    else:
        out = solve_batch_ref(
            free, capacity, schedulable, node_domain_id, tbatch, params, ok_global
        )
    return SolveResult(*out)


def sharded_solve(free, capacity, schedulable, node_domain_id, batch: GangBatch,
                  params: SolverParams | None = None, ok_global=None, *, layout, device=None,
                  domains=None, cand_idx=None, cand_count=None) -> SolveResult:
    """One wave solved node-sharded under `layout` (a parallel.mesh
    SolveLayout; core.py `sharded_solve_fn`): the node axis (with
    `cand_idx`/`cand_count`, the candidate axis, as solve_batch's `plan`
    fields) splits into the layout's row spans. On the card it is one B7
    launch (kernels/place_wave.py `place_wave_sharded`) over the layout's
    virtual shards, updating `free` and `ok_global` in place when they
    already lie there; `domains` is the sharded DomainIndex (built here
    when not given). On the CPU the plain version (sharded_solve_ref). The
    layout's device must be the solve's: a layout over distinct cards
    raises (parallel/mesh.py WAITS_CARDS)."""
    dev = resolve_device(device)
    if layout.device.type != dev.type:
        raise ValueError(f"sharded_solve: a layout on {layout.device} for a solve on {dev}")
    params = params or SolverParams()
    free = tensor_on(free, torch.float32, dev)
    capacity = tensor_on(capacity, torch.float32, dev)
    schedulable = tensor_on(schedulable, torch.bool, dev)
    node_domain_id = tensor_on(node_domain_id, torch.int32, dev)
    ok_global = tensor_on(ok_global, torch.bool, dev)
    cand_idx = tensor_on(cand_idx, torch.int32, dev)
    tbatch = batch_to(batch, dev)
    n = capacity.shape[0]
    count = None if cand_idx is None else int(cand_count if cand_count is not None else n)
    if dev.type == "cuda":
        from grove_tpu_torch.kernels.place_wave import domain_index_sharded, place_wave_sharded

        if domains is None:
            domains = domain_index_sharded(node_domain_id, layout.node_devices, dev)
        out = place_wave_sharded(free, capacity, schedulable, node_domain_id, tbatch, params,
                                 ok_global, shards=layout.node_devices, domains=domains,
                                 cand_idx=cand_idx, cand_count=count)
    else:
        out = sharded_solve_ref(free, capacity, schedulable, node_domain_id, tbatch, params,
                                ok_global, layout.spans(n), cand_idx, count)
    return SolveResult(*out)


_SHARDED_FN: dict[tuple, object] = {}


def sharded_solve_fn(layout, donate: bool = False):
    """The node-sharded solve pinned to `layout` (core.py
    `sharded_solve_fn`), one per (donate, layout key): called as
    solve_batch is, (free, capacity, schedulable, node_domain_id, batch,
    params, ok_global, *, device, domains, cand_idx, cand_count). With
    `donate` the launch updates the caller's free and ok_global in place
    on the card (the JAX package donates them); without, it works on
    copies."""
    key = (bool(donate), layout.key())
    fn = _SHARDED_FN.get(key)
    if fn is None:
        def fn(free, capacity, schedulable, node_domain_id, batch, params=None, ok_global=None,
               **kw):
            if not donate:
                free = free.clone() if torch.is_tensor(free) else free
                ok_global = ok_global.clone() if torch.is_tensor(ok_global) else ok_global
            return sharded_solve(free, capacity, schedulable, node_domain_id, batch, params,
                                 ok_global, layout=layout, **kw)

        fn = _SHARDED_FN.setdefault(key, fn)
    return fn


def _check_layout(layout, dev) -> None:
    if layout is not None and layout.device.type != dev.type:
        raise ValueError(f"a layout on {layout.device} for a solve on {dev}")


def _sharded(layout) -> bool:
    """Does `layout` split the node axis (B7 and its compositions)?"""
    return layout is not None and layout.node_devices > 1


def scan_solve(free0, capacity, schedulable, node_domain_id, stacked_batch: GangBatch,
               params: SolverParams | None = None, ok_global=None, *, retain: bool = False,
               device=None, domains=None, layout=None) -> ScanSolveResult:
    """W waves of one shape solved in order (core.py `scan_solve_fn`): every
    field of `stacked_batch` has a leading [W] axis, and step w solves wave w
    from the (free, ok_global) step w - 1 left, so step w's rows equal
    solve_batch on that entering carry bit for bit. With `retain` the result
    keeps each step's entering carry (free_in, okg_in).

    On the card it is one launch (kernels/place_wave.py `place_wave_scan`)
    that updates `free0` and `ok_global` in place when they already lie
    there, as the JAX package donates them; `domains` is the fleet's
    DomainIndex (built here when not given). "cpu" runs the plain version.

    `layout` (a parallel.mesh SolveLayout) splits the node axis into its
    shards (core.py `scan_solve_fn(layout)`): B4 x B7 on the card
    (`place_wave_scan_sharded`, `domains` then the sharded DomainIndex),
    `sharded_scan_solve_ref` on the CPU."""
    dev = resolve_device(device)
    _check_layout(layout, dev)
    params = params or SolverParams()
    free0 = tensor_on(free0, torch.float32, dev)
    capacity = tensor_on(capacity, torch.float32, dev)
    schedulable = tensor_on(schedulable, torch.bool, dev)
    node_domain_id = tensor_on(node_domain_id, torch.int32, dev)
    ok_global = tensor_on(ok_global, torch.bool, dev)
    tbatch = batch_to(stacked_batch, dev)
    shards = layout.node_devices if _sharded(layout) else None
    if dev.type == "cuda":
        from grove_tpu_torch.kernels import place_wave as pw

        if shards:
            if domains is None:
                domains = pw.domain_index_sharded(node_domain_id, shards, dev)
            out = pw.place_wave_scan_sharded(free0, capacity, schedulable, node_domain_id, tbatch,
                                             params, ok_global, shards=shards, domains=domains,
                                             retain=retain)
        else:
            if domains is None:
                domains = pw.domain_index(node_domain_id, dev)
            out = pw.place_wave_scan(free0, capacity, schedulable, node_domain_id, tbatch, params,
                                     ok_global, domains=domains, retain=retain)
    elif shards:
        out = sharded_scan_solve_ref(free0, capacity, schedulable, node_domain_id, tbatch, params,
                                     ok_global, retain, layout.spans(capacity.shape[0]))
    else:
        out = scan_solve_ref(free0, capacity, schedulable, node_domain_id, tbatch, params,
                             ok_global, retain)
    return ScanSolveResult(*out)


def scan_pruned_solve(free0, cand_idx, capacity_p, schedulable_p, node_domain_id_p,
                      stacked_batch: GangBatch, params: SolverParams | None = None,
                      ok_global=None, *, retain: bool = False, device=None,
                      domains=None, layout=None) -> ScanSolveResult:
    """The candidate-pruned scan (core.py `scan_pruned_solve_fn`): step w
    solves wave w on its own candidate axis — `cand_idx` i32 [W, CP] (each
    plan's padded_idx: candidates first, pad rows past the fleet),
    `capacity_p` [W, CP, R], `schedulable_p` [W, CP], `node_domain_id_p`
    [W, L, CP] and the candidate-axis `stacked_batch` — gathering the fleet
    carry `free0` [N, R] at its head and scattering back at its tail;
    `assigned` comes back in fleet ordinals and the retained free_in is
    fleet-shaped. `domains` (on the card) is the plans' DomainIndex stacked
    on a leading [W] axis (solver/pruning.py `stack_plans`). `layout` splits
    each step's candidate axis into its shards (core.py
    `scan_pruned_solve_fn(layout)`: B4 x B7, each shard gathering and
    scattering its own candidate rows; `domains` then
    kernels.place_wave.domain_index_stacked_sharded's)."""
    dev = resolve_device(device)
    _check_layout(layout, dev)
    params = params or SolverParams()
    free0 = tensor_on(free0, torch.float32, dev)
    cand_idx = tensor_on(cand_idx, torch.int32, dev)
    capacity_p = tensor_on(capacity_p, torch.float32, dev)
    schedulable_p = tensor_on(schedulable_p, torch.bool, dev)
    node_domain_id_p = tensor_on(node_domain_id_p, torch.int32, dev)
    ok_global = tensor_on(ok_global, torch.bool, dev)
    tbatch = batch_to(stacked_batch, dev)
    shards = layout.node_devices if _sharded(layout) else None
    if dev.type == "cuda":
        from grove_tpu_torch.kernels import place_wave as pw

        if shards:
            if domains is None:
                domains = pw.domain_index_stacked_sharded(node_domain_id_p, shards, dev)
            out = pw.place_wave_scan_sharded(free0, capacity_p, schedulable_p, node_domain_id_p,
                                             tbatch, params, ok_global, shards=shards,
                                             domains=domains, cand_idx=cand_idx, retain=retain)
        else:
            if domains is None:
                domains = pw.domain_index_stacked(node_domain_id_p, dev)
            out = pw.place_wave_scan(free0, capacity_p, schedulable_p, node_domain_id_p, tbatch,
                                     params, ok_global, domains=domains, cand_idx=cand_idx,
                                     retain=retain)
    elif shards:
        out = sharded_scan_pruned_solve_ref(free0, cand_idx, capacity_p, schedulable_p,
                                            node_domain_id_p, tbatch, params, ok_global, retain,
                                            layout.spans(capacity_p.shape[1]))
    else:
        out = scan_pruned_solve_ref(free0, cand_idx, capacity_p, schedulable_p,
                                    node_domain_id_p, tbatch, params, ok_global, retain)
    return ScanSolveResult(*out)


_SCAN_FN: dict[tuple, object] = {}


def scan_solve_fn(layout=None, retain: bool = False, donate: bool = False):
    """The scan pinned to `layout` (core.py `scan_solve_fn`), one per
    (retain, donate, layout key): called as scan_solve is, (free0,
    capacity, schedulable, node_domain_id, stacked_batch, params,
    ok_global, *, device, domains). Without `donate` it works on copies of
    free0 and ok_global."""
    return _scan_fn("dense", layout, retain, donate)


def scan_pruned_solve_fn(layout=None, retain: bool = False, donate: bool = False):
    """The candidate-pruned scan pinned to `layout` (core.py
    `scan_pruned_solve_fn`): called as scan_pruned_solve is, (free0,
    cand_idx, capacity_p, schedulable_p, node_domain_id_p, stacked_batch,
    params, ok_global, *, device, domains)."""
    return _scan_fn("pruned", layout, retain, donate)


def _scan_fn(kind: str, layout, retain: bool, donate: bool):
    key = (kind, bool(retain), bool(donate), None if layout is None else layout.key())
    fn = _SCAN_FN.get(key)
    if fn is None:
        solve_fn = scan_solve if kind == "dense" else scan_pruned_solve
        okg_at = 6 if kind == "dense" else 7  # ok_global's place in the call

        def fn(*args, **kw):
            args = list(args)
            if not donate:
                args[0] = args[0].clone() if torch.is_tensor(args[0]) else args[0]
                if len(args) > okg_at and torch.is_tensor(args[okg_at]):
                    args[okg_at] = args[okg_at].clone()
            return solve_fn(*args, retain=retain, layout=layout, **kw)

        fn = _SCAN_FN.setdefault(key, fn)
    return fn


def stacked_scan_solve(free_stack, capacity, schedulable, node_domain_id,
                       stacked_batch: GangBatch, params_stack, *, device=None,
                       domains=None) -> StackedScanResult:
    """W journaled waves of one shape under K weight rows (core.py
    `stacked_scan_solve_fn`): `free_stack` f32 [W, N, R] holds each wave's
    recorded entering free, every field of `stacked_batch` has a leading [W]
    axis, `params_stack` is f32 [K, 5]. Step w row k equals solve_batch of
    wave w from free_stack[w] under row k bit for bit; no ok_global, no
    carry between the waves. A null wave (zero free, all-invalid batch)
    admits nothing. On the card it is one launch (kernels/place_wave.py
    `place_wave_stacked_scan`, B6); `domains` is the fleet's DomainIndex
    (built here when not given). "cpu" runs the plain version."""
    dev = resolve_device(device)
    free_stack = tensor_on(free_stack, torch.float32, dev)
    capacity = tensor_on(capacity, torch.float32, dev)
    schedulable = tensor_on(schedulable, torch.bool, dev)
    node_domain_id = tensor_on(node_domain_id, torch.int32, dev)
    tbatch = batch_to(stacked_batch, dev)
    pstack = stack_on(params_stack, dev)
    if dev.type == "cuda":
        from grove_tpu_torch.kernels.place_wave import domain_index, place_wave_stacked_scan

        if domains is None:
            domains = domain_index(node_domain_id, dev)
        out = place_wave_stacked_scan(free_stack, capacity, schedulable, node_domain_id, tbatch,
                                      pstack, domains=domains)
    else:
        out = stacked_scan_solve_ref(free_stack, capacity, schedulable, node_domain_id, tbatch,
                                     pstack)
    return StackedScanResult(*out)


def stacked_solve_batch(free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                        params_stack, ok_global=None, *, device=None, domains=None) -> SolveResult:
    """Solve the same wave under K weight rows at once (core.py
    `stacked_solve_batch_impl`): every result gains a leading [K] axis
    (assigned [K, G, MP], ok [K, G], placement_score [K, G], free_after
    [K, N, R]), and row k equals solve_batch under row k's weights bit for
    bit. `params_stack` is f32 [K, 5] (SolverParams' fields in order). Every
    row solves from `free0` and judges its cross-wave dependencies against
    `ok_global`; neither is changed, and the result carries no ok_global.
    On the card it is one stacked launch (kernels/place_wave.py
    `place_wave_stacked`, select=False)."""
    return SolveResult(*stacked_dispatch(free0, capacity, schedulable, node_domain_id, batch,
                                         params_stack, ok_global, select=False, device=device,
                                         domains=domains))


def stacked_dispatch(free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                     params_stack, ok_global, *, select: bool, device, domains, layout=None):
    """The stacked solve shared by stacked_solve_batch (select=False) and
    parallel/portfolio.py's portfolio_solve_batch (select=True): the arrays
    to `device` (None = the card), then one stacked launch with the select
    on the card, or the plain versions on the CPU. Returns the kernel's
    tuple (kernels/place_wave.py `place_wave_stacked`).

    `layout` (a (P, K) parallel.mesh SolveLayout) with K > 1 node shards
    makes it B5 x B7: `place_wave_stacked_sharded` on the card (`domains`
    then the sharded DomainIndex, built here when not given),
    `sharded_stacked_solve_ref` on the CPU; with K = 1 it is B5."""
    dev = resolve_device(device)
    _check_layout(layout, dev)
    free0 = tensor_on(free0, torch.float32, dev)
    capacity = tensor_on(capacity, torch.float32, dev)
    schedulable = tensor_on(schedulable, torch.bool, dev)
    node_domain_id = tensor_on(node_domain_id, torch.int32, dev)
    ok_global = tensor_on(ok_global, torch.bool, dev)
    tbatch = batch_to(batch, dev)
    pstack = stack_on(params_stack, dev)
    shards = layout.node_devices if _sharded(layout) else None
    if dev.type == "cuda":
        from grove_tpu_torch.kernels import place_wave as pw

        if shards:
            if domains is None:
                domains = pw.domain_index_sharded(node_domain_id, shards, dev)
            return pw.place_wave_stacked_sharded(free0, capacity, schedulable, node_domain_id,
                                                 tbatch, pstack, ok_global, shards=shards,
                                                 domains=domains, select=select)
        if domains is None:
            domains = pw.domain_index(node_domain_id, dev)
        return pw.place_wave_stacked(free0, capacity, schedulable, node_domain_id, tbatch, pstack,
                                     ok_global, domains=domains, select=select)
    if shards:
        rows = sharded_stacked_solve_ref(free0, capacity, schedulable, node_domain_id, tbatch,
                                         pstack, ok_global, layout.spans(capacity.shape[0]))
    else:
        rows = stacked_solve_ref(free0, capacity, schedulable, node_domain_id, tbatch, pstack,
                                 ok_global)
    return portfolio_select_ref(*rows, tbatch, ok_global) if select else rows


def solve(
    snapshot,
    batch: GangBatch,
    params: SolverParams | None = None,
    free=None,
    schedulable=None,
    ok_global=None,
    portfolio: int = 1,
    escalate_portfolio: int = 1,
    *,
    device=None,
    pruning=None,
    mesh_axis: int = 1,
    warm=None,
    mesh=None,
) -> SolveResult:
    """The serving entry (core.py `solve`): snapshot (numpy) -> device ->
    one solve, or a portfolio of them.

    `free`/`schedulable` override the snapshot's (wave chaining: pass the
    previous result's free_after); `ok_global` threads the cross-wave verdict
    bitmap. The caller's arrays are never changed: the result's free_after
    and ok_global are new tensors.

    `portfolio` > 1 solves the batch under P weight variants
    (parallel/portfolio.py) and keeps the winner by (admitted count,
    quality). `escalate_portfolio` > portfolio: when the first solve leaves
    a valid gang rejected (its cross-wave base admitted, or none), the same
    batch is solved once more under that many variants, from the same
    entering state, and that winner is returned; slot 0 of the population
    is the base, so it never admits fewer gangs.

    `pruning` (an enabled solver.pruning.PruningConfig) solves a
    single-variant solve from the snapshot's own state (no `free` or
    `schedulable` override) on the batch's candidate axis; a valid gang
    rejected there whose plan was lossy makes the dense solve run instead,
    before any escalation (core.py `solve`'s pruned branch). `mesh_axis` is
    the node axis of the mesh a journaled solve ran under: the candidate pad
    is rounded to a multiple of it (a `mesh` rounds it to its own).

    `mesh` (a parallel.mesh.SolveLayout, or a MeshConfig negotiated here)
    shards the single-variant solve, dense or pruned, over the layout's
    shards (B7 on the card, under the launch cache's layout key; pruned, the
    candidate axis splits). A portfolio solve ignores it, as the JAX
    package's does: the portfolio and an escalation's re-solve each
    negotiate their own (portfolio, node) mesh (parallel/portfolio.py
    `portfolio_solve`, B5 x B7 when its node axis is over 1).

    `warm` (a solver.warm.WarmPath; None = the process-shared one): the
    snapshot's node tensors (and its DomainIndex) come from the warm path's
    device cache, so an unchanged snapshot uploads nothing, and
    single-variant solves, dense and pruned, go through its launch cache;
    `warm.prune` counts the pruned solves.

    `device` None means the card; "cpu" runs the plain PyTorch versions."""
    from grove_tpu_torch.parallel.portfolio import portfolio_solve
    from grove_tpu_torch.solver.warm import default_warm_path

    from grove_tpu_torch.parallel.mesh import resolve_layout, solver_mesh_for

    dev = resolve_device(device)
    params = params or SolverParams()
    warm = warm if warm is not None else default_warm_path()
    layout = resolve_layout(mesh, int(snapshot.free.shape[0])) if portfolio == 1 else None
    if layout is not None:
        mesh_axis = layout.node_devices

    def on(x, dtype):
        # A copy of the caller's tensor: the kernels update their carry in place.
        t = tensor_on(x, dtype, dev)
        return t.clone() if t is x else t

    okg = None if ok_global is None else on(ok_global, torch.bool)
    # Cached tensors: no launch may write them (the portfolio's below get
    # copies).
    free0, capacity, sched, node_domain_id = warm.device.snapshot_arrays(
        snapshot, free=free, schedulable=schedulable, device=dev)
    domains = warm.device.domain_index(snapshot.node_domain_id, dev, shards=layout and
                                       layout.node_devices) if dev.type == "cuda" else None
    escalate = escalate_portfolio > portfolio
    prune = (pruning is not None and pruning.enabled and portfolio == 1 and free is None
             and schedulable is None)
    if escalate or prune:
        valid = apply_global_deps_ref(batch_to(batch, "cpu"),
                                      None if okg is None else okg.cpu()).numpy()
    if escalate:
        # Escalation re-solves from the state the first solve entered with.
        entry = (free0.clone(), None if okg is None else okg.clone())
    tbatch = None

    def psolve(width, free_in, okg_in):
        # The portfolio's own mesh, negotiated per solve as the JAX package's
        # portfolio_solve negotiates it (a fallback counts each time).
        nonlocal tbatch
        if tbatch is None:
            tbatch = batch_to(batch, dev)
        pmesh = solver_mesh_for(width, int(capacity.shape[0]), dev)
        k = pmesh.node_devices if pmesh is not None else 1
        pdomains = warm.device.domain_index(snapshot.node_domain_id, dev,
                                            shards=k if k > 1 else None) \
            if dev.type == "cuda" else None
        return portfolio_solve(free_in, capacity, sched, node_domain_id, tbatch, params, width,
                               okg_in, device=dev, domains=pdomains, mesh=pmesh)

    result = None
    pruned_ok = None  # the pruned verdicts, to grade an escalated re-solve
    if prune:
        from grove_tpu_torch.solver.pruning import lossy_rejections, plan_candidates

        pstats = warm.prune
        plan = plan_candidates(snapshot, batch, pruning, mesh_axis=mesh_axis)
        if plan is None:
            pstats.dense_fallbacks += 1
        else:
            # The launch cache leaves the carry as it was: a lossy rejection
            # re-solves dense from it.
            cache = warm.device
            presult = warm.executables.solve(
                free0, cache.device_array(plan.capacity, torch.float32, dev),
                cache.device_array(plan.schedulable, torch.bool, dev),
                cache.device_array(plan.node_domain_id, torch.int32, dev),
                plan.gather_batch(batch), params, okg, device=dev,
                domains=cache.domain_index(plan.node_domain_id, dev,
                                           shards=layout and layout.node_devices)
                if dev.type == "cuda" else None,
                cand_idx=plan.padded_idx(),
                cand_count=plan.count,
                layout=layout,
            )
            pstats.pruned_solves += 1
            pstats.last_candidate_nodes = plan.count
            pstats.last_candidate_pad = plan.pad
            pstats.last_fleet_nodes = plan.fleet_pad
            pruned_ok = presult.ok.cpu().numpy()
            if lossy_rejections(plan, valid, pruned_ok).any():
                pstats.escalations += 1
            else:
                result = presult
    if result is None:
        if portfolio > 1:
            result = psolve(portfolio, free0.clone(), okg)
        else:
            result = warm.executables.solve(free0, capacity, sched, node_domain_id, batch,
                                            params, okg, device=dev, domains=domains,
                                            layout=layout)
        if pruned_ok is not None:
            # The escalated re-solve: did the full fleet change a verdict?
            if bool(np.any(result.ok.cpu().numpy() != pruned_ok)):
                warm.prune.escalations_adopted += 1
    if escalate and bool((valid & ~result.ok.cpu().numpy()).any()):
        return psolve(escalate_portfolio, *entry)
    return result


def _solve_pruned(free, batch, params, ok_global, dev, plan) -> SolveResult:
    pt = plan.tensors(dev)
    free = torch.as_tensor(free, dtype=torch.float32, device=dev)
    if ok_global is not None:
        ok_global = torch.as_tensor(ok_global, dtype=torch.bool, device=dev)
    tbatch = batch_to(plan.gather_batch(batch), dev)
    if free.is_cuda:
        from grove_tpu_torch.kernels.place_wave import place_wave

        out = place_wave(
            free, pt.capacity, pt.schedulable, pt.node_domain_id, tbatch, params, ok_global,
            domains=pt.domains, cand_idx=pt.cand_idx, cand_count=plan.count,
        )
    else:
        out = solve_pruned_ref(
            free, pt.capacity, pt.schedulable, pt.node_domain_id, tbatch, params, ok_global,
            pt.cand_idx, plan.count,
        )
    return SolveResult(*out)


def fetch_result(result: SolveResult) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A solve's (ok bool [G], assigned i32 [G, MP], placement_score f32 [G])
    as numpy arrays. From the card the three planes travel as one byte
    buffer, so the host reads them in a single copy (one synchronisation)."""
    # The 4-byte planes first, so each view below starts aligned.
    planes = (result.assigned, result.placement_score, result.ok)
    if not planes[0].is_cuda:
        return result.ok.cpu().numpy(), planes[0].cpu().numpy(), planes[1].cpu().numpy()
    flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in planes]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(planes, flat):
        n = f.numel()
        dtype = {torch.bool: np.bool_, torch.int32: np.int32, torch.float32: np.float32}[t.dtype]
        out.append(host[at:at + n].view(dtype).reshape(tuple(t.shape)))
        at += n
    assigned, score, ok = out
    return ok, assigned, score


def decode_assignments(result: SolveResult, decode_info, snapshot) -> dict[str, dict[str, str]]:
    """SolveResult -> {gang name: {pod name: node name}} for admitted gangs
    (one copy from the card, fetch_result)."""
    ok, assigned, _score = fetch_result(result)
    return decode_bindings(ok, assigned, decode_info, snapshot)


def decode_bindings(ok, assigned, decode_info, snapshot) -> dict[str, dict[str, str]]:
    """(ok [G], assigned [G, MP]) -> {gang: {pod: node}} for admitted gangs.

    The valid (gang, slot) pairs are cut with one mask over the decode info's
    slot arrays and node names gather through the snapshot's name array, so
    the host cost is O(admitted pods)."""
    out: dict[str, dict[str, str]] = {}
    g_real = len(decode_info.gang_names)
    if g_real == 0:
        return out
    assigned = np.asarray(assigned)
    ok_real = np.asarray(ok)[:g_real].astype(bool, copy=False)
    admitted = np.flatnonzero(ok_real)
    for gi in admitted.tolist():
        out[decode_info.gang_names[gi]] = {}
    if admitted.size == 0:
        return out
    slot_gang, slot_col, slot_pod = decode_info.slot_arrays()
    live = ok_real[slot_gang] & (assigned[slot_gang, slot_col] >= 0)
    sg = slot_gang[live]
    pods = slot_pod[live].tolist()
    nodes = snapshot.node_names_arr()[assigned[sg, slot_col[live]]].tolist()
    # Slot arrays are row-major, so each admitted gang's pairs are one
    # contiguous segment.
    starts = np.searchsorted(sg, admitted, side="left")
    ends = np.searchsorted(sg, admitted, side="right")
    for j, gi in enumerate(admitted.tolist()):
        s, e = int(starts[j]), int(ends[j])
        if e > s:
            out[decode_info.gang_names[gi]] = dict(zip(pods[s:e], nodes[s:e]))
    return out
