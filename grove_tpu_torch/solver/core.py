"""The placement engine's entry points: batched all-or-nothing gang
bin-packing, one wave per call (grove_tpu/solver/core.py counterpart).

`solve_batch` dispatches on the device its tensors lie on: on a CUDA device it
launches the hand-written Hopper kernel (grove_tpu_torch/kernels/place_wave.py);
on the CPU — only when the caller asks for it with device="cpu" — it runs
the plain PyTorch version (solver/reference.py). There is no fallback between
the two: a CUDA batch the kernel does not take raises. Given a candidate plan
(solver/pruning.py) it solves the wave on the plan's candidate axis, inside
the same single launch on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.reference import solve_batch_ref, solve_pruned_ref


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


def batch_to(batch: GangBatch, device) -> GangBatch:
    """GangBatch of numpy arrays (or tensors) -> GangBatch of tensors on
    `device` (see to_device)."""
    return GangBatch(*(None if x is None else to_device(x, device) for x in batch))


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

    def on(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    free = on(free, torch.float32)
    capacity = on(capacity, torch.float32)
    schedulable = on(schedulable, torch.bool)
    node_domain_id = on(node_domain_id, torch.int32)
    if ok_global is not None:
        ok_global = on(ok_global, torch.bool)
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
