"""Wrapper of the place_wave CUDA kernel (csrc/place_wave.cu): one launch
solves one wave — B1, the per-wave gang solve, with B2, the cross-wave
verdict gating, folded into the same launch, and, for a candidate-pruned
wave, B3, the gather of the fleet carry onto the candidate axis, the scatter
back and the remap of `assigned` to fleet ordinals.

It replaces the XLA program of grove_tpu/solver/core.py `solve_batch_impl`
(+ `_place_gang`, `_apply_global_deps`, `_scatter_global_ok`) and the
pruned solve's grove_tpu/solver/pruning.py `CandidatePlan.gather_free` /
`scatter_free` / `remap_assigned`. Its plain PyTorch versions are
grove_tpu_torch/solver/reference.py `solve_batch_ref` and
`solve_pruned_ref`; `solver.core.solve_batch` picks one or the other by the
device of its tensors, never both.

A launch is a prologue kernel (one block per gang: the gang's invariants)
and the chain kernel (one block: the gangs in order). The carry lives in
global memory at every fleet size; PLANE_BYTES of dynamic shared memory
stage the domain walks. `profile` launches the instantiation that counts
clock64 cycles per section (SECTIONS).

`place_wave_stacked` is B5 (grove_tpu/solver/core.py
`stacked_solve_batch_impl`, grove_tpu/parallel/portfolio.py
`portfolio_solve_batch`): the same wave under K weight rows in one launch,
K chain blocks side by side, and with `select` the portfolio's winner
picked on the card. Its plain versions are solver/reference.py
`stacked_solve_ref` and `portfolio_select_ref`.

`place_wave_scan` is B4 (grove_tpu/solver/core.py `scan_solve_fn` /
`scan_pruned_solve_fn`): W waves of one shape in one launch, the carry
threaded from step to step on the card, each step equal to a single launch
on its entering carry. Its plain versions are solver/reference.py
`scan_solve_ref` and `scan_pruned_solve_ref`.

`place_wave_stacked_scan` is B6 (grove_tpu/solver/core.py
`stacked_scan_solve_fn`, the tuning sweep's run batcher): W journaled waves
of one shape under K weight rows in one launch, W * K chain blocks across
the SMs, each wave from its own recorded free with no carry between them;
row (w, k) equals a single launch of wave w under row k. Its plain version
is solver/reference.py `stacked_scan_solve_ref`.

`place_wave_sharded` is B7 (grove_tpu/solver/core.py `sharded_solve_fn`
with grove_tpu/parallel/mesh.py `SolveLayout`): one wave with its node
axis (the candidate axis when pruned) split into S row spans, one chain
block per shard in one cooperative launch, the shards exchanging domain
partials and stage-2 candidates through device memory. Its plain version
is solver/reference.py `sharded_solve_ref`. The shards are virtual: every
block runs on the one card the tensors lie on; a launch across distinct
cards is not ported.

Two compositions of B7: `place_wave_stacked_sharded` is B5 x B7
(grove_tpu/parallel/portfolio.py `portfolio_solve` over a (portfolio,
node) mesh whose node axis is S > 1): K weight rows times S shards, K * S
chain blocks in one cooperative launch, and with `select` the winner
picked on the card; its plain version is solver/reference.py
`sharded_stacked_solve_ref` (then `portfolio_select_ref`).
`place_wave_scan_sharded` is B4 x B7 (grove_tpu/solver/core.py
`scan_solve_fn(layout)` / `scan_pruned_solve_fn(layout)`): S chain blocks
walking a chunk's W steps together; its plain versions are
`sharded_scan_solve_ref` and `sharded_scan_pruned_solve_ref`.

`PreparedLaunch` is the warm path's entry (solver/warm.py `ExecutableCache`):
one of these launches with every buffer owned and allocated once, captured
once as a CUDA graph and replayed per call; a replay counts as a launch of
its variant.

The kernels launch on PyTorch's current stream and do not synchronise;
`free` and `ok_global` are updated in place. `place_wave.launches` counts the
launches (one per wave, or per scan chunk, the prologue included), and
`place_wave.variant_launches` counts them per variant: "dense" and "pruned"
for place_wave, "stacked" (select=False) and "portfolio" (select=True) for
place_wave_stacked, "scan" and "scan_pruned" for place_wave_scan,
"stacked_scan" for place_wave_stacked_scan, "sharded" and "sharded_pruned"
for place_wave_sharded, "stacked_sharded" (select=False) and
"portfolio_sharded" (select=True) for place_wave_stacked_sharded,
"scan_sharded" and "scan_sharded_pruned" for place_wave_scan_sharded.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from grove_tpu_torch.solver.encode import GangBatch

R_MAX, MG_MAX, MS_MAX, L_MAX = 8, 16, 8, 8
# Dynamic shared memory for the staged walks (of the 227 KB a block may use,
# beside the kernel's ~4.5 KB of static shared memory): 51200 f32 words, so
# a walk of a 20480-node fleet stages in a few rounds or chunks.
PLANE_BYTES = 200 * 1024
# Global bytes of one gang's PwGangInv record (PW_INV_BYTES in the source).
INV_BYTES = 2048
# Shards of one sharded launch (PW_S_MAX in the source): its chain blocks
# must all be resident at once, one per SM.
S_MAX = 8

_P = ctypes.c_void_p
_FIELDS = [
    (k, ctypes.c_int)
    for k in ("N", "R", "L", "G", "MG", "MS", "MP", "T", "NF", "cand_count", "plane_words", "K")
]
_FIELDS += [
    (k, ctypes.c_float) for k in ("w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread")
]
_POINTERS = (
    "free_io", "cand_idx", "capacity", "schedulable", "node_domain_id", "dom_count",
    "dom_offsets", "dom_nodes", "group_req", "group_total", "group_required", "group_valid",
    "set_member", "set_req_level", "set_pref_level", "set_valid", "set_pinned", "pod_group",
    "pod_rank", "gang_valid", "group_order", "depends_on", "global_index", "depends_global",
    "reuse_nodes", "group_node_ok", "spread_level", "spread_family", "spread_avoid",
    "ok_global", "assigned", "ok", "score", "carry", "family_used", "spread_pen", "tables",
    "agg", "feas2", "nword", "a_slots", "a_score", "norm_free", "entries", "undo", "ginv",
    "prof", "params_stack", "sel_terms", "sel_admitted", "sel_quality", "objectives", "winner",
    "win_assigned", "win_ok", "win_score",
)
N_WEIGHTS = 5  # SolverParams' fields, the columns of a weight stack
_FIELDS += [(k, _P) for k in _POINTERS]
# The scan launch's arrays with a leading step axis (PW_STEPPED in the
# source): each gets a stride, in elements, between consecutive steps.
STEPPED = (
    "cand_idx", "capacity", "schedulable", "node_domain_id", "dom_count", "dom_offsets",
    "dom_nodes", "group_req", "group_total", "group_required", "group_valid", "set_member",
    "set_req_level", "set_pref_level", "set_valid", "set_pinned", "pod_group", "pod_rank",
    "gang_valid", "group_order", "depends_on", "global_index", "depends_global", "reuse_nodes",
    "group_node_ok", "spread_level", "spread_family", "spread_avoid", "assigned", "ok", "score",
    "ginv", "free_in", "okg_in", "shard_offsets", "shard_nodes",
)
_FIELDS += [("W", ctypes.c_int), ("free_in", _P), ("okg_in", _P), ("cand_counts", _P)]
_FIELDS += [(f"st_{k}", ctypes.c_int64) for k in STEPPED]
# The sharded launch's fields (B7).
_SHARD_POINTERS = ("shard_offsets", "shard_nodes", "xagg", "xcand", "xcnt", "bar")
_FIELDS += [(k, ctypes.c_int) for k in ("S", "x_rows", "x_words")]
_FIELDS += [(k, _P) for k in _SHARD_POINTERS]
# Sections of the profiled instantiation (PW_SEC_* in csrc/place_wave.cu),
# the columns of its cycle table.
SECTIONS = (
    "gate + row load", "per-gang setup", "spread planes", "tables + feas2",
    "stage-1 node passes", "stage-1 walks", "stage-1 domain argmax", "stage-2 scoring",
    "stage-2 take loop", "stage 3-4", "commit",
)


class PlaceWaveArgs(ctypes.Structure):
    """Mirror of `struct PlaceWaveArgs` in csrc/place_wave.cu (same order)."""

    _fields_ = _FIELDS


class DomainIndex(NamedTuple):
    """Per-level CSR of node indices by domain ordinal, in node order — the
    fixed order the kernel sums domains in. Built once per snapshot."""

    count: torch.Tensor  # i32 [L] domains per level
    offsets: torch.Tensor  # i32 [L, N + 1]
    nodes: torch.Tensor  # i32 [L, N]


def domain_index(node_domain_id, device) -> DomainIndex:
    from grove_tpu_torch.solver.core import to_device

    return DomainIndex(*(to_device(x, device) for x in domain_index_arrays(node_domain_id)))


def domain_index_stacked(node_domain_id, device) -> DomainIndex:
    """The DomainIndex of each row of `node_domain_id` [W, L, N] (a scan
    chunk's plans), stacked on a leading [W] axis."""
    from grove_tpu_torch.solver.core import to_device

    rows = [domain_index_arrays(nd) for nd in node_domain_id]
    return DomainIndex(*(to_device(np.stack(x), device) for x in zip(*rows)))


def domain_index_sharded(node_domain_id, shards: int, device) -> DomainIndex:
    """The sharded launch's DomainIndex: `count` [L] is the level's domain
    count, `offsets` [S, L, N + 1] and `nodes` [S, L, N] each shard's CSR
    over its own rows [s * N / S, (s + 1) * N / S) (global node indices,
    domain-major, node order; past a shard's positions the rows are 0)."""
    from grove_tpu_torch.solver.core import to_device

    return DomainIndex(*(to_device(x, device)
                         for x in domain_index_sharded_arrays(node_domain_id, shards)))


def domain_index_stacked_sharded(node_domain_id, shards: int, device) -> DomainIndex:
    """domain_index_sharded of each row of `node_domain_id` [W, L, N] (a
    pruned scan chunk's plans over shards), stacked on a leading [W] axis:
    `count` [W, L], `offsets` [W, S, L, N + 1], `nodes` [W, S, L, N]."""
    from grove_tpu_torch.solver.core import to_device

    rows = [domain_index_sharded_arrays(nd, shards) for nd in node_domain_id]
    return DomainIndex(*(to_device(np.stack(x), device) for x in zip(*rows)))


def domain_index_sharded_arrays(node_domain_id, shards: int):
    """(count, offsets, nodes) of domain_index_sharded as numpy arrays."""
    ndid = np.asarray(
        node_domain_id.cpu() if torch.is_tensor(node_domain_id) else node_domain_id,
        dtype=np.int64,
    )
    levels, n = ndid.shape
    if shards < 1 or n % shards:
        raise ValueError(f"place_wave: {n} nodes do not split into {shards} shards")
    count = domain_index_arrays(ndid)[0]
    offsets = np.zeros((shards, levels, n + 1), dtype=np.int32)
    nodes = np.zeros((shards, levels, n), dtype=np.int32)
    step = n // shards
    for s in range(shards):
        mine = np.zeros(n, dtype=bool)
        mine[s * step:(s + 1) * step] = True
        for lv in range(levels):
            dom, d = ndid[lv], int(count[lv])
            labeled = np.flatnonzero((dom >= 0) & mine)
            order = labeled[np.argsort(dom[labeled], kind="stable")]
            nodes[s, lv, : order.size] = order
            offsets[s, lv, 1 : d + 1] = np.cumsum(np.bincount(dom[labeled], minlength=d))[:d]
            offsets[s, lv, d + 1 :] = order.size
    return count, offsets, nodes


def domain_index_arrays(node_domain_id) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(count, offsets, nodes) of a DomainIndex as numpy arrays."""
    ndid = np.asarray(
        node_domain_id.cpu() if torch.is_tensor(node_domain_id) else node_domain_id,
        dtype=np.int64,
    )
    levels, n = ndid.shape
    count = np.zeros((levels,), dtype=np.int32)
    offsets = np.zeros((levels, n + 1), dtype=np.int32)
    nodes = np.zeros((levels, n), dtype=np.int32)
    for lv in range(levels):
        dom = ndid[lv]
        labeled = np.flatnonzero(dom >= 0)
        d = int(dom[labeled].max()) + 1 if labeled.size else 0
        count[lv] = d
        order = labeled[np.argsort(dom[labeled], kind="stable")]
        nodes[lv, : order.size] = order
        offsets[lv, 1 : d + 1] = np.cumsum(np.bincount(dom[labeled], minlength=d))
        offsets[lv, d + 1 :] = order.size
    return count, offsets, nodes


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"place_wave: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"place_wave: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"place_wave: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"place_wave: {name} is not contiguous")


def build_args(free, capacity, schedulable, node_domain_id, batch: GangBatch, params,
               ok_global, domains: DomainIndex, cand_idx=None, cand_count=None,
               profile=False, plane_words=None, params_stack=None, select=False, steps=None,
               shards=None):
    """Check every input, allocate outputs and scratch, and fill the kernel's
    argument struct. Returns (args, smem_bytes, outputs, keepalive).

    With `params_stack` (f32 [K, 5], SolverParams' fields in order; `params`
    is then not read) the args are the stacked launch's: every output and
    scratch array gains a leading [K] axis, the outputs are "assigned"
    [K, G, MP], "ok" [K, G], "score" [K, G] and "free_after" [K, N, R] (each
    variant's carry), and with `select` also "win_assigned", "win_ok",
    "win_score", "winner" (i32 []) and "objectives" (f32 [K]).

    `free` is the fleet carry [NF, R]. Every other node-axis input lies on
    the solve's node axis N: the fleet itself, or with `cand_idx` (i32 [N],
    the fleet row of each candidate; pad rows >= NF) and `cand_count` (the
    plan's candidates, which come first) a candidate plan's axis. With
    `profile` the outputs hold "prof", i64 [G + 1, len(SECTIONS)] zeros for
    the profiled instantiation's cycle counts. `plane_words` (f32 words of
    shared memory for the staged walks, PLANE_BYTES / 4 by default) sets how
    many node positions a walk stages at once. `steps` (W of the scan and
    sweep launches, build_scan_args and build_sweep_args) puts a leading [W]
    axis on every output and sizes the gang invariants for W * G gangs;
    with a weight stack (the sweep) each of the W * K chain blocks gets its
    own scratch, without one (the scan) the one chain reuses its scratch at
    every step.

    `shards` (S, the sharded launch) splits the solve's node axis into S row
    spans: `domains` is then domain_index_sharded's (offsets [S, L, N + 1],
    nodes [S, L, N]), every output and scratch array gains an [S] axis after
    the others (shard s's own rows; shard 0's are the result) and the
    exchange buffers and the barrier counter are allocated. With a weight
    stack (B5 x B7) the outputs are [K, S, ...], each of the K * S blocks
    has its own scratch, each row its own exchange buffers and counter, and
    the K carries ("free_after" [K, N, R]) are shared by each row's shards;
    with `steps` (B4 x B7, build_scan_args) the outputs are [W, S, ...]."""
    dev = free.device
    nf, r = free.shape
    levels, n = node_domain_id.shape
    g, mg, _ = batch.group_req.shape
    ms = batch.set_member.shape[1]
    mp = batch.pod_group.shape[1]
    if r > R_MAX or mg > MG_MAX or ms > MS_MAX or levels > L_MAX:
        raise ValueError(
            f"place_wave: R={r}, MG={mg}, MS={ms}, L={levels} exceed the kernel's "
            f"limits R<={R_MAX}, MG<={MG_MAX}, MS<={MS_MAX}, L<={L_MAX}"
        )
    # The widest walk stages free, slots, count, taken, nested and spread.
    k_max = r + mg + ms + 3
    if plane_words is None:
        plane_words = PLANE_BYTES // 4
    if not k_max <= plane_words <= PLANE_BYTES // 4:
        raise ValueError(f"place_wave: plane_words {plane_words} outside [{k_max}, "
                         f"{PLANE_BYTES // 4}]")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    stacked = params_stack is not None
    K = 1
    if stacked:
        K = params_stack.shape[0] if params_stack.dim() == 2 else 0
        _check("params_stack", params_stack, f32, (K, N_WEIGHTS), dev)
        if K < 1:
            raise ValueError("place_wave: params_stack holds no weight row")
        if cand_idx is not None:
            raise ValueError("place_wave: a stacked launch solves dense; a candidate plan goes "
                             "with a weight stack as its gathered arrays (CandidatePlan "
                             "gather_free, capacity, schedulable, node_domain_id, gather_batch), "
                             "as the tuning sweep solves a pruned wave")
    _check("free", free, f32, (nf, r), dev)
    if cand_idx is None:
        _check("node_domain_id", node_domain_id, i32, (levels, nf), dev)
    else:
        _check("cand_idx", cand_idx, i32, (n,), dev)
        if cand_count is None or not 0 < cand_count <= n:
            raise ValueError(f"place_wave: cand_count {cand_count} for a candidate axis of {n}")
    _check("capacity", capacity, f32, (n, r), dev)
    _check("schedulable", schedulable, b8, (n,), dev)
    _check("node_domain_id", node_domain_id, i32, (levels, n), dev)
    _check("dom_count", domains.count, i32, (levels,), dev)
    lead = ()
    if shards is not None:
        if profile or (stacked and steps is not None):
            raise ValueError("place_wave: a sharded launch is not profiled and has no sweep")
        if not 1 <= shards <= S_MAX or n % shards:
            raise ValueError(f"place_wave: {shards} shards for a node axis of {n} (at most "
                             f"{S_MAX}, dividing it)")
        lead = (shards,)
    _check("dom_offsets", domains.offsets, i32, lead + (levels, n + 1), dev)
    _check("dom_nodes", domains.nodes, i32, lead + (levels, n), dev)
    shapes = {
        "group_req": (f32, (g, mg, r)), "group_total": (i32, (g, mg)),
        "group_required": (i32, (g, mg)), "group_valid": (b8, (g, mg)),
        "set_member": (b8, (g, ms, mg)), "set_req_level": (i32, (g, ms)),
        "set_pref_level": (i32, (g, ms)), "set_valid": (b8, (g, ms)),
        "set_pinned": (i32, (g, ms)), "pod_group": (i32, (g, mp)), "pod_rank": (i32, (g, mp)),
        "gang_valid": (b8, (g,)), "group_order": (i32, (g, mg)), "depends_on": (i32, (g,)),
        "global_index": (i32, (g,)), "depends_global": (i32, (g,)),
        "reuse_nodes": (b8, (g, n)), "group_node_ok": (b8, (g, mg, n)),
        "spread_level": (i32, (g,)), "spread_family": (i32, (g,)), "spread_avoid": (b8, (g, n)),
    }
    for name, (dtype, shape) in shapes.items():
        t = getattr(batch, name)
        if t is not None:
            _check(name, t, dtype, shape, dev)
    spread = batch.spread_level is not None
    if spread and (batch.spread_family is None or batch.spread_avoid is None):
        raise ValueError("place_wave: spread_level without spread_family/spread_avoid")
    t_len = 0
    if ok_global is not None:
        t_len = ok_global.shape[0]
        _check("ok_global", ok_global, b8, (t_len,), dev)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    w_len = 1 if steps is None else steps
    rows = (() if steps is None else (w_len,)) + ((K,) if stacked else ()) + lead
    # chain blocks, each with its own scratch
    s_len = shards if shards is not None else 1
    blocks = K * w_len * s_len if stacked else s_len
    out = {
        "assigned": empty(rows + (g, mp), i32),
        "ok": empty(rows + (g,), b8),
        "score": empty(rows + (g,), f32),
    }
    if profile:
        out["prof"] = torch.zeros((g + 1, len(SECTIONS)), dtype=torch.int64, device=dev)
    n_ent = max(2 * mg * mp, 1)
    # One copy of every per-gang scratch array for each weight variant.
    scratch = {
        # (a stacked row's shards share its carry)
        "carry": empty(((K * w_len if stacked else blocks) * n * r,), f32)
        if cand_idx is not None or stacked else None,
        "xagg": None, "xcand": None, "xcnt": None, "bar": None,
        "family_used": empty((blocks * g * n,), torch.uint8) if spread else None,
        "spread_pen": empty((blocks * n,), f32) if spread else None,
        "tables": empty((blocks * levels * n * (r + mg),), f32),
        "agg": empty((blocks * n * k_max,), f32),
        "feas2": empty((blocks * max(ms, 1) * n,), torch.uint8),
        "nword": empty((blocks * n,), i32),
        "a_slots": empty((blocks * n,), i32),
        "a_score": empty((blocks * n,), f32),
        "norm_free": empty((blocks * n,), f32),
        "entries": empty((blocks * n_ent * 3,), i32),
        "undo": empty((blocks * n_ent * r,), f32),
        "ginv": empty((w_len * max(g, 1) * INV_BYTES,), torch.uint8),
        "params_stack": params_stack,
    }
    if stacked and steps is None:
        out["free_after"] = scratch["carry"].view(K, n, r)
    if select:
        if not stacked:
            raise ValueError("place_wave: select needs a weight stack")
        out.update(
            win_assigned=empty((g, mp), i32), win_ok=empty((g,), b8), win_score=empty((g,), f32),
            winner=empty((), i32), objectives=empty((K,), f32),
        )
        scratch.update(sel_terms=empty((K * max(g, 1),), f32), sel_admitted=empty((K,), i32),
                       sel_quality=empty((K,), f32))
    x_rows = x_words = 0
    if shards is not None:
        # Exchange buffers, two halves: each shard's domain partials (at most
        # N domains of k_max columns) and its stage-2 candidates (at most its
        # N / S rows).
        # One set per weight row of a stacked launch.
        x_rows, x_words = n // shards, n * k_max
        scratch.update(xagg=empty((K * 2 * shards * x_words,), f32),
                       xcand=empty((K * 2 * shards * x_rows * 3,), i32),
                       xcnt=empty((K * 2 * shards,), i32), bar=empty((K,), i32))
    tensors = {
        "free_io": free, "cand_idx": cand_idx, "capacity": capacity,
        "schedulable": schedulable, "node_domain_id": node_domain_id,
        "dom_count": domains.count,
        "dom_offsets": domains.offsets if shards is None else domains.offsets[0],
        "dom_nodes": domains.nodes if shards is None else domains.nodes[0],
        "shard_offsets": domains.offsets if shards is not None else None,
        "shard_nodes": domains.nodes if shards is not None else None,
        "ok_global": ok_global, "prof": None, **out, **scratch,
    }
    for name in shapes:
        tensors[name] = getattr(batch, name)
    zero_launch_state(tensors)
    weights = {}
    if not stacked:
        weights = {k: float(getattr(params, k))
                   for k in ("w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread")}
    args = PlaceWaveArgs(
        N=n, R=r, L=levels, G=g, MG=mg, MS=ms, MP=mp, T=t_len, NF=nf,
        cand_count=n if cand_idx is None else int(cand_count), plane_words=plane_words, K=K,
        W=w_len, S=shards or 1, x_rows=x_rows, x_words=x_words, **weights,
    )
    for name in _POINTERS + _SHARD_POINTERS:
        t = tensors.get(name)
        setattr(args, name, None if t is None else t.data_ptr())
    return args, 4 * plane_words, out, tensors


def place_wave(free, capacity, schedulable, node_domain_id, batch: GangBatch, params,
               ok_global=None, *, domains: DomainIndex, cand_idx=None, cand_count=None,
               profile=None):
    """Solve one wave on the card with one kernel launch.

    All tensors lie on one CUDA device; `batch` is a GangBatch of tensors and
    `domains` the DomainIndex of `node_domain_id` (built once by the caller,
    so the wrapper never copies to the host). With `cand_idx`/`cand_count`
    the node-axis inputs and the batch lie on a candidate plan's axis and
    `free` on the fleet's (see build_args). Returns (assigned i32 [G, MP], ok
    bool [G], score f32 [G], free_after, ok_global) where `assigned` holds
    fleet ordinals and free_after is `free` and ok_global is `ok_global`,
    both updated in place.

    `profile`, a dict, launches the profiled instantiation instead and
    receives "prof": i64 [G + 1, len(SECTIONS)] clock64 cycles per section,
    row gi gang gi, row G the wave's head and tail (see csrc/place_wave.cu)."""
    if not free.is_cuda:
        raise ValueError("place_wave: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_args(
        free, capacity, schedulable, node_domain_id, batch, params, ok_global, domains,
        cand_idx, cand_count, profile is not None,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_launch", args, stream, smem, int(profile is not None))
    if rc != 0:
        raise RuntimeError(f"place_wave: kernel launch failed with CUDA error {rc}")
    place_wave.launches += 1
    place_wave.variant_launches["pruned" if cand_idx is not None else "dense"] += 1
    if profile is not None:
        profile["prof"] = out["prof"]
    return out["assigned"], out["ok"], out["score"], free, ok_global


def place_wave_stacked(free, capacity, schedulable, node_domain_id, batch: GangBatch,
                       params_stack, ok_global=None, *, domains: DomainIndex, select: bool):
    """Solve one wave under K weight rows with one launch on the card (B5).

    `params_stack` is f32 [K, 5] on the card (SolverParams' fields in
    order, parallel.portfolio.params_population). Every row solves from
    `free` and judges its cross-wave dependencies against the one
    `ok_global`; row k equals place_wave under row k's weights bit for bit.

    `select=False` (core.stacked_solve_batch) returns (assigned i32
    [K, G, MP], ok bool [K, G], score f32 [K, G], free_after f32 [K, N, R])
    and leaves `free` and `ok_global` as they were.

    `select=True` (the portfolio solve) returns (assigned [G, MP], ok [G],
    score [G], free, ok_global, winner i32 [], objectives f32 [K]): the
    winner's rows, with `free` and `ok_global` updated in place by the
    winner alone, as place_wave updates them. Stacked launches solve the
    fleet dense (build_args refuses a candidate plan with a weight stack)."""
    if not free.is_cuda:
        raise ValueError("place_wave_stacked: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_args(
        free, capacity, schedulable, node_domain_id, batch, None, ok_global, domains,
        params_stack=params_stack, select=select,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_stacked_launch", args, stream, smem, int(select))
    if rc != 0:
        raise RuntimeError(f"place_wave_stacked: kernel launch failed with CUDA error {rc}")
    place_wave.launches += 1
    place_wave.variant_launches["portfolio" if select else "stacked"] += 1
    if select:
        return (out["win_assigned"], out["win_ok"], out["win_score"], free, ok_global,
                out["winner"], out["objectives"])
    return out["assigned"], out["ok"], out["score"], out["free_after"]


def place_wave_sharded(free, capacity, schedulable, node_domain_id, batch: GangBatch, params,
                       ok_global=None, *, shards: int, domains: DomainIndex, cand_idx=None,
                       cand_count=None):
    """Solve one wave on `shards` virtual shards of the card with one
    cooperative launch (B7). Arguments as place_wave, but `domains` is the
    sharded DomainIndex (domain_index_sharded of `node_domain_id` and
    `shards`) and the node axis (the candidate axis when pruned) must
    divide into the shards. Returns what place_wave returns: `free` and
    `ok_global` updated in place, `assigned` in fleet ordinals."""
    if not free.is_cuda:
        raise ValueError("place_wave_sharded: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_args(
        free, capacity, schedulable, node_domain_id, batch, params, ok_global, domains,
        cand_idx, cand_count, shards=shards,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_sharded_launch", args, stream, smem, None)
    _raise_launch("place_wave_sharded", rc, shards)
    place_wave.launches += 1
    place_wave.variant_launches["sharded_pruned" if cand_idx is not None else "sharded"] += 1
    return out["assigned"][0], out["ok"][0], out["score"][0], free, ok_global


# cudaErrorCooperativeLaunchTooLarge: the chain blocks of a launch over
# shards cannot all be resident at once.
_NOT_RESIDENT = 82


def _raise_launch(name: str, rc: int, blocks: int, shape: str = "") -> None:
    """Raise for a failed launch (rc != 0); a launch over shards whose
    `blocks` cannot all be resident names its shape."""
    if rc == _NOT_RESIDENT:
        raise RuntimeError(f"{name}: {shape or f'{blocks} shards'} = {blocks} chain blocks "
                           f"cannot all be resident on the card at once (one per SM)")
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def place_wave_stacked_sharded(free, capacity, schedulable, node_domain_id, batch: GangBatch,
                               params_stack, ok_global=None, *, shards: int,
                               domains: DomainIndex, select: bool):
    """Solve one wave under K weight rows over `shards` virtual shards of
    the card with one cooperative launch (B5 x B7: K * S chain blocks, row
    k's shards meeting at their own barrier), then with `select` the select
    kernel. Arguments as place_wave_stacked, but `domains` is the sharded
    DomainIndex (domain_index_sharded of `node_domain_id` and `shards`).
    Returns what place_wave_stacked returns; row k equals place_wave_sharded
    under row k's weights bit for bit."""
    if not free.is_cuda:
        raise ValueError("place_wave_stacked_sharded: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_args(
        free, capacity, schedulable, node_domain_id, batch, None, ok_global, domains,
        params_stack=params_stack, select=select, shards=shards,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_stacked_sharded_launch", args, stream, smem, int(select))
    k = params_stack.shape[0]
    _raise_launch("place_wave_stacked_sharded", rc, k * shards,
                  f"{k} weight rows x {shards} shards")
    place_wave.launches += 1
    place_wave.variant_launches["portfolio_sharded" if select else "stacked_sharded"] += 1
    if select:
        return (out["win_assigned"], out["win_ok"], out["win_score"], free, ok_global,
                out["winner"], out["objectives"])
    return out["assigned"][:, 0], out["ok"][:, 0], out["score"][:, 0], out["free_after"]


def build_scan_args(free, capacity, schedulable, node_domain_id, stacked_batch: GangBatch,
                    params, ok_global, domains: DomainIndex, cand_idx=None, retain=False,
                    plane_words=None, shards=None):
    """The scan launch's args: W waves of one shape, every field of
    `stacked_batch` with a leading [W] axis. Dense, the node tensors and
    `domains` are the fleet's, shared by every step; with `cand_idx` (i32
    [W, CP], each step's padded gather map) `capacity` [W, CP, R],
    `schedulable` [W, CP], `node_domain_id` [W, L, CP] and `domains` (each
    field [W, ...]) are per step. Step 0 is checked as one wave (build_args)
    and every stacked array for its step axis; each step reuses the one
    chain's scratch. Returns (args, smem_bytes, outputs, keepalive) with
    outputs "assigned" [W, G, MP], "ok" [W, G], "score" [W, G], and with
    `retain` "free_in" [W, NF, R] and "okg_in" [W, T] (None without
    ok_global).

    `shards` (S, B4 x B7) splits each step's node axis into S row spans:
    `domains` is then the fleet's domain_index_sharded, or pruned each
    step's (domain_index_stacked_sharded: offsets [W, S, L, CP + 1]), and
    the verdict outputs are [W, S, ...] (shard 0's rows are the result)."""
    w_len = stacked_batch.gang_valid.shape[0] if stacked_batch.gang_valid.dim() == 2 else 0
    if w_len < 1:
        raise ValueError("place_wave_scan: stacked_batch needs a leading step axis of at least 1")
    pruned = cand_idx is not None
    stacked = {f: t for f, t in stacked_batch._asdict().items() if t is not None}
    if pruned:
        stacked.update(cand_idx=cand_idx, capacity=capacity, schedulable=schedulable,
                       node_domain_id=node_domain_id, dom_count=domains.count,
                       dom_offsets=domains.offsets, dom_nodes=domains.nodes)
        if shards is not None:
            stacked.update(shard_offsets=domains.offsets, shard_nodes=domains.nodes)
    for name, t in stacked.items():
        if t.dim() < 1 or t.shape[0] != w_len:
            raise ValueError(f"place_wave_scan: {name} has shape {tuple(t.shape)}, expected a "
                             f"leading step axis of {w_len}")
        if not t.is_contiguous():
            raise ValueError(f"place_wave_scan: {name} is not contiguous")
    step0 = GangBatch(*(None if t is None else t[0] for t in stacked_batch))
    node0 = (capacity, schedulable, node_domain_id, domains)
    if pruned:
        node0 = (capacity[0], schedulable[0], node_domain_id[0],
                 DomainIndex(*(t[0] for t in domains)))
    args, smem, out, keep = build_args(
        free, *node0[:3], step0, params, ok_global, node0[3],
        cand_idx[0] if pruned else None, node0[0].shape[0] if pruned else None,
        plane_words=plane_words, steps=w_len, shards=shards,
    )
    dev, (nf, r) = free.device, free.shape
    out.update(
        free_in=torch.empty((w_len, nf, r), dtype=torch.float32, device=dev) if retain else None,
        okg_in=(torch.empty((w_len, ok_global.shape[0]), dtype=torch.bool, device=dev)
                if retain and ok_global is not None else None),
    )
    keep.update(out, stacked=stacked)
    if pruned:
        keep["cand_counts"] = (cand_idx < nf).sum(dim=1, dtype=torch.int32)
    for name in ("free_in", "okg_in", "cand_counts"):
        t = keep.get(name)
        setattr(args, name, None if t is None else t.data_ptr())
    for name in STEPPED:
        t = keep[name] if name in ("assigned", "ok", "score", "ginv", "free_in", "okg_in") \
            else stacked.get(name)
        setattr(args, f"st_{name}", 0 if t is None else t.numel() // w_len)
    return args, smem, out, keep


def place_wave_scan(free, capacity, schedulable, node_domain_id, stacked_batch: GangBatch,
                    params, ok_global=None, *, domains: DomainIndex, cand_idx=None,
                    retain=False):
    """Solve W waves of one shape with one launch on the card (B4): step w
    solves wave w of `stacked_batch` from the carry step w - 1 left, and
    equals a single place_wave launch on that entering carry bit for bit.
    Arguments as build_scan_args. Returns (assigned i32 [W, G, MP] in fleet
    ordinals, ok bool [W, G], score f32 [W, G], free_in [W, NF, R] or None,
    okg_in [W, T] or None, free, ok_global), `free` and `ok_global` updated
    in place to the last step's carry."""
    if not free.is_cuda:
        raise ValueError("place_wave_scan: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_scan_args(
        free, capacity, schedulable, node_domain_id, stacked_batch, params, ok_global, domains,
        cand_idx, retain,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_scan_launch", args, stream, smem, None)
    if rc != 0:
        raise RuntimeError(f"place_wave_scan: kernel launch failed with CUDA error {rc}")
    place_wave.launches += 1
    place_wave.variant_launches["scan_pruned" if cand_idx is not None else "scan"] += 1
    return (out["assigned"], out["ok"], out["score"], out["free_in"], out["okg_in"], free,
            ok_global)


def place_wave_scan_sharded(free, capacity, schedulable, node_domain_id,
                            stacked_batch: GangBatch, params, ok_global=None, *, shards: int,
                            domains: DomainIndex, cand_idx=None, retain=False):
    """Solve W waves of one shape over `shards` virtual shards of the card
    with one cooperative launch (B4 x B7): S chain blocks walk the steps
    together, step w equal to a place_wave_sharded launch on its entering
    carry bit for bit. Arguments as place_wave_scan, with `domains` sharded
    (build_scan_args). Returns what place_wave_scan returns."""
    if not free.is_cuda:
        raise ValueError("place_wave_scan_sharded: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_scan_args(
        free, capacity, schedulable, node_domain_id, stacked_batch, params, ok_global, domains,
        cand_idx, retain, shards=shards,
    )
    stream = torch.cuda.current_stream(free.device).cuda_stream
    rc = _call_launch(lib, "place_wave_scan_sharded_launch", args, stream, smem, None)
    _raise_launch("place_wave_scan_sharded", rc, shards)
    place_wave.launches += 1
    place_wave.variant_launches["scan_sharded_pruned" if cand_idx is not None
                                else "scan_sharded"] += 1
    return (out["assigned"][:, 0], out["ok"][:, 0], out["score"][:, 0], out["free_in"],
            out["okg_in"], free, ok_global)


def build_sweep_args(free_stack, capacity, schedulable, node_domain_id,
                     stacked_batch: GangBatch, params_stack, domains: DomainIndex,
                     plane_words=None):
    """The sweep launch's args (B6): `free_stack` f32 [W, N, R], each step's
    recorded entering free; the fleet's `capacity`, `schedulable`,
    `node_domain_id` and `domains`, shared by every step; `stacked_batch`
    with a leading [W] axis on every field; `params_stack` f32 [K, 5]. Step
    0 is checked as one stacked wave (build_args) and every stacked array
    for its step axis. No ok_global: each wave's cross-wave dependencies
    were resolved when it was journaled. Returns (args, smem_bytes, outputs,
    keepalive) with outputs "assigned" [W, K, G, MP], "ok" [W, K, G] and
    "score" [W, K, G]."""
    w_len = free_stack.shape[0] if free_stack.dim() == 3 else 0
    if w_len < 1:
        raise ValueError("place_wave_stacked_scan: free_stack needs a leading step axis of at "
                         "least 1")
    stacked = {f: t for f, t in stacked_batch._asdict().items() if t is not None}
    stacked["free_stack"] = free_stack
    for name, t in stacked.items():
        if t.dim() < 1 or t.shape[0] != w_len:
            raise ValueError(f"place_wave_stacked_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected a leading step axis of {w_len}")
        if not t.is_contiguous():
            raise ValueError(f"place_wave_stacked_scan: {name} is not contiguous")
    step0 = GangBatch(*(None if t is None else t[0] for t in stacked_batch))
    args, smem, out, keep = build_args(
        free_stack[0], capacity, schedulable, node_domain_id, step0, None, None, domains,
        plane_words=plane_words, params_stack=params_stack, steps=w_len,
    )
    keep.update(stacked=stacked, free_in=free_stack)
    args.free_in = free_stack.data_ptr()
    # The outputs are rows b = w * K + k of W * K, offset by the block (as
    # the stacked launch's rows are), not step-strided.
    for name in STEPPED:
        t = keep[name] if name in ("ginv", "free_in") else stacked.get(name)
        setattr(args, f"st_{name}", 0 if t is None else t.numel() // w_len)
    return args, smem, out, keep


def place_wave_stacked_scan(free_stack, capacity, schedulable, node_domain_id,
                            stacked_batch: GangBatch, params_stack, *, domains: DomainIndex):
    """Solve W journaled waves of one shape under K weight rows with one
    launch on the card (B6): W * K chain blocks, block (w, k) solving wave w
    of `stacked_batch` from `free_stack[w]` under row k of `params_stack`,
    each equal to a single place_wave launch of that wave under that row
    bit for bit. Arguments as build_sweep_args. Returns (assigned i32
    [W, K, G, MP], ok bool [W, K, G], score f32 [W, K, G]); no input is
    changed."""
    if not free_stack.is_cuda:
        raise ValueError("place_wave_stacked_scan: the kernel runs on a CUDA device only")
    lib = _library()
    args, smem, out, _keep = build_sweep_args(free_stack, capacity, schedulable, node_domain_id,
                                              stacked_batch, params_stack, domains)
    stream = torch.cuda.current_stream(free_stack.device).cuda_stream
    rc = _call_launch(lib, "place_wave_sweep_launch", args, stream, smem, None)
    if rc != 0:
        raise RuntimeError(f"place_wave_stacked_scan: kernel launch failed with CUDA error {rc}")
    place_wave.launches += 1
    place_wave.variant_launches["stacked_scan"] += 1
    return out["assigned"], out["ok"], out["score"]


# The kernel's dtype of every input a prepared launch owns (build_args'
# checks), by name: the node tensors, the DomainIndex, the gather map, the
# carry, the weight stack and every GangBatch plane.
INPUT_DTYPES = {
    "free": torch.float32, "free_stack": torch.float32, "cand_idx": torch.int32,
    "capacity": torch.float32, "schedulable": torch.bool, "node_domain_id": torch.int32,
    "dom_count": torch.int32, "dom_offsets": torch.int32, "dom_nodes": torch.int32,
    "group_req": torch.float32, "group_total": torch.int32, "group_required": torch.int32,
    "group_valid": torch.bool, "set_member": torch.bool, "set_req_level": torch.int32,
    "set_pref_level": torch.int32, "set_valid": torch.bool, "set_pinned": torch.int32,
    "pod_group": torch.int32, "pod_rank": torch.int32, "gang_valid": torch.bool,
    "group_order": torch.int32, "depends_on": torch.int32, "global_index": torch.int32,
    "depends_global": torch.int32, "reuse_nodes": torch.bool, "group_node_ok": torch.bool,
    "spread_level": torch.int32, "spread_family": torch.int32, "spread_avoid": torch.bool,
    "ok_global": torch.bool, "params_stack": torch.float32,
}
# Inputs that stay the same tensor from call to call (node state, domain
# index, gather maps, weights): a replay copies them only when the caller
# hands over another tensor, or the same one changed in place.
STATIC_INPUTS = frozenset((
    "capacity", "schedulable", "node_domain_id", "dom_count", "dom_offsets", "dom_nodes",
    "cand_idx", "params_stack",
))
WEIGHTS = ("w_tight", "w_pref", "w_reuse", "w_reserve", "w_spread")
# The buffers of build_args that a launch reads before it writes them, and
# so expects zeroed: the verdicts (a gang gated on a gang its wave has not
# reached reads ok 0) and the spread family rows (only the scan kinds zero
# theirs themselves, at each step) and the sharded launch's barrier counter
# (its blocks count their arrivals from 0). build_args zeroes them for a
# direct launch; a prepared launch zeroes them at the head of every replay.
LAUNCH_ZEROED = ("ok", "family_used", "bar")


def zero_launch_state(tensors: dict) -> None:
    """Zero `tensors`' LAUNCH_ZEROED buffers (build_args' keepalive) on the
    current stream."""
    for name in LAUNCH_ZEROED:
        t = tensors.get(name)
        if t is not None:
            t.zero_()


# The launch of each kind of prepared launch: (library function, its last
# argument, or None when it takes none).
_KIND_LAUNCH = {
    "single": ("place_wave_launch", 0),
    "stacked": ("place_wave_stacked_launch", 0),
    "scan": ("place_wave_scan_launch", None),
    "sweep": ("place_wave_sweep_launch", None),
    "sharded": ("place_wave_sharded_launch", None),
    "scan_sharded": ("place_wave_scan_sharded_launch", None),
}


def _call_launch(lib, name, args, stream, smem, extra) -> int:
    """One of the library's launch functions on `stream`; `extra` is its
    last int argument (profile or select), None for those without one.
    Returns the CUDA error code (0: launched or captured)."""
    fn = getattr(lib, name)
    tail = [] if extra is None else [ctypes.c_int]
    fn.argtypes = [ctypes.POINTER(PlaceWaveArgs), ctypes.c_void_p, ctypes.c_int, *tail]
    fn.restype = ctypes.c_int
    return fn(ctypes.byref(args), stream, smem, *([] if extra is None else [extra]))


def _copy_in(dst: torch.Tensor, src) -> None:
    """`src` (a tensor anywhere, or a numpy array) into `dst` on the current
    stream, without blocking: host data goes through pinned memory (a copy
    from pageable memory would wait for the launches already queued)."""
    if not torch.is_tensor(src):
        src = torch.from_numpy(np.ascontiguousarray(src))
    if src.device != dst.device:
        src = src.contiguous()
        if not src.is_pinned():
            src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class PreparedLaunch:
    """One shape key's launch on the card, prepared once and replayed
    (solver/warm.py `ExecutableCache` holds one per key).

    Every tensor the kernel reads or writes belongs to the entry: its inputs
    (`inputs`, zeros of the key's shapes and the kernel's dtypes: node
    tensors, DomainIndex, gather map, carry, ok_global, weight stack, batch
    planes), its outputs and its scratch, all allocated once. The launch
    sequence — the prologue and the chain kernel, as the direct wrappers
    above launch them — is captured once as a CUDA graph, which bakes in
    every pointer. A call copies the caller's inputs into the entry on the
    current stream, replays the graph and leaves the results in `out` (and
    the carry in `inputs["free"]`, `inputs["ok_global"]`): the caller copies
    them out before the entry's next replay.

    Each graph zeroes the LAUNCH_ZEROED buffers before its launch, so a
    replay starts from the state a direct launch's fresh buffers give it.
    The kinds are "single", "stacked", "scan", "sweep" and the launches over
    shards "sharded" and "scan_sharded". The
    single-variant kinds ("single", "scan", "sharded", "scan_sharded") read
    their weights from the argument struct, by value, so each distinct
    weight row gets its own
    graph over the same buffers (`graphs`). A pruned single launch is
    captured with its whole candidate axis as `cand_count`: the count only
    bounds the remap of `assigned`, and no gang is ever assigned a pad row
    (pad rows are unschedulable). A pruned scan's per-step counts are read
    from the card and recomputed from the gather maps at each call.

    A caller holds `use()` across run() and its copies out: it serialises
    the entry's users, across threads and streams.

    Capturing needs the card; a failed capture or replay raises."""

    def __init__(self, kind: str, shapes: dict, device, *, retain: bool = False,
                 shards: int | None = None):
        if kind not in _KIND_LAUNCH:
            raise ValueError(f"PreparedLaunch: unknown kind {kind!r}")
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("PreparedLaunch: a prepared launch lives on a CUDA device")
        self.kind, self.device, self.retain = kind, device, retain
        self.inputs = {name: torch.zeros(shape, dtype=INPUT_DTYPES[name], device=device)
                       for name, shape in shapes.items()}
        t = self.inputs
        pruned = "cand_idx" in t
        batch = GangBatch(*(t.get(f) for f in GangBatch._fields))
        domains = DomainIndex(t["dom_count"], t["dom_offsets"], t["dom_nodes"])
        zero = dict.fromkeys(WEIGHTS, 0.0)
        params = type("Weights", (), zero)
        if kind == "sharded":
            self.variant = "sharded_pruned" if pruned else "sharded"
            n = t["capacity"].shape[0]
            built = build_args(t["free"], t["capacity"], t["schedulable"], t["node_domain_id"],
                               batch, params, t.get("ok_global"), domains, t.get("cand_idx"),
                               n if pruned else None, shards=shards)
        elif kind == "single":
            self.variant = "pruned" if pruned else "dense"
            n = t["capacity"].shape[0]
            built = build_args(t["free"], t["capacity"], t["schedulable"], t["node_domain_id"],
                               batch, params, t.get("ok_global"), domains, t.get("cand_idx"),
                               n if pruned else None)
        elif kind == "stacked":
            self.variant = "stacked"
            built = build_args(t["free"], t["capacity"], t["schedulable"], t["node_domain_id"],
                               batch, None, None, domains, params_stack=t["params_stack"])
        elif kind in ("scan", "scan_sharded"):
            self.variant = kind + ("_pruned" if pruned else "")
            built = build_scan_args(t["free"], t["capacity"], t["schedulable"],
                                    t["node_domain_id"], batch, params, t.get("ok_global"),
                                    domains, t.get("cand_idx"), retain, shards=shards)
        else:
            self.variant = "stacked_scan"
            built = build_sweep_args(t["free_stack"], t["capacity"], t["schedulable"],
                                     t["node_domain_id"], batch, t["params_stack"], domains)
        self.args, self.smem, self.out, self._keep = built
        if kind == "sharded":  # row 0 of the shards' rows is the result
            self.out = {k: v[0] for k, v in self.out.items()}
        elif kind == "scan_sharded":  # each step's shard 0
            self.out = {k: v[:, 0] if k in ("assigned", "ok", "score") else v
                        for k, v in self.out.items()}
        self.graphs: dict = {}  # weight row (None: weights on the card) -> (graph, args)
        self.capture_s: list[float] = []  # wall seconds of each capture
        # Static input -> (weak reference to its source tensor, its version).
        self._last: dict = {}
        self._lock = threading.Lock()
        self._released = torch.cuda.Event()  # recorded when the last user let go

    @contextlib.contextmanager
    def use(self):
        """Hold the entry: the current stream waits for the previous user's
        work on the entry (its replay and copies out, on whatever stream),
        and the next user waits for this one's."""
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._released)
            try:
                yield self
            finally:
                self._released.record(stream)

    def weights_of(self, params):
        """The graph key of a call's weights: the row for the kinds that
        read them from the argument struct, else None."""
        if self.kind in ("stacked", "sweep"):
            return None
        return tuple(float(getattr(params, k)) for k in WEIGHTS)

    def capture(self, weights) -> None:
        """Capture the launch under `weights` (a weight row, or None) on a
        side stream; the graph's kernels do not run."""
        args = PlaceWaveArgs.from_buffer_copy(self.args)
        if weights is not None:
            for k, w in zip(WEIGHTS, weights):
                setattr(args, k, w)
        lib = _library()
        name, extra = _KIND_LAUNCH[self.kind]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                zero_launch_state(self._keep)
                rc = _call_launch(lib, name, args, stream.cuda_stream, self.smem, extra)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if rc != 0:
            raise RuntimeError(f"PreparedLaunch: capture of {name} failed with CUDA error {rc}")
        self.graphs[weights] = (graph, args)
        self.capture_s.append(time.perf_counter() - t0)

    def run(self, sources: dict, params=None) -> dict:
        """Copy `sources` (name -> tensor or numpy array, one per input) into
        the entry, replay the graph of these weights (captured now if new)
        and return the entry's outputs. Counts one launch of the variant."""
        for name, buf in self.inputs.items():
            src = sources[name]
            if name in STATIC_INPUTS and torch.is_tensor(src):
                last = self._last.get(name)
                if last is not None and last[0]() is src and last[1] == src._version:
                    continue
                self._last[name] = (weakref.ref(src), src._version)
            _copy_in(buf, src)
        if self.kind in ("scan", "scan_sharded") and "cand_idx" in self.inputs:
            nf = self.inputs["free"].shape[0]
            torch.sum(self.inputs["cand_idx"] < nf, dim=1, dtype=torch.int32,
                      out=self._keep["cand_counts"])
        weights = self.weights_of(params)
        if weights not in self.graphs:
            self.capture(weights)
        self.graphs[weights][0].replay()
        place_wave.launches += 1
        place_wave.variant_launches[self.variant] += 1
        return self.out


def _library():
    from grove_tpu_torch.kernels.build import load

    lib = load("place_wave")
    lib.place_wave_args_size.argtypes = []
    lib.place_wave_args_size.restype = ctypes.c_int
    if lib.place_wave_args_size() != ctypes.sizeof(PlaceWaveArgs):
        raise RuntimeError("place_wave: PlaceWaveArgs differs between Python and CUDA")
    return lib


VARIANTS = ("dense", "pruned", "stacked", "portfolio", "scan", "scan_pruned", "stacked_scan",
            "sharded", "sharded_pruned", "stacked_sharded", "portfolio_sharded", "scan_sharded",
            "scan_sharded_pruned")


def reset_launches() -> None:
    """Set every launch count of place_wave, place_wave_stacked,
    place_wave_scan, place_wave_stacked_scan, place_wave_sharded,
    place_wave_stacked_sharded and place_wave_scan_sharded to 0."""
    place_wave.launches = 0
    place_wave.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_launches()
