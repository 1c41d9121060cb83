"""The warm path: what makes the SECOND drain or solve of a shape cheap
(grove_tpu/solver/warm.py counterpart).

1. **Launch cache** (`ExecutableCache`, the JAX package's name for its AOT
   executable cache): one prepared launch per shape key. On the card an
   entry (kernels/place_wave.py `PreparedLaunch`) owns its inputs, outputs
   and scratch, allocated once, and its launch captured once as a CUDA
   graph; every later call of the key copies its inputs in, replays the
   graph and copies the results out. The key holds `_exec_key`'s parts:
   donation, the stacked flag, the scan tag, `coarse_dmax`, the layout's key
   (parallel/mesh.py SolveLayout: a sharded entry is a B7 launch, a sharded
   scan's a B4 x B7 launch, each distinct from the unsharded entry of the
   same shapes), which optional planes are
   present and every input's shape (dtypes are fixed per input), plus the
   device. `lowerings` counts the entries created (captures on the card).
   Each shape descriptor's use is recorded to a history file in the JAX
   package's schema, so a fresh process can prepare the top-K recorded
   shapes before traffic arrives (`prewarm_from_history`,
   `start_prewarm_thread`). On the CPU an entry holds the plain version
   and no graph; keying, counters, history and prewarm work the same.

2. **Device-resident node state** (`SnapshotDeviceCache`): node tensors are
   uploaded once per content digest and reused across solves and drains;
   the DomainIndex the kernel sums domains over is cached under its
   node_domain_id's digest, since it is derived from it.

3. **Encode-row reuse** (`EncodeRowCache`, `gang_row_digest`): a gang whose
   spec digest and snapshot epoch recur reuses its encoded rows instead of
   walking its spec again (solver/encode.py).

Donation: the port's launches update the free/ok_global carry in place, so
`donate` here means that a drain keeps no entering carries (no pruning, no
recorder). It is part of the key, as in the JAX package, and defaults on
for the card and off for the CPU (`donation_default`).
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from grove_tpu_torch.solver.core import (
    ScanSolveResult,
    SolveResult,
    SolverParams,
    StackedScanResult,
    _check_layout,
    _sharded,
    resolve_device,
    tensor_on,
)
from grove_tpu_torch.solver.encode import GangBatch
from grove_tpu_torch.solver.pruning import PruneStats
from grove_tpu_torch.utils.fsio import atomic_write_json


def donation_default(device=None) -> bool:
    """Donate the wave carry by default on the card only (the JAX package:
    on accelerators, off on the CPU). `device` None asks whether a card is
    present."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# ---- shape keys ----------------------------------------------------------------

# Canonical order of a launch's inputs in a key (dtypes are fixed per name:
# kernels/place_wave.py INPUT_DTYPES).
_INPUT_ORDER = (
    "free", "free_stack", "cand_idx", "capacity", "schedulable", "node_domain_id",
    "dom_count", "dom_offsets", "dom_nodes", *GangBatch._fields, "ok_global", "params_stack",
)


def _shape(x) -> tuple:
    return tuple(int(d) for d in x.shape)


def _domain_shapes(ndid_shape: tuple, shards: int | None = None) -> dict:
    """The DomainIndex's shapes for a node_domain_id of `ndid_shape` ([L, N],
    or [W, L, N] for a pruned chunk's stacked plans); with `shards` the
    sharded launch's (a CSR per shard: offsets [S, L, N + 1], nodes
    [S, L, N], after a stacked chunk's [W])."""
    *lead, n = ndid_shape
    lead = tuple(lead)
    per = (shards,) if shards else ()
    return {"dom_count": lead, "dom_offsets": lead[:-1] + per + (lead[-1], n + 1),
            "dom_nodes": lead[:-1] + per + (lead[-1], n)}


def _input_shapes(*, free, capacity, schedulable, node_domain_id, batch, ok_global=None,
                  cand_idx=None, params_stack=None, free_key="free", shards=None) -> dict:
    shapes = {
        free_key: _shape(free),
        "capacity": _shape(capacity),
        "schedulable": _shape(schedulable),
        "node_domain_id": _shape(node_domain_id),
        **_domain_shapes(_shape(node_domain_id), shards),
    }
    if cand_idx is not None:
        shapes["cand_idx"] = _shape(cand_idx)
    for name, x in zip(GangBatch._fields, batch):
        if x is not None:
            shapes[name] = _shape(x)
    if ok_global is not None:
        shapes["ok_global"] = _shape(ok_global)
    if params_stack is not None:
        shapes["params_stack"] = _shape(params_stack)
    return shapes


def _exec_key(shapes: dict, coarse_dmax, donate: bool, layout=None, stacked: bool = False,
              scan: Optional[tuple] = None, *, device) -> tuple:
    """Full launch identity (warm.py `_exec_key`): donation, the stacked
    flag, the scan tag (("dense"|"pruned", retain), or ("stacked",) for the
    sweep), coarse_dmax, the layout, the device, and every input's shape in
    a fixed order (which inputs are present covers the optional planes and
    ok_global)."""
    return (
        bool(donate),
        bool(stacked),
        scan,
        coarse_dmax,
        None if layout is None else layout.key(),
        _device_key(device),
        tuple((name, shapes[name]) for name in _INPUT_ORDER if name in shapes),
    )


def _device_key(device) -> str:
    """"cuda" and "cuda:0" name one card when it is the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _exec_desc(shapes: dict, coarse_dmax, donate: bool,
               scan: Optional[tuple] = None, layout=None) -> Optional[dict]:
    """JSON-able shape-bucket descriptor (the prewarm history record, warm.py
    `_exec_desc` / `_scan_desc`'s fields): a single-variant solve's, whose
    `n` is the solve's node axis (a pruned solve's candidate pad), or a
    DENSE scan's, its per-wave fields plus the scan length and the retain
    flag. Pruned scans are not recorded: their gather maps are
    backlog-specific. A sharded solve's `mesh` is [portfolio, node], the
    JAX package's record."""
    if scan is not None and scan[0] != "dense":
        return None
    w = 1 if scan is not None else 0  # the batch planes' leading wave axis
    n, r = shapes["capacity"]
    desc = {
        "mesh": None if layout is None else [layout.portfolio_devices, layout.node_devices],
        "n": int(n),
        "r": int(r),
        "levels": int(shapes["node_domain_id"][0]),
        "g": int(shapes["gang_valid"][w]),
        "mg": int(shapes["group_req"][w + 1]),
        "ms": int(shapes["set_member"][w + 1]),
        "mp": int(shapes["pod_group"][w + 1]),
        "t": int(shapes["ok_global"][0]) if "ok_global" in shapes else None,
        "reuse": "reuse_nodes" in shapes,
        "node_ok": "group_node_ok" in shapes,
        "spread": "spread_level" in shapes,
        "coarse_dmax": coarse_dmax,
        "donate": bool(donate),
        "portfolio": 1,
    }
    if scan is not None:
        desc.update(scan=int(shapes["gang_valid"][0]), retain=bool(scan[1]))
    return desc


def _layout_from_desc(desc: dict):
    """Rebuild a recorded mesh layout for prewarm (warm.py
    `_layout_from_desc`), or None for an unsharded descriptor. Raises when
    this process cannot host the recorded mesh; the prewarm loop then skips
    the entry."""
    mesh_shape = desc.get("mesh")
    if not mesh_shape:
        return None
    from grove_tpu_torch.parallel.mesh import mesh_devices, solve_layout_for

    p, k = int(mesh_shape[0]), int(mesh_shape[1])
    if p != 1:
        raise ValueError(f"unsupported prewarm mesh shape {mesh_shape}")
    devices = mesh_devices()
    if len(devices) < k:
        raise ValueError(f"recorded mesh needs {k} devices, have {len(devices)}")
    layout = solve_layout_for(desc["n"], devices[:k], count_fallback=False)
    if layout is None or layout.node_devices != k:
        raise ValueError(f"cannot rebuild {k}-device layout for n={desc['n']}")
    return layout


def _shapes_from_desc(desc: dict, shards: int | None = None) -> dict:
    """Descriptor -> the input shapes of its launch (warm.py
    `_args_from_desc` / `_scan_args_from_desc`): a scan's batch planes gain
    the leading [scan] axis."""
    n, r, lv = desc["n"], desc["r"], desc["levels"]
    g, mg, ms, mp = desc["g"], desc["mg"], desc["ms"], desc["mp"]
    lead = (int(desc["scan"]),) if desc.get("scan") else ()
    batch = {
        "group_req": (g, mg, r), "group_total": (g, mg), "group_required": (g, mg),
        "group_valid": (g, mg), "set_member": (g, ms, mg), "set_req_level": (g, ms),
        "set_pref_level": (g, ms), "set_valid": (g, ms), "set_pinned": (g, ms),
        "pod_group": (g, mp), "pod_rank": (g, mp), "gang_valid": (g,), "group_order": (g, mg),
        "depends_on": (g,), "global_index": (g,), "depends_global": (g,),
    }
    if desc["reuse"]:
        batch["reuse_nodes"] = (g, n)
    if desc["node_ok"]:
        batch["group_node_ok"] = (g, mg, n)
    if desc["spread"]:
        batch.update(spread_level=(g,), spread_family=(g,), spread_avoid=(g, n))
    shapes = {"free": (n, r), "capacity": (n, r), "schedulable": (n,), "node_domain_id": (lv, n),
              **_domain_shapes((lv, n), shards), **{k: lead + v for k, v in batch.items()}}
    if desc["t"] is not None:
        shapes["ok_global"] = (int(desc["t"]),)
    return shapes


def _stacked_shapes(shapes: dict, scan_len: int, *, pruned: bool) -> dict:
    """One wave's input shapes -> a scan chunk's of `scan_len` waves (warm.py
    `_scan_avals` / `_scan_pruned_avals`): the batch planes gain a leading
    [scan_len] axis, and so do a pruned chunk's per-plan node tensors, gather
    maps and DomainIndex."""
    stepped = set(GangBatch._fields)
    if pruned:
        stepped |= {"cand_idx", "capacity", "schedulable", "node_domain_id", "dom_count",
                    "dom_offsets", "dom_nodes"}
    return {k: ((int(scan_len),) + v if k in stepped else v) for k, v in shapes.items()}


def _sharding(layout, dev) -> tuple:
    """(layout, its node shards) for a launch on `dev`, or (None, None)
    when `layout` splits no node axis; a layout of another device raises."""
    _check_layout(layout, dev)
    return (layout, layout.node_devices) if _sharded(layout) else (None, None)


class _PlainEntry:
    """A CPU entry: the plain PyTorch version, no graph."""

    def __init__(self, kind: str):
        self.kind = kind
        self.capture_s: list[float] = []


def _sources(*, free, capacity, schedulable, node_domain_id, batch, domains, ok_global=None,
             cand_idx=None, params_stack=None, free_key="free") -> dict:
    out = {free_key: free, "capacity": capacity, "schedulable": schedulable,
           "node_domain_id": node_domain_id, "dom_count": domains.count,
           "dom_offsets": domains.offsets, "dom_nodes": domains.nodes}
    if cand_idx is not None:
        out["cand_idx"] = cand_idx
    for name, x in zip(GangBatch._fields, batch):
        if x is not None:
            out[name] = x
    if ok_global is not None:
        out["ok_global"] = ok_global
    if params_stack is not None:
        out["params_stack"] = params_stack
    return out


def _params_stack_np(params_stack) -> np.ndarray:
    if torch.is_tensor(params_stack):
        return params_stack.detach().to("cpu", torch.float32).numpy()
    return np.array(params_stack, dtype=np.float32)  # a writable copy (populations are not)


class ExecutableCache:
    """In-process launch cache for the batched solver (warm.py
    `ExecutableCache`): one prepared launch per shape key, with hit, miss
    and lowering counters, a shape history recorded to `history_path`, and
    prewarm of the top-K recorded shapes.

    Every solve method returns new tensors: the caller's arrays are never
    changed (on the card the entry's carry is copied out after the replay).
    A failed capture or replay raises; nothing falls back to a direct
    launch or to the plain version. The cache keeps the `max_entries` most
    recently used entries (the JAX package's keeps every one): an evicted
    key prepares again, and counts a lowering again. Threads may share the
    cache: each entry serves one call at a time (PreparedLaunch.use)."""

    def __init__(self, history_path: str = "", max_entries: int = 64) -> None:
        # Least recently used first; past `max_entries` the oldest entry
        # goes (and with it, on the card, its buffers and graphs).
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()
        # Captures are serialised process-wide within one cache.
        self._capture_lock = threading.Lock()
        self.history_path = history_path
        self.hits = 0
        self.misses = 0
        self.lowerings = 0  # entries prepared (on the card: captures)
        self.prewarmed = 0
        self.inflight_waits = 0  # lookups that waited on an in-flight preparation
        self._inflight: dict[tuple, threading.Event] = {}
        self._history: dict[str, dict] = {}

    # ---- solving -----------------------------------------------------------

    def solve(self, free0, capacity, schedulable, node_domain_id, batch: GangBatch,
              params: SolverParams | None = None, ok_global=None, *, coarse_dmax=None,
              donate: bool = False, device=None, domains=None, cand_idx=None,
              cand_count: int | None = None, layout=None) -> SolveResult:
        """One wave through the cache (core.solve_batch's semantics). With
        `cand_idx` (i32 [CP]: each candidate's fleet row, pad rows past the
        fleet) and `cand_count` the node tensors and the batch lie on a
        candidate plan's axis and `free0`/`ok_global` are the fleet's carry;
        `assigned` comes back in fleet ordinals. `domains` (the card) is the
        DomainIndex of `node_domain_id`, built here when not given. `layout`
        (a parallel.mesh.SolveLayout) solves node-sharded (core.sharded_solve:
        B7 on the card, under its own key); `domains` is then the sharded
        DomainIndex (kernels.place_wave.domain_index_sharded)."""
        dev = resolve_device(device)
        params = params or SolverParams()
        shards = None if layout is None else layout.node_devices
        if layout is not None and layout.device.type != dev.type:
            raise ValueError(f"solve: a layout on {layout.device} for a solve on {dev}")
        shapes = _input_shapes(free=free0, capacity=capacity, schedulable=schedulable,
                               node_domain_id=node_domain_id, batch=batch,
                               ok_global=ok_global, cand_idx=cand_idx, shards=shards)
        entry = self._get_or_prepare(
            _exec_key(shapes, coarse_dmax, donate, layout, device=dev),
            "single" if layout is None else "sharded", shapes, dev, params,
            _exec_desc(shapes, coarse_dmax, donate, layout=layout), shards=shards,
        )
        if dev.type != "cuda":
            if layout is not None:
                from grove_tpu_torch.solver.core import sharded_solve_fn

                return sharded_solve_fn(layout, donate)(
                    free0, capacity, schedulable, node_domain_id, batch, params, ok_global,
                    device=dev, cand_idx=cand_idx, cand_count=cand_count)
            return self._plain_single(free0, capacity, schedulable, node_domain_id, batch,
                                      params, ok_global, cand_idx, cand_count)
        if layout is not None:
            if domains is None:
                from grove_tpu_torch.kernels.place_wave import domain_index_sharded

                domains = domain_index_sharded(node_domain_id, shards, dev)
        else:
            domains = self._domains(domains, node_domain_id, dev)
        with entry.use():
            out = entry.run(_sources(free=free0, capacity=capacity, schedulable=schedulable,
                                     node_domain_id=node_domain_id, batch=batch,
                                     domains=domains, ok_global=ok_global, cand_idx=cand_idx),
                            params)
            okg = entry.inputs.get("ok_global")
            return SolveResult(out["assigned"].clone(), out["ok"].clone(), out["score"].clone(),
                               entry.inputs["free"].clone(), None if okg is None else okg.clone())

    def ensure_compiled(self, free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                        params: SolverParams | None = None, ok_global=None, *,
                        coarse_dmax=None, donate: bool = False, device=None,
                        cand_idx=None, layout=None) -> bool:
        """Prepare (never run) the launch `solve` would use for these
        arguments; True when this paid a preparation, False on a hit."""
        dev = resolve_device(device)
        before = self.lowerings
        shards = None if layout is None else layout.node_devices
        shapes = _input_shapes(free=free0, capacity=capacity, schedulable=schedulable,
                               node_domain_id=node_domain_id, batch=batch,
                               ok_global=ok_global, cand_idx=cand_idx, shards=shards)
        self._get_or_prepare(_exec_key(shapes, coarse_dmax, donate, layout, device=dev),
                             "single" if layout is None else "sharded",
                             shapes, dev, params or SolverParams(),
                             _exec_desc(shapes, coarse_dmax, donate, layout=layout),
                             shards=shards)
        return self.lowerings != before

    def solve_stacked(self, free0, capacity, schedulable, node_domain_id, batch: GangBatch,
                      params_stack, *, coarse_dmax=None, device=None,
                      domains=None) -> SolveResult:
        """core.stacked_solve_batch through the cache: one wave under K
        weight rows (`params_stack` f32 [K, 5]), every result with a leading
        [K] axis. Keyed on (wave shape, K); no history (warm.py)."""
        from grove_tpu_torch.solver.core import stacked_solve_batch

        dev = resolve_device(device)
        pstack = _params_stack_np(params_stack)
        shapes = _input_shapes(free=free0, capacity=capacity, schedulable=schedulable,
                               node_domain_id=node_domain_id, batch=batch,
                               params_stack=pstack)
        entry = self._get_or_prepare(
            _exec_key(shapes, coarse_dmax, False, stacked=True, device=dev), "stacked", shapes,
            dev, None, None,
        )
        if dev.type != "cuda":
            return stacked_solve_batch(free0, capacity, schedulable, node_domain_id, batch,
                                       pstack, device=dev)
        domains = self._domains(domains, node_domain_id, dev)
        with entry.use():
            out = entry.run(_sources(free=free0, capacity=capacity, schedulable=schedulable,
                                     node_domain_id=node_domain_id, batch=batch,
                                     domains=domains, params_stack=pstack))
            return SolveResult(out["assigned"].clone(), out["ok"].clone(), out["score"].clone(),
                               out["free_after"].clone())

    def solve_scan_stacked(self, free_stack, capacity, schedulable, node_domain_id,
                           stacked_batch: GangBatch, params_stack, *, coarse_dmax=None,
                           device=None, domains=None) -> StackedScanResult:
        """core.stacked_scan_solve through the cache (the sweep's B6): W
        journaled waves of one shape under K weight rows, keyed on (W, wave
        shape, K) with the stacked flag and the ("stacked",) scan tag."""
        from grove_tpu_torch.solver.core import stacked_scan_solve

        dev = resolve_device(device)
        pstack = _params_stack_np(params_stack)
        shapes = _input_shapes(free=free_stack, capacity=capacity, schedulable=schedulable,
                               node_domain_id=node_domain_id, batch=stacked_batch,
                               params_stack=pstack, free_key="free_stack")
        entry = self._get_or_prepare(
            _exec_key(shapes, coarse_dmax, False, stacked=True, scan=("stacked",), device=dev),
            "sweep", shapes, dev, None, None,
        )
        if dev.type != "cuda":
            return stacked_scan_solve(free_stack, capacity, schedulable, node_domain_id,
                                      stacked_batch, pstack, device=dev)
        domains = self._domains(domains, node_domain_id, dev)
        with entry.use():
            out = entry.run(_sources(free=free_stack, capacity=capacity,
                                     schedulable=schedulable, node_domain_id=node_domain_id,
                                     batch=stacked_batch, domains=domains, params_stack=pstack,
                                     free_key="free_stack"))
            return StackedScanResult(out["assigned"].clone(), out["ok"].clone(),
                                     out["score"].clone())

    def solve_scan(self, free0, capacity, schedulable, node_domain_id,
                   stacked_batch: GangBatch, params: SolverParams | None = None,
                   ok_global=None, *, coarse_dmax=None, retain: bool = False,
                   donate: bool = False, device=None, domains=None,
                   layout=None) -> ScanSolveResult:
        """core.scan_solve through the cache: a chunk of same-shape waves as
        one launch, the carry threaded on the card. Keyed on the scan length
        (the batch planes' leading axis) with the ("dense", retain) tag.
        `layout` solves it over the layout's shards (B4 x B7) under its own
        key; `domains` is then the sharded DomainIndex."""
        dev = resolve_device(device)
        layout, shards = _sharding(layout, dev)
        params = params or SolverParams()
        shapes = _input_shapes(free=free0, capacity=capacity, schedulable=schedulable,
                               node_domain_id=node_domain_id, batch=stacked_batch,
                               ok_global=ok_global, shards=shards)
        scan = ("dense", bool(retain))
        entry = self._get_or_prepare(
            _exec_key(shapes, coarse_dmax, donate, layout, scan=scan, device=dev),
            "scan_sharded" if shards else "scan", shapes, dev, params,
            _exec_desc(shapes, coarse_dmax, donate, scan, layout), retain=retain, shards=shards,
        )
        if dev.type != "cuda":
            from grove_tpu_torch.solver.core import scan_solve_fn

            return scan_solve_fn(layout, retain, donate)(
                free0, capacity, schedulable, node_domain_id, stacked_batch, params, ok_global,
                device=dev)
        domains = self._domains(domains, node_domain_id, dev, shards)
        with entry.use():
            out = entry.run(_sources(free=free0, capacity=capacity, schedulable=schedulable,
                                     node_domain_id=node_domain_id, batch=stacked_batch,
                                     domains=domains, ok_global=ok_global), params)
            return self._scan_result(entry, out)

    def solve_scan_pruned(self, free0, cand_idx, capacity_p, schedulable_p, node_domain_id_p,
                          stacked_batch: GangBatch, params: SolverParams | None = None,
                          ok_global=None, *, coarse_dmax=None, retain: bool = False,
                          donate: bool = False, device=None,
                          domains=None, layout=None) -> ScanSolveResult:
        """core.scan_pruned_solve through the cache: per step the fleet carry
        gathered onto that wave's candidate axis, solved and scattered back.
        Keyed with the ("pruned", retain) tag; never recorded to history.
        `layout` splits each step's candidate axis over its shards (B4 x B7,
        `domains` then kernels.place_wave.domain_index_stacked_sharded's)."""
        dev = resolve_device(device)
        layout, shards = _sharding(layout, dev)
        params = params or SolverParams()
        shapes = _input_shapes(free=free0, capacity=capacity_p, schedulable=schedulable_p,
                               node_domain_id=node_domain_id_p, batch=stacked_batch,
                               ok_global=ok_global, cand_idx=cand_idx, shards=shards)
        scan = ("pruned", bool(retain))
        entry = self._get_or_prepare(
            _exec_key(shapes, coarse_dmax, donate, layout, scan=scan, device=dev),
            "scan_sharded" if shards else "scan", shapes, dev, params, None, retain=retain,
            shards=shards,
        )
        if dev.type != "cuda":
            from grove_tpu_torch.solver.core import scan_pruned_solve_fn

            return scan_pruned_solve_fn(layout, retain, donate)(
                free0, cand_idx, capacity_p, schedulable_p, node_domain_id_p, stacked_batch,
                params, ok_global, device=dev)
        if domains is None:
            from grove_tpu_torch.kernels import place_wave as pw

            domains = (pw.domain_index_stacked_sharded(node_domain_id_p, shards, dev) if shards
                       else pw.domain_index_stacked(node_domain_id_p, dev))
        with entry.use():
            out = entry.run(_sources(free=free0, capacity=capacity_p,
                                     schedulable=schedulable_p, node_domain_id=node_domain_id_p,
                                     batch=stacked_batch, domains=domains, ok_global=ok_global,
                                     cand_idx=cand_idx), params)
            return self._scan_result(entry, out)

    def ensure_compiled_scan(self, free0, capacity, schedulable, node_domain_id,
                             batch: GangBatch, params: SolverParams | None, ok_global,
                             scan_len: int, *, coarse_dmax=None, retain: bool = False,
                             donate: bool = False, device=None, cand_idx=None,
                             layout=None) -> bool:
        """Prepare (never run) the scan launch of `scan_len` waves shaped
        like this one wave (warm.py `ensure_compiled_scan` over the wave's
        avals stacked to [scan_len]). With `cand_idx` the wave's node tensors
        and batch lie on one plan's candidate axis and `free0` is the fleet
        carry; `layout` prepares the scan over its shards. True when this
        paid a preparation."""
        dev = resolve_device(device)
        layout, shards = _sharding(layout, dev)
        before = self.lowerings
        pruned = cand_idx is not None
        shapes = _stacked_shapes(
            _input_shapes(free=free0, capacity=capacity, schedulable=schedulable,
                          node_domain_id=node_domain_id, batch=batch, ok_global=ok_global,
                          cand_idx=cand_idx, shards=shards),
            scan_len, pruned=pruned,
        )
        scan = ("pruned" if pruned else "dense", bool(retain))
        self._get_or_prepare(_exec_key(shapes, coarse_dmax, donate, layout, scan=scan,
                                       device=dev),
                             "scan_sharded" if shards else "scan", shapes, dev,
                             params or SolverParams(),
                             _exec_desc(shapes, coarse_dmax, donate, scan, layout),
                             retain=retain, shards=shards)
        return self.lowerings != before

    # ---- entries -----------------------------------------------------------

    @staticmethod
    def _domains(domains, node_domain_id, dev, shards=None):
        if domains is not None:
            return domains
        from grove_tpu_torch.kernels import place_wave as pw

        if shards:
            return pw.domain_index_sharded(node_domain_id, shards, dev)
        return pw.domain_index(node_domain_id, dev)

    @staticmethod
    def _scan_result(entry, out) -> ScanSolveResult:
        okg = entry.inputs.get("ok_global")

        def cp(t):
            return None if t is None else t.clone()

        return ScanSolveResult(out["assigned"].clone(), out["ok"].clone(), out["score"].clone(),
                               cp(out.get("free_in")), cp(out.get("okg_in")),
                               entry.inputs["free"].clone(), cp(okg))

    @staticmethod
    def _plain_single(free0, capacity, schedulable, node_domain_id, batch, params, ok_global,
                      cand_idx, cand_count) -> SolveResult:
        from grove_tpu_torch.solver.core import batch_to, solve_batch
        from grove_tpu_torch.solver.reference import solve_pruned_ref

        if cand_idx is None:
            return solve_batch(free0, capacity, schedulable, node_domain_id, batch, params,
                               ok_global, device="cpu")
        cpu = torch.device("cpu")
        cand = tensor_on(cand_idx, torch.int32, cpu)
        out = solve_pruned_ref(
            tensor_on(free0, torch.float32, cpu), tensor_on(capacity, torch.float32, cpu),
            tensor_on(schedulable, torch.bool, cpu), tensor_on(node_domain_id, torch.int32, cpu),
            batch_to(batch, cpu), params, tensor_on(ok_global, torch.bool, cpu), cand,
            int(cand_count if cand_count is not None else cand.shape[0]),
        )
        return SolveResult(*out)

    def _prepare(self, kind, shapes, dev, params, retain, shards=None):
        """A new entry: on the card a PreparedLaunch captured under `params`
        (under its weight stack when None); on the CPU the plain version."""
        if dev.type != "cuda":
            return _PlainEntry(kind)
        from grove_tpu_torch.kernels.place_wave import PreparedLaunch

        with self._capture_lock:
            entry = PreparedLaunch(kind, shapes, dev, retain=retain, shards=shards)
            entry.capture(entry.weights_of(params))
        return entry

    def _get_or_prepare(self, key, kind, shapes, dev, params, desc, *, retain: bool = False,
                        shards: int | None = None):
        while True:
            with self._lock:
                entry = self._entries.get(key)
                pending = None
                if entry is not None:
                    self._entries.move_to_end(key)
                else:
                    pending = self._inflight.get(key)
                    if pending is None:
                        # Claim the preparation: others wait instead.
                        self._inflight[key] = threading.Event()
            if entry is not None:
                self.hits += 1
                self._record(desc, new=False)
                return entry
            if pending is None:
                break
            # Another thread (prewarm, or a concurrent serving path) is
            # preparing this exact shape right now: wait for it.
            self.inflight_waits += 1
            pending.wait()
        try:
            self.lowerings += 1
            entry = self._prepare(kind, shapes, dev, params, retain, shards)
            self._insert(key, entry)
            self.misses += 1
        finally:
            with self._lock:
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()
        self._record(desc, new=True)
        return entry

    def _insert(self, key, entry) -> None:
        with self._lock:
            self._entries.setdefault(key, entry)
            self._entries.move_to_end(key)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def capture_seconds(self) -> list[float]:
        """Wall seconds of every capture of every entry (empty on the CPU)."""
        with self._lock:
            entries = list(self._entries.values())
        return [s for e in entries for s in e.capture_s]

    # ---- shape history + prewarm -------------------------------------------

    def _record(self, desc: Optional[dict], *, new: bool) -> None:
        if not self.history_path or desc is None:
            return
        hkey = json.dumps(desc, sort_keys=True)
        with self._lock:
            entry = self._history.setdefault(hkey, {"count": 0, "desc": desc})
            entry["count"] += 1
        if new:
            self._save_history()

    def _save_history(self) -> None:
        try:
            with self._lock:
                merged = dict(self._history)
            # Merge with what other processes wrote; counts take the max so
            # concurrent writers can only under-count.
            for hkey, entry in self._load_history_file().items():
                if hkey in merged:
                    merged[hkey]["count"] = max(merged[hkey]["count"], entry.get("count", 0))
                else:
                    merged[hkey] = entry
            atomic_write_json(self.history_path, {"version": 1, "shapes": merged})
        except OSError:
            pass  # the history is an optimisation; never fatal

    def _load_history_file(self) -> dict:
        try:
            with open(self.history_path) as f:
                doc = json.load(f)
            shapes = doc.get("shapes", {})
            return shapes if isinstance(shapes, dict) else {}
        except (OSError, ValueError):
            return {}

    def prewarm_from_history(self, top_k: int, stop=None, *, device=None) -> int:
        """Prepare the top-K most-used recorded shapes (by count) on `device`
        (None: the card) under the default weights. Returns the number of
        NEW entries. `stop` (a threading.Event) aborts between
        preparations. A descriptor the port cannot host (a portfolio, a mesh
        this process has too few devices for) is skipped."""
        dev = resolve_device(device)
        shapes_doc = self._load_history_file()
        with self._lock:
            for hkey, entry in shapes_doc.items():
                if hkey not in self._history:
                    self._history[hkey] = entry
        ranked = sorted(shapes_doc.values(), key=lambda e: -e.get("count", 0))
        prepared = 0
        for entry in ranked[: max(0, top_k)]:
            if stop is not None and stop.is_set():
                break
            desc = entry.get("desc")
            if not isinstance(desc, dict) or desc.get("portfolio", 1) != 1:
                continue
            try:
                layout = _layout_from_desc(desc)
                if layout is not None and layout.device.type != dev.type:
                    continue  # a layout of another device
                shards = None if layout is None else layout.node_devices
                shapes = _shapes_from_desc(desc, shards)
                scan = ("dense", bool(desc.get("retain", False))) if desc.get("scan") else None
                key = _exec_key(shapes, desc.get("coarse_dmax"), desc.get("donate", False),
                                layout, scan=scan, device=dev)
            except (KeyError, TypeError, ValueError, NotImplementedError):
                continue  # a malformed or unhostable descriptor must not stop prewarm
            with self._lock:
                if key in self._entries:
                    continue
                pending = self._inflight.get(key)
                if pending is None:
                    self._inflight[key] = threading.Event()
            if pending is not None:
                self.inflight_waits += 1
                pending.wait()
                continue
            try:
                self.lowerings += 1
                kind = {(False, False): "single", (False, True): "sharded",
                        (True, False): "scan", (True, True): "scan_sharded"}[
                            (bool(scan), layout is not None)]
                made = self._prepare(kind, shapes, dev, SolverParams(), bool(scan and scan[1]),
                                     shards)
                self._insert(key, made)
            finally:
                with self._lock:
                    ev = self._inflight.pop(key, None)
                if ev is not None:
                    ev.set()
            prepared += 1
            self.prewarmed += 1
        return prepared

    def start_prewarm_thread(self, top_k: int, stop=None, *,
                             device=None) -> Optional[threading.Thread]:
        """Background prewarm of the top-K recorded shapes; None when there
        is no history to prewarm from. Non-daemon: the owner joins it (the
        `stop` event bounds the wait to one preparation)."""
        if top_k <= 0 or not self.history_path:
            return None
        if not self._load_history_file():
            return None
        t = threading.Thread(
            target=self.prewarm_from_history,
            args=(top_k, stop),
            kwargs={"device": device},
            daemon=False,
            name="grove-solver-prewarm",
        )
        t.start()
        return t

    def stats(self) -> dict:
        return {
            "execHits": self.hits,
            "execMisses": self.misses,
            "lowerings": self.lowerings,
            "prewarmed": self.prewarmed,
            "inflightWaits": self.inflight_waits,
            "executables": len(self._entries),
        }


class SnapshotDeviceCache:
    """Device-resident cluster state across solves and drains (warm.py
    `SnapshotDeviceCache`): node tensors are uploaded once per content
    digest and reused; LRU of `max_entries`. The DomainIndex of a
    node_domain_id is cached beside them under that array's digest (an LRU
    of its own, so the array counters stay the JAX package's). Cached
    tensors are never written: the launch cache copies them into its
    entries."""

    def __init__(self, max_entries: int = 16) -> None:
        self._cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._domains: OrderedDict[tuple, Any] = OrderedDict()
        self._max = max_entries
        self.hits = 0
        self.misses = 0
        self.domain_hits = 0
        self.domain_misses = 0

    @staticmethod
    def _digest(arr: np.ndarray) -> bytes:
        return hashlib.blake2b(np.ascontiguousarray(arr).tobytes(), digest_size=16).digest()

    def device_array(self, arr, dtype=None, device=None) -> torch.Tensor:
        """`arr` (numpy) as a tensor on `device` (None: the card), memoized
        by (shape, dtype, device, content digest); a tensor passes through
        (moved to `device` if it lies elsewhere)."""
        from grove_tpu_torch.solver.core import to_device

        dev = resolve_device(device)
        if torch.is_tensor(arr):
            return arr.to(device=dev, dtype=dtype or arr.dtype)
        arr = np.asarray(arr)
        key = (arr.shape, str(arr.dtype), str(dtype), _device_key(dev), self._digest(arr))
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return cached
        host = arr if dtype is None else arr.astype(_NP_DTYPES[dtype], copy=False)
        dev_t = to_device(host, dev)
        if dev.type == "cpu":
            dev_t = dev_t.clone()  # never alias the caller's array
        self._cache[key] = dev_t
        while len(self._cache) > self._max:
            self._cache.popitem(last=False)
        self.misses += 1
        return dev_t

    def snapshot_arrays(self, snapshot, free=None, schedulable=None, device=None):
        """(free, capacity, schedulable, node_domain_id) on `device`, cached;
        `free`/`schedulable` overrides pass through when already tensors."""
        cap = self.device_array(snapshot.capacity, torch.float32, device)
        ndid = self.device_array(snapshot.node_domain_id, torch.int32, device)
        sched = self.device_array(
            snapshot.schedulable if schedulable is None else schedulable, torch.bool, device
        )
        f = self.device_array(snapshot.free if free is None else free, torch.float32, device)
        return f, cap, sched, ndid

    def domain_index(self, node_domain_id, device=None, shards: int | None = None):
        """The DomainIndex of `node_domain_id` ([L, N], or a chunk's stacked
        [W, L, N]) on `device`, built and uploaded once per content digest;
        with `shards` the sharded launch's (domain_index_sharded, or
        domain_index_stacked_sharded for a chunk)."""
        from grove_tpu_torch.kernels.place_wave import (
            domain_index,
            domain_index_sharded,
            domain_index_stacked,
            domain_index_stacked_sharded,
        )

        dev = resolve_device(device)
        ndid = np.asarray(node_domain_id.cpu() if torch.is_tensor(node_domain_id)
                          else node_domain_id, dtype=np.int32)
        key = (ndid.shape, _device_key(dev), self._digest(ndid), shards or None)
        cached = self._domains.get(key)
        if cached is not None:
            self._domains.move_to_end(key)
            self.domain_hits += 1
            return cached
        if shards:
            built = (domain_index_stacked_sharded if ndid.ndim == 3 else domain_index_sharded)(
                ndid, shards, dev)
        else:
            built = (domain_index_stacked if ndid.ndim == 3 else domain_index)(ndid, dev)
        self._domains[key] = built
        while len(self._domains) > self._max:
            self._domains.popitem(last=False)
        self.domain_misses += 1
        return built

    def stats(self) -> dict:
        return {
            "deviceHits": self.hits,
            "deviceMisses": self.misses,
            "deviceEntries": len(self._cache),
            "deviceDomainHits": self.domain_hits,
            "deviceDomainMisses": self.domain_misses,
        }


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


class EncodeRowCache:
    """Per-gang encode-row reuse, dirty-tracked by spec hash (warm.py
    `EncodeRowCache`).

    Key = (caller row key, resource axis, bound-node signature); the caller's
    row key folds in the snapshot's encode_epoch(): selector and toleration
    rows read node labels and taints, and pack-set pins read the domain
    map. Entries carry their bucket dims (mg, ms, mp); a lookup under other
    dims is a miss (solver/encode.py demotes it). The constraint walk is
    memoized separately, by the row key alone."""

    def __init__(self, max_entries: int = 8192) -> None:
        self._rows: OrderedDict[tuple, dict] = OrderedDict()
        self._max = max_entries
        self.hits = 0
        self.misses = 0
        self._sets: OrderedDict[tuple, tuple] = OrderedDict()
        self.sets_hits = 0
        self.sets_misses = 0

    def peek(self, key: tuple) -> Optional[dict]:
        entry = self._rows.get(key)
        if entry is not None:
            self._rows.move_to_end(key)
        return entry

    def put(self, key: tuple, entry: dict) -> None:
        self._rows[key] = entry
        self._rows.move_to_end(key)
        while len(self._rows) > self._max:
            self._rows.popitem(last=False)

    def peek_sets(self, key: tuple) -> Optional[tuple]:
        entry = self._sets.get(key)
        if entry is not None:
            self._sets.move_to_end(key)
            self.sets_hits += 1
        else:
            self.sets_misses += 1
        return entry

    def put_sets(self, key: tuple, entry: tuple) -> None:
        self._sets[key] = entry
        self._sets.move_to_end(key)
        while len(self._sets) > self._max:
            self._sets.popitem(last=False)

    def stats(self) -> dict:
        return {
            "encodeHits": self.hits,
            "encodeMisses": self.misses,
            "encodeEntries": len(self._rows),
            "encodeSetsHits": self.sets_hits,
            "encodeSetsMisses": self.sets_misses,
        }


# Per-pod signature memo (gang_row_digest): keyed by (id(pod), id(pod.spec))
# with a weakref guard, so a dead pod's recycled id never serves a stale
# signature and a replaced spec object misses. Specs are replaced wholesale,
# never edited in place.
_POD_SIG_MEMO: dict[tuple, tuple] = {}
_POD_SIG_MAX = 131072


def _pod_sig(pod, memo: bool = True) -> tuple:
    import weakref

    spec = pod.spec
    if memo:
        key = (id(pod), id(spec))
        hit = _POD_SIG_MEMO.get(key)
        if hit is not None and hit[0]() is pod:
            return hit[1]
    sig = (
        tuple(sorted(spec.total_requests().items())),
        tuple(sorted((spec.node_selector or {}).items())),
        tuple(tuple(sorted(t.items())) for t in (spec.tolerations or [])),
    )
    if memo:
        try:
            if len(_POD_SIG_MEMO) >= _POD_SIG_MAX:
                _POD_SIG_MEMO.clear()
            _POD_SIG_MEMO[key] = (weakref.ref(pod), sig)
        except TypeError:
            pass  # un-weakref-able stand-ins: just recompute
    return sig


# Whole-gang digest memo: keyed by id(gang), guarded by a weakref on the gang
# and a cheap fingerprint of every scalar the digest reads, with identity
# stand-ins for its O(pods) parts (the pod_references list and its ends, the
# first pod and its spec per group). Any scalar or structural spec change
# flips the guard; replacing an interior element of the same references
# list in place would not (expansion rebuilds those lists wholesale).
_GANG_DIGEST_MEMO: dict[int, tuple] = {}
_GANG_DIGEST_MAX = 65536


def _pc_levels(obj):
    tc = getattr(obj, "topology_constraint", None)
    p = getattr(tc, "pack_constraint", None) if tc else None
    return (p.required, p.preferred) if p else None


def _digest_guard(gang, pods_by_name: dict) -> tuple:
    """Cheap (O(groups)) fingerprint of everything gang_row_digest reads,
    with identity stand-ins for its O(pods) parts."""
    groups = []
    for grp in gang.spec.pod_groups:
        refs = grp.pod_references
        pod = pods_by_name.get(refs[0].name) if refs else None
        groups.append(
            (
                grp.name,
                grp.min_replicas,
                _pc_levels(grp),
                len(refs),
                id(refs),
                id(refs[0]) if refs else None,
                id(refs[-1]) if refs else None,
                None if pod is None else (id(pod), id(pod.spec)),
            )
        )
    return (
        gang.name,
        gang.base_podgang_name,
        gang.spec.spread_key,
        _pc_levels(gang.spec),
        tuple(
            (gc.name, tuple(gc.pod_group_names), _pc_levels(gc))
            for gc in gang.spec.topology_constraint_group_configs
        ),
        tuple(groups),
    )


def gang_row_digest(gang, pods_by_name: dict) -> tuple:
    """Hashable digest of everything the encode reads from ONE gang
    (warm.py `gang_row_digest`): identity, constraints at all three levels,
    per-group references and floors, and the first pod's requests, selector
    and tolerations (pods of a group share one template). A spec hash, not
    object identity: serving loops rebuild sub-gang objects every pass."""
    import weakref

    mkey = id(gang)
    guard = _digest_guard(gang, pods_by_name)
    hit = _GANG_DIGEST_MEMO.get(mkey)
    if hit is not None and hit[0]() is gang and hit[1] == guard:
        return hit[2]

    def pod_sig(name: str):
        pod = pods_by_name.get(name)
        if pod is None:
            return None
        return _pod_sig(pod)

    digest = (
        gang.name,
        gang.base_podgang_name,
        gang.spec.spread_key,
        _pc_levels(gang.spec),
        tuple(
            (gc.name, tuple(gc.pod_group_names), _pc_levels(gc))
            for gc in gang.spec.topology_constraint_group_configs
        ),
        tuple(
            (
                grp.name,
                grp.min_replicas,
                _pc_levels(grp),
                tuple(r.name for r in grp.pod_references),
                pod_sig(grp.pod_references[0].name) if grp.pod_references else None,
            )
            for grp in gang.spec.pod_groups
        ),
    )
    try:
        if len(_GANG_DIGEST_MEMO) >= _GANG_DIGEST_MAX:
            _GANG_DIGEST_MEMO.clear()
        _GANG_DIGEST_MEMO[mkey] = (weakref.ref(gang), guard, digest)
    except TypeError:
        pass  # un-weakref-able stand-ins: just recompute
    return digest


@dataclass
class WarmPath:
    """One bundle of the warm-path caches (warm.py `WarmPath`), owned per
    serving path or shared across drains (`default_warm_path`)."""

    executables: ExecutableCache = field(default_factory=ExecutableCache)
    encode_rows: EncodeRowCache = field(default_factory=EncodeRowCache)
    device: SnapshotDeviceCache = field(default_factory=SnapshotDeviceCache)
    # Candidate-pruning counters (solver/pruning.py).
    prune: PruneStats = field(default_factory=PruneStats)
    # The last drain through this warm path (drain_backlog reports at exit).
    last_drain: dict = field(default_factory=dict)
    # The last streaming run (StreamStats.to_doc), and its per-gang
    # time-to-bind samples, bounded: a long stream loses its oldest samples.
    last_stream: dict = field(default_factory=dict)
    stream_bind_samples: object = None  # collections.deque, made on first use
    # Cumulative round-trip ledger across every drain and stream through this path.
    drain_dispatches_total: int = 0
    drain_device_roundtrips_total: int = 0

    def record_drain(self, stats) -> None:
        """Fold one DrainStats into the observable surface."""
        self.drain_dispatches_total += stats.dispatches
        self.drain_device_roundtrips_total += stats.device_roundtrips
        doc = {
            "drainWaves": stats.waves,
            "drainGangs": stats.gangs,
            "drainAdmitted": stats.admitted,
            "drainHarvest": stats.harvest,
            "drainTotalS": round(stats.total_s, 4),
        }
        doc.update(stats.host_stages())
        pct = stats.latency_percentiles((50.0, 99.0))
        if pct is not None:
            doc["waveP50S"] = round(pct[50.0], 4)
            doc["waveP99S"] = round(pct[99.0], 4)
        self.last_drain = doc

    def record_stream(self, doc: dict, bind_latencies=()) -> None:
        """Fold one StreamStats doc into the observable surface and queue its
        time-to-bind samples."""
        from collections import deque

        self.last_stream = dict(doc)
        if self.stream_bind_samples is None:
            self.stream_bind_samples = deque(maxlen=65536)
        self.stream_bind_samples.extend(float(x) for x in bind_latencies)

    def stats(self) -> dict:
        out = {}
        try:
            out.update(self.executables.stats())
            out.update(self.encode_rows.stats())
            out.update(self.device.stats())
            out.update(self.prune.stats())
            # The port solves on one card: no mesh falls back.
            out["shardFallbacks"] = 0
            out.update(self.last_drain)
            out["dispatchesTotal"] = self.drain_dispatches_total
            out["deviceRoundtripsTotal"] = self.drain_device_roundtrips_total
        except Exception:  # noqa: BLE001 — stats must never fail a scrape
            pass
        return out


_DEFAULT_WARM_PATH: Optional[WarmPath] = None
_DEFAULT_LOCK = threading.Lock()


def default_warm_path() -> WarmPath:
    """Process-wide shared WarmPath: repeated drains in one process share
    prepared launches and encode rows."""
    global _DEFAULT_WARM_PATH
    with _DEFAULT_LOCK:
        if _DEFAULT_WARM_PATH is None:
            _DEFAULT_WARM_PATH = WarmPath()
        return _DEFAULT_WARM_PATH
